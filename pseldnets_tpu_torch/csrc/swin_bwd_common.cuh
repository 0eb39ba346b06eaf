// Device and host code of the Swin block backward shared by K3
// (swin_block_bwd.cu) and K5 (swin_block_adapt.cu): LayerNorm rows forward
// and backward, column sums, the ordered reduction of partials, the
// weight-grad GEMM A^T B and the window attention backward. Everything is in
// an anonymous namespace, as in swin_common.cuh.

#pragma once

#include "swin_common.cuh"

#include <algorithm>

namespace {


constexpr int ROW_THREADS = 256;  // 8 rows (warps) per block in the row kernels

// LayerNorm forward over destination rows r: t = window ? window_token(r) : r;
// v = x[t] (+ m0[image] * add[t]) in float32; xhat_out[t] = (v - mean) / sigma,
// rstd_out[t] = 1 / sigma, h_out[r] = bf16(xhat * w + b)
__global__ void __launch_bounds__(ROW_THREADS) ln_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ add, const float* __restrict__ masks,
    const float* __restrict__ w, const float* __restrict__ b, bf16* __restrict__ h_out,
    float* __restrict__ xhat_out, float* __restrict__ rstd_out, int rows, RowMap g, int window) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int C = g.C;
  const int t = window ? window_token(g, r) : r;
  const float m0 = add != nullptr ? masks[2 * (t / g.L)] : 0.f;
  auto load = [&](int k) -> float {
    float v = bf2f(x[(long)t * C + k]);
    if (add != nullptr) v += m0 * bf2f(add[(long)t * C + k]);
    return v;
  };
  float s = 0.f;
  for (int k = lane; k < C; k += 32) s += load(k);
  const float mu = warp_sum(s) / C;
  float var = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float d = load(k) - mu;
    var += d * d;
  }
  const float rs = rsqrtf(warp_sum(var) / C + LN_EPS);
  for (int k = lane; k < C; k += 32) {
    const float xh = (load(k) - mu) * rs;
    xhat_out[(long)t * C + k] = xh;
    h_out[(long)r * C + k] = f2bf(xh * w[k] + b[k]);
  }
  if (lane == 0) rstd_out[t] = rs;
}

// LayerNorm backward plus the residual, over window-order rows r with token
// t = window_token(r):
//   dh = dh_src[dh_window ? r : t] (rounded to bf16 first when round_dh)
//   out = res[t] + rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)), dxh = dh * w
// res is res_bf16 or res_f32; out goes to out_f32[t] and/or out_bf16[t]; with
// scaled_out, bf16(m0[image] * out) goes to scaled_out[r]; with dh_copy, the
// dh used goes to dh_copy[t]
struct LnBwdParams {
  const float* dh_src;
  int dh_window, round_dh;
  float* dh_copy;
  const float* xhat;
  const float* rstd;
  const float* w;
  const bf16* res_bf16;
  const float* res_f32;
  float* out_f32;
  bf16* out_bf16;
  bf16* scaled_out;
  const float* masks;
  int rows;
  RowMap g;
};

__global__ void __launch_bounds__(ROW_THREADS) ln_bwd_rows_kernel(LnBwdParams p) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= p.rows) return;
  const int C = p.g.C;
  const int t = window_token(p.g, r);
  const long src = (long)(p.dh_window ? r : t) * C, tok = (long)t * C;
  auto dh_at = [&](int k) -> float {
    const float v = p.dh_src[src + k];
    return p.round_dh ? bf2f(f2bf(v)) : v;
  };
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float dxh = dh_at(k) * p.w[k];
    s1 += dxh;
    s2 += dxh * p.xhat[tok + k];
  }
  const float mean1 = warp_sum(s1) / C, mean2 = warp_sum(s2) / C;
  const float rs = p.rstd[t];
  const float m0 = p.scaled_out != nullptr ? p.masks[2 * (t / p.g.L)] : 0.f;
  for (int k = lane; k < C; k += 32) {
    const float dh = dh_at(k);
    if (p.dh_copy != nullptr) p.dh_copy[tok + k] = dh;
    const float dxh = dh * p.w[k];
    const float res = p.res_bf16 != nullptr ? bf2f(p.res_bf16[tok + k]) : p.res_f32[tok + k];
    const float out = res + rs * (dxh - mean1 - p.xhat[tok + k] * mean2);
    if (p.out_f32 != nullptr) p.out_f32[tok + k] = out;
    if (p.out_bf16 != nullptr) p.out_bf16[tok + k] = f2bf(out);
    if (p.scaled_out != nullptr) p.scaled_out[(long)r * C + k] = f2bf(m0 * out);
  }
}

// Partial column sums over chunks of rows_per_chunk rows: part_a[chunk][c] =
// sum a[r][c], and with b, part_ab[chunk][c] = sum a[r][c] * b[r][c]; one
// thread per column, rows in order
template <typename T>
__global__ void col_sums_kernel(const T* __restrict__ a, const float* __restrict__ b, int M,
                                int N, int rows_per_chunk, float* __restrict__ part_a,
                                float* __restrict__ part_ab) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int chunk = blockIdx.y;
  if (c >= N) return;
  const int r0 = chunk * rows_per_chunk, r1 = min(M, r0 + rows_per_chunk);
  float sa = 0.f, sab = 0.f;
  for (int r = r0; r < r1; ++r) {
    float av;
    if constexpr (std::is_same<T, bf16>::value)
      av = bf2f(a[(long)r * N + c]);
    else
      av = a[(long)r * N + c];
    sa += av;
    if (b != nullptr) sab += av * b[(long)r * N + c];
  }
  part_a[(long)chunk * N + c] = sa;
  if (b != nullptr) part_ab[(long)chunk * N + c] = sab;
}

// out[i] = sum over s = 0..S-1, in order, of part[s * n + i]
__global__ void reduce_partials_kernel(const float* __restrict__ part, int S, long n,
                                       float* __restrict__ out) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[(long)k * n + i];
  out[i] = s;
}

// Weight-grad GEMM: part[s] = A[rows of split s]^T B[same rows], A (M, Ka)
// and B (M, N) bf16 row-major, float32 accumulation on WMMA tensor cores.
// Output tile 64 (Ka) x 64 (N), 4 warps of 32x32, the split's rows 32 at a
// time; the next tile is loaded into registers while the current one
// multiplies. Needs M % 32 == 0, rows_per_split % 32 == 0, Ka and N % 16 == 0.
constexpr int TN_LD = 64 + 8;

__global__ void __launch_bounds__(GEMM_THREADS) gemm_tn_kernel(const bf16* __restrict__ A,
                                                               const bf16* __restrict__ B,
                                                               float* __restrict__ part, int M,
                                                               int Ka, int N, int rows_per_split) {
  __shared__ __align__(128) bf16 As[32 * TN_LD];
  __shared__ __align__(128) bf16 Bs[32 * TN_LD];
  __shared__ __align__(128) float Cs[64 * LDC_S];
  const int n0 = blockIdx.x * 64, ka0 = blockIdx.y * 64, s = blockIdx.z;
  const int m_begin = s * rows_per_split, m_end = min(M, m_begin + rows_per_split);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int lm = tid >> 2, lc = (tid & 3) * 16;  // 16 elements of one row per thread

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Pack8 ra[2], rb[2];
  auto load_tile = [&](int m0) {
    ra[0].u = ra[1].u = rb[0].u = rb[1].u = make_uint4(0, 0, 0, 0);
    const long row = m0 + lm;
    if (ka0 + lc < Ka) {
      const uint4* ptr = reinterpret_cast<const uint4*>(A + row * Ka + ka0 + lc);
      ra[0].u = ptr[0];
      ra[1].u = ptr[1];
    }
    if (n0 + lc < N) {
      const uint4* ptr = reinterpret_cast<const uint4*>(B + row * N + n0 + lc);
      rb[0].u = ptr[0];
      rb[1].u = ptr[1];
    }
  };

  if (m_begin < m_end) load_tile(m_begin);
  for (int m0 = m_begin; m0 < m_end; m0 += 32) {
    uint4* da = reinterpret_cast<uint4*>(As + lm * TN_LD + lc);
    da[0] = ra[0].u;
    da[1] = ra[1].u;
    uint4* db = reinterpret_cast<uint4*>(Bs + lm * TN_LD + lc);
    db[0] = rb[0].u;
    db[1] = rb[1].u;
    __syncthreads();
    if (m0 + 32 < m_end) load_tile(m0 + 32);
#pragma unroll
    for (int kk = 0; kk < 32; kk += 16) {
      // A^T (ka, m) is As (m, ka) read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * TN_LD + wm * 32 + i * 16, TN_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * TN_LD + wn * 32 + j * 16, TN_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC_S + wn * 32 + j * 16,
                              acc[i][j], LDC_S, wmma::mem_row_major);
  __syncthreads();
  float* out = part + (long)s * Ka * N;
  for (int idx = tid; idx < 64 * 16; idx += GEMM_THREADS) {  // 4 outputs each
    const int r = idx / 16, c = (idx % 16) * 4;
    if (ka0 + r >= Ka || n0 + c >= N) continue;
    *reinterpret_cast<float4*>(out + (long)(ka0 + r) * N + n0 + c) =
        *reinterpret_cast<const float4*>(Cs + r * LDC_S + c);
  }
}

// Attention backward, one block of 4 warps per (window group, head); the
// block walks windows blockIdx.x, + gridDim.x, ... For each window: Q, K, V,
// dO and the bias (+ mask) staged; S and the bf16 P recomputed as in the
// forward; dV = P^T dO; dP = dO V^T; dS = P (dP - rowsum(dP P)) in float32,
// summed into the block's bias-grad registers and rounded to bf16 in place of
// P; dq = dS K and dk = dS^T q. dq, dk, dV are rounded to bf16 into the
// (rows, 3C) dqkv matrix. Each block writes its (64, 64) bias-grad sum to
// dbias_part[(block * nh + head)].
__global__ void __launch_bounds__(ATT_THREADS) window_attention_bwd_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dattn, const float* __restrict__ bias,
    const float* __restrict__ mask, bf16* __restrict__ dqkv, float* __restrict__ dbias_part,
    int C, int nh, int nW, int n_windows) {
  __shared__ __align__(128) bf16 Qs[WIN_N * LDQ];
  __shared__ __align__(128) bf16 Ks[WIN_N * LDQ];
  __shared__ __align__(128) bf16 Vs[WIN_N * LDQ];
  __shared__ __align__(128) bf16 dOs[WIN_N * LDQ];
  __shared__ __align__(128) float Ss[WIN_N * LDS_S];  // S, then dV, dP, dS, dq, dk
  __shared__ __align__(128) bf16 Ps[WIN_N * LDP];     // P, then bf16(dS)
  const int h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16;
  const int ld3 = 3 * C;
  constexpr int PER_THREAD = WIN_N * WIN_N / ATT_THREADS;
  float dbias[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) dbias[i] = 0.f;

  for (int win = blockIdx.x; win < n_windows; win += gridDim.x) {
    const long row0 = (long)win * WIN_N;
    stage_head(qkv, dattn, Qs, Ks, Vs, dOs, row0, C, h, 4, tid);
    stage_bias(bias, mask, Ss, h, win, nW, tid);
    __syncthreads();
    scores_softmax(Qs, Ks, Ss, Ps, r0, lane);
    __syncthreads();  // every row of P is read below

    // dV = P^T dO: warp w owns key rows 16w..16w+15
#pragma unroll
    for (int dt = 0; dt < HDP / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int kk = 0; kk < WIN_N; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fp;  // P^T
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fd;
        wmma::load_matrix_sync(fp, Ps + kk * LDP + r0, LDP);
        wmma::load_matrix_sync(fd, dOs + kk * LDQ + dt * 16, LDQ);
        wmma::mma_sync(o, fp, fd, o);
      }
      wmma::store_matrix_sync(Ss + r0 * LDS_S + dt * 16, o, LDS_S, wmma::mem_row_major);
    }
    __syncwarp();
    store_head_rows(Ss, dqkv + row0 * ld3 + 2 * C + h * HD, ld3, r0, lane);
    __syncwarp();

    // dP = dO V^T for the warp's query rows
#pragma unroll
    for (int jt = 0; jt < WIN_N / 16; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> d;
      wmma::fill_fragment(d, 0.f);
#pragma unroll
      for (int kk = 0; kk < HDP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fd;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fv;  // V^T
        wmma::load_matrix_sync(fd, dOs + r0 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(fv, Vs + jt * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(d, fd, fv, d);
      }
      wmma::store_matrix_sync(Ss + r0 * LDS_S + jt * 16, d, LDS_S, wmma::mem_row_major);
    }
    __syncthreads();  // every warp is done reading P (dV) before dS overwrites it

    // dS = P (dP - rowsum(dP P)), two lanes per row, 32 columns each; float32
    // in Ss, bf16 over P in Ps
    {
      const int r = r0 + lane / 2, c0 = (lane & 1) * 32;
      float* dr = Ss + r * LDS_S + c0;
      bf16* pr = Ps + r * LDP + c0;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) rs += dr[c] * bf2f(pr[c]);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float ds = bf2f(pr[c]) * (dr[c] - rs);
        dr[c] = ds;
        pr[c] = f2bf(ds);
      }
    }
    __syncthreads();  // all of dS: the bias grad and dk read every row
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = tid + i * ATT_THREADS;
      dbias[i] += Ss[(e / WIN_N) * LDS_S + (e % WIN_N)];
    }
    __syncthreads();  // Ss is overwritten below

    // dq = dS K (the q-scale lives in the folded weights)
#pragma unroll
    for (int dt = 0; dt < HDP / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int kk = 0; kk < WIN_N; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fs;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fk;
        wmma::load_matrix_sync(fs, Ps + r0 * LDP + kk, LDP);
        wmma::load_matrix_sync(fk, Ks + kk * LDQ + dt * 16, LDQ);
        wmma::mma_sync(o, fs, fk, o);
      }
      wmma::store_matrix_sync(Ss + r0 * LDS_S + dt * 16, o, LDS_S, wmma::mem_row_major);
    }
    __syncwarp();
    store_head_rows(Ss, dqkv + row0 * ld3 + h * HD, ld3, r0, lane);
    __syncwarp();

    // dk = dS^T q: warp w owns key rows 16w..16w+15
#pragma unroll
    for (int dt = 0; dt < HDP / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int kk = 0; kk < WIN_N; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fs;  // dS^T
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fq;
        wmma::load_matrix_sync(fs, Ps + kk * LDP + r0, LDP);
        wmma::load_matrix_sync(fq, Qs + kk * LDQ + dt * 16, LDQ);
        wmma::mma_sync(o, fs, fq, o);
      }
      wmma::store_matrix_sync(Ss + r0 * LDS_S + dt * 16, o, LDS_S, wmma::mem_row_major);
    }
    __syncwarp();
    store_head_rows(Ss, dqkv + row0 * ld3 + C + h * HD, ld3, r0, lane);
    __syncthreads();  // the next window overwrites every buffer
  }

  float* out = dbias_part + ((long)blockIdx.x * nh + h) * WIN_N * WIN_N;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) out[tid + i * ATT_THREADS] = dbias[i];
}

// ---- host side -----------------------------------------------------------

struct Shapes {
  int B, H, W, C, nh, win, shift, hidden;
  long M() const { return (long)B * H * W; }
  int n_windows() const { return B * (H / win) * (W / win); }
  int att_groups() const {
    const int want = 512 / nh > 0 ? 512 / nh : 1;
    return n_windows() < want ? n_windows() : want;
  }
};

// rows per split of a weight-grad GEMM over M rows with `tiles` output tiles:
// enough splits for ~4 blocks per SM, each split a multiple of 32 rows
int tn_rows_per_split(long M, int tiles) {
  long splits = (528 + tiles - 1) / tiles;
  if (splits < 1) splits = 1;
  long rows = (M + splits - 1) / splits;
  rows = (rows + 31) / 32 * 32;
  return static_cast<int>(rows < 32 ? 32 : rows);
}

constexpr int COL_CHUNK = 512;  // rows per partial column sum

void reduce_partials(const float* part, int S, long n, float* out, cudaStream_t stream) {
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, S, n, out);
}

// dW (Ka, N) = A^T B over the M rows, split and reduced in a fixed order
void weight_grad(const bf16* A, const bf16* B, long M, int Ka, int N, float* part, float* out,
                 cudaStream_t stream) {
  const int tiles = ((Ka + 63) / 64) * ((N + 63) / 64);
  const int rows = tn_rows_per_split(M, tiles);
  const int splits = static_cast<int>((M + rows - 1) / rows);
  gemm_tn_kernel<<<dim3((N + 63) / 64, (Ka + 63) / 64, splits), GEMM_THREADS, 0, stream>>>(
      A, B, part, static_cast<int>(M), Ka, N, rows);
  reduce_partials(part, splits, (long)Ka * N, out, stream);
}

// column sums of a (and of a * b into out_ab), chunked and reduced in order
template <typename T>
void col_sums(const T* a, const float* b, long M, int N, float* part, float* out_a,
              float* out_ab, cudaStream_t stream) {
  const int chunks = static_cast<int>((M + COL_CHUNK - 1) / COL_CHUNK);
  float* part_ab = part + (long)chunks * N;
  col_sums_kernel<T><<<dim3((N + 127) / 128, chunks), 128, 0, stream>>>(
      a, b, static_cast<int>(M), N, COL_CHUNK, part, part_ab);
  reduce_partials(part, chunks, N, out_a, stream);
  if (b != nullptr) reduce_partials(part_ab, chunks, N, out_ab, stream);
}

}  // namespace
