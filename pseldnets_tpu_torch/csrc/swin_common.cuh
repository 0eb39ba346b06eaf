// Device code of the AdapterBit block forward K4 (swin_block_adapt.cu,
// through swin_adapt_common.cuh), the last user of the pre-Hopper WMMA code:
// token row maps, LayerNorm moments, the bf16 WMMA tile GEMM with its
// LayerNorm prologue and epilogues, and the window attention forward. Each
// of the last three is a __device__ function of one row, one output tile or
// one (window, head), called once by its own __global__ kernel. K2 and K11
// moved to the Hopper forward layer swin_fwd_sm90.cuh, K3 and K5 to
// swin_bwd_sm90.cuh.
//
// Every function lives in an anonymous namespace: each source that includes
// this header is its own shared library with its own copy. The activation
// pointers of the __device__ functions carry no __restrict__ (they were
// written for a kernel that read activations other blocks wrote earlier in
// the same launch, which the read-only load path may not see).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr float LN_EPS = 1e-5f;
constexpr int WIN_N = 64;  // tokens per 8x8 window

enum { A_PLAIN = 0, A_LN = 1, A_MERGE = 2 };

// token geometry of one block call
struct RowMap {
  int L, H, W, win, shift, C;
};

// 8 bf16 moved as one 16-byte load or store
union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

// row r in window order (image, window (wi, wj), token (ti, tj)) -> index of
// the token in the unshifted (B*L) layout: the window partition of the map
// rolled by -shift, and, read backwards, the window reverse + unshift
__device__ __forceinline__ int window_token(const RowMap& g, int r) {
  const int n = g.win * g.win;
  const int b = r / g.L, rr = r - b * g.L;
  const int wid = rr / n, t = rr - wid * n;
  const int nww = g.W / g.win;
  const int wi = wid / nww, wj = wid - wi * nww;
  const int ti = t / g.win, tj = t - ti * g.win;
  int h = wi * g.win + ti + g.shift;
  if (h >= g.H) h -= g.H;
  int w = wj * g.win + tj + g.shift;
  if (w >= g.W) w -= g.W;
  return b * g.L + h * g.W + w;
}

// merged row r (image, i, j), piece p of the 2x2 concat -> source token
__device__ __forceinline__ int merge_token(const RowMap& g, int r, int piece) {
  const int l4 = g.L / 4, w2 = g.W / 2;
  const int b = r / l4, rr = r - b * l4;
  const int i = rr / w2, j = rr - i * w2;
  return b * g.L + (2 * i + (piece & 1)) * g.W + 2 * j + (piece >> 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// d/dx gelu(x) = Phi(x) + x phi(x), exact erf form
__device__ __forceinline__ float gelu_grad(float x) {
  const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
  return cdf + x * (expf(-0.5f * x * x) * 0.3989422804014327f);
}

// LayerNorm moments of one row, by one warp: MERGE = 0 reads row `row` of a
// (rows, K) matrix, MERGE = 1 the 4C gather of merged row `row`
template <int MERGE>
__device__ __forceinline__ void row_stats_row(const bf16* x, float* mean, float* rstd, int row,
                                              int lane, int K,
                                              const RowMap& g) {
  auto load = [&](int k) -> float {
    if (MERGE) {
      const int piece = k / g.C, c = k - piece * g.C;
      return bf2f(x[(long)merge_token(g, row, piece) * g.C + c]);
    }
    return bf2f(x[(long)row * K + k]);
  };
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += load(k);
  const float mu = warp_sum(s) / K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = load(k) - mu;
    v += d * d;
  }
  v = warp_sum(v) / K;
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rsqrtf(v + LN_EPS);
  }
}

// LayerNorm moments of `rows` rows of K elements, one warp per row
template <int MERGE>
__global__ void __launch_bounds__(256) row_stats_kernel(const bf16* __restrict__ x,
                                                        float* __restrict__ mean,
                                                        float* __restrict__ rstd,
                                                        int rows, int K, RowMap g) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;
  row_stats_row<MERGE>(x, mean, rstd, row, threadIdx.x & 31, K, g);
}

struct GemmParams {
  const bf16* A;      // A_PLAIN: (M, K) rows; A_LN: token rows; A_MERGE: tokens (.., C)
  int lda;            // row stride of A in elements
  const float* mean;  // A_LN: per source token; A_MERGE: per row
  const float* rstd;
  const float* ln_w;  // (K)
  const float* ln_b;
  const bf16* Bm;     // (K, N) row-major, or (N, K) row-major when transposed
  const float* bias;  // (N) or null
  const bf16* resid;  // added after rounding, at the output row, or null
  const float* rscale;  // with resid: per-image scale (stride 2) of the rounded
                        // product before the residual add, or null
  float* aux;         // float32 copy of the pre-activation at the output row, or null
  const float* dgelu;  // multiply by gelu'(dgelu[output row]) (float32), or null
  bf16* out;          // (rows, N)
  float* out_f32;     // float32 output instead of out, or null
  int M, N, K;
  RowMap g;
  int a_window;       // A_LN: row r reads token window_token(r)
  int out_window;     // output row r goes to token window_token(r)
  int gelu;
};

constexpr int BM = 64, BN = 64, BK = 32, GEMM_THREADS = 128;
constexpr int LDA_S = BK + 8, LDB_S = BN + 8, LDBT_S = BK + 8, LDC_S = BN + 4;

// the shared memory of one GEMM tile
template <bool BT>
struct GemmSmem {
  alignas(128) bf16 As[BM * LDA_S];
  alignas(128) bf16 Bs[BT ? BN * LDBT_S : BK * LDB_S];
  alignas(128) float Cs[BM * LDC_S];
  int src_row[BM], dst_row[BM];
  float row_mean[BM], row_rstd[BM];
};

// C = A' @ B with A' = A, LN(A rows) or LN(merge gather of A), and B the
// (K, N) matrix Bm or, with BT, the transpose of the (N, K) matrix Bm.
// Epilogue: bias -> [aux copy] -> GELU -> [* gelu'(dgelu)] -> [float32 out],
// or bf16 -> [* bf16(rscale)] -> + residual -> bf16, scattered through
// out_window; the bracketed steps exist only in the EXT instantiation, so
// the serving GEMMs compile without them. Needs K % 32 == 0, N % 16 == 0 and
// (A_MERGE) C % 16 == 0. The next A/B tile is loaded into registers while
// the tensor cores work on the current. This is the output tile at rows
// m0.., columns n0.. by the block's GEMM_THREADS threads; a caller that runs
// another tile in the same shared memory synchronizes the block first.
template <int AMODE, bool BT, bool EXT>
__device__ __forceinline__ void gemm_tile(const GemmParams& p, int m0, int n0, GemmSmem<BT>& sm) {
  typedef typename std::conditional<BT, wmma::col_major, wmma::row_major>::type BLayout;
  bf16* As = sm.As;
  bf16* Bs = sm.Bs;
  float* Cs = sm.Cs;
  int* src_row = sm.src_row;
  int* dst_row = sm.dst_row;
  float* row_mean = sm.row_mean;
  float* row_rstd = sm.row_rstd;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;

  if (tid < BM) {
    const int r = m0 + tid;
    int src = -1, dst = -1;
    float mu = 0.f, rs = 0.f;
    if (r < p.M) {
      src = (AMODE == A_LN && p.a_window) ? window_token(p.g, r) : r;
      dst = p.out_window ? window_token(p.g, r) : r;
      if (AMODE != A_PLAIN) {
        mu = p.mean[src];
        rs = p.rstd[src];
      }
    }
    src_row[tid] = src;
    dst_row[tid] = dst;
    row_mean[tid] = mu;
    row_rstd[tid] = rs;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int a_r = tid >> 1, a_k = (tid & 1) * 16;  // 16 A elements per thread
  // 16 B elements per thread: row b_k, columns b_n.. of (K, N); or, with BT,
  // row b_n, columns b_k.. of (N, K)
  const int b_k = BT ? (tid & 1) * 16 : tid >> 2;
  const int b_n = BT ? tid >> 1 : (tid & 3) * 16;
  const int src = src_row[a_r];
  const float mu = row_mean[a_r], rs = row_rstd[a_r];
  Pack8 ra[2], rb[2];
  auto load_tile = [&](int k0) {
    ra[0].u = ra[1].u = rb[0].u = rb[1].u = make_uint4(0, 0, 0, 0);
    if (src >= 0) {
      const int k = k0 + a_k;
      const bf16* ptr;
      if (AMODE == A_MERGE) {
        const int piece = k / p.g.C;
        ptr = p.A + (long)merge_token(p.g, src, piece) * p.g.C + (k - piece * p.g.C);
      } else {
        ptr = p.A + (long)src * p.lda + k;
      }
      ra[0].u = reinterpret_cast<const uint4*>(ptr)[0];
      ra[1].u = reinterpret_cast<const uint4*>(ptr)[1];
    }
    if (n0 + b_n < p.N) {
      const bf16* bp = BT ? p.Bm + (long)(n0 + b_n) * p.K + k0 + b_k
                          : p.Bm + (long)(k0 + b_k) * p.N + n0 + b_n;
      rb[0].u = reinterpret_cast<const uint4*>(bp)[0];
      rb[1].u = reinterpret_cast<const uint4*>(bp)[1];
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    if (AMODE != A_PLAIN && src >= 0) {  // LayerNorm prologue, float32
      const float4* gw = reinterpret_cast<const float4*>(p.ln_w + k0 + a_k);
      const float4* gb = reinterpret_cast<const float4*>(p.ln_b + k0 + a_k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w4 = gw[q], b4 = gb[q];
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          bf16& e = ra[q / 2].h[(q % 2) * 4 + t];
          e = f2bf((bf2f(e) - mu) * rs * wv[t] + bv[t]);
        }
      }
    }
    uint4* da = reinterpret_cast<uint4*>(As + a_r * LDA_S + a_k);
    da[0] = ra[0].u;
    da[1] = ra[1].u;
    uint4* db = reinterpret_cast<uint4*>(BT ? Bs + b_n * LDBT_S + b_k : Bs + b_k * LDB_S + b_n);
    db[0] = rb[0].u;
    db[1] = rb[1].u;
    __syncthreads();
    if (k0 + BK < p.K) load_tile(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA_S + kk, LDA_S);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (BT)
          wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * LDBT_S + kk, LDBT_S);
        else
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB_S + wn * 32 + j * 16, LDB_S);
      }
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
  for (int idx = tid; idx < BM * (BN / 8); idx += GEMM_THREADS) {  // 8 outputs each
    const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
    const int orow = dst_row[r], gc = n0 + c;
    if (orow < 0 || gc >= p.N) continue;
    const long o = (long)orow * p.N + gc;
    const float4 c0 = *reinterpret_cast<const float4*>(Cs + r * LDC_S + c);
    const float4 c1 = *reinterpret_cast<const float4*>(Cs + r * LDC_S + c + 4);
    float v[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    if (p.bias != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += p.bias[gc + e];
    }
    if (EXT && p.aux != nullptr) {
      reinterpret_cast<float4*>(p.aux + o)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p.aux + o)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    if (p.gelu) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = gelu_exact(v[e]);
    }
    if (EXT && p.dgelu != nullptr) {
      const float4 f0 = reinterpret_cast<const float4*>(p.dgelu + o)[0];
      const float4 f1 = reinterpret_cast<const float4*>(p.dgelu + o)[1];
      const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= gelu_grad(f[e]);
    }
    if (EXT && p.out_f32 != nullptr) {
      reinterpret_cast<float4*>(p.out_f32 + o)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p.out_f32 + o)[1] = make_float4(v[4], v[5], v[6], v[7]);
      continue;
    }
    Pack8 res, packed;
    res.u = make_uint4(0, 0, 0, 0);
    if (p.resid != nullptr) res.u = *reinterpret_cast<const uint4*>(p.resid + o);
    const bool scaled = EXT && p.rscale != nullptr;
    const float scale = scaled ? bf2f(f2bf(p.rscale[2 * (orow / p.g.L)])) : 1.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      packed.h[e] = f2bf(v[e]);
      if (p.resid != nullptr) {
        if (scaled) packed.h[e] = f2bf(scale * bf2f(packed.h[e]));
        packed.h[e] = f2bf(bf2f(res.h[e]) + bf2f(packed.h[e]));
      }
    }
    *reinterpret_cast<uint4*>(p.out + o) = packed.u;
  }
}

template <int AMODE, bool BT, bool EXT>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmParams p) {
  __shared__ GemmSmem<BT> sm;
  gemm_tile<AMODE, BT, EXT>(p, blockIdx.y * BM, blockIdx.x * BN, sm);
}

// One block of 4 warps per (window, head). Q, K, V (head dim zero-padded to
// 32) and the bias (+ mask) are staged in shared memory; warp w owns query
// rows 16w..16w+15 from there on: S = bias + Q K^T on the tensor cores
// (bf16 operands, float32 accumulation), float32 max-subtracted softmax,
// P rounded to bf16, O = P V on the tensor cores, O rounded to bf16.
constexpr int ATT_THREADS = 128, HD = 24, HDP = 32;
constexpr int LDQ = HDP + 8, LDS_S = WIN_N + 4, LDP = WIN_N + 8;

// Q, K, V of one (window, head) from the (rows, 3C) qkv matrix into shared
// memory, head dim zero-padded to HDP; mats = 3, or 4 with rows of `extra`
// (rows, C) into the fourth buffer
__device__ __forceinline__ void stage_head(const bf16* qkv, const bf16* extra,
                                           bf16* Qs, bf16* Ks, bf16* Vs, bf16* Es, long row0,
                                           int C, int h, int mats, int tid) {
  const int ld = 3 * C;
  for (int idx = tid; idx < mats * WIN_N * (HDP / 8); idx += ATT_THREADS) {
    const int mat = idx / (WIN_N * (HDP / 8)), rem = idx % (WIN_N * (HDP / 8));
    const int j = rem / (HDP / 8), piece = rem % (HDP / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (piece * 8 < HD) {
      const bf16* src = mat < 3 ? qkv + (row0 + j) * ld + mat * C + h * HD + piece * 8
                                : extra + (row0 + j) * C + h * HD + piece * 8;
      v = *reinterpret_cast<const uint4*>(src);
    }
    bf16* dst = (mat == 0 ? Qs : mat == 1 ? Ks : mat == 2 ? Vs : Es) + j * LDQ + piece * 8;
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

// the head's (N, N) bias plus the window's shift mask into Ss (row stride LDS_S)
__device__ __forceinline__ void stage_bias(const float* __restrict__ bias, const float* __restrict__ mask,
                                           float* Ss, int h, int win, int nW, int tid) {
  const float* bh = bias + (long)h * WIN_N * WIN_N;
  const float* mw = mask != nullptr ? mask + (long)(win % nW) * WIN_N * WIN_N : nullptr;
  for (int idx = tid; idx < WIN_N * WIN_N / 4; idx += ATT_THREADS) {
    const int r = idx / (WIN_N / 4), c = (idx % (WIN_N / 4)) * 4;
    float4 b = *reinterpret_cast<const float4*>(bh + r * WIN_N + c);
    if (mw != nullptr) {
      const float4 m = *reinterpret_cast<const float4*>(mw + r * WIN_N + c);
      b.x += m.x;
      b.y += m.y;
      b.z += m.z;
      b.w += m.w;
    }
    *reinterpret_cast<float4*>(Ss + r * LDS_S + c) = b;
  }
}

// S = Ss + Q K^T for the warp's 16 query rows (in place in Ss), then the
// float32 max-subtracted softmax of those rows, rounded to bf16 into Ps
__device__ __forceinline__ void scores_softmax(const bf16* Qs, const bf16* Ks, float* Ss, bf16* Ps,
                                               int r0, int lane) {
#pragma unroll
  for (int jt = 0; jt < WIN_N / 16; ++jt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
    wmma::load_matrix_sync(s, Ss + r0 * LDS_S + jt * 16, LDS_S, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < HDP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;  // K^T
      wmma::load_matrix_sync(fq, Qs + r0 * LDQ + kk, LDQ);
      wmma::load_matrix_sync(fk, Ks + jt * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(s, fq, fk, s);
    }
    wmma::store_matrix_sync(Ss + r0 * LDS_S + jt * 16, s, LDS_S, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax: two lanes per row, 32 columns each
  const int r = r0 + lane / 2, c0 = (lane & 1) * 32;
  const float* sr = Ss + r * LDS_S + c0;
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 32; ++c) mx = fmaxf(mx, sr[c]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  float e[32], sum = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    e[c] = expf(sr[c] - mx);
    sum += e[c];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
#pragma unroll
  for (int c = 0; c < 32; ++c) Ps[r * LDP + c0 + c] = f2bf(e[c] / sum);
  __syncwarp();
}

// rows r0..r0+15, head-dim columns < HD of the float32 tile in Ss (row
// stride LDS_S) rounded to bf16 into dst (row stride ld, head offset added
// by the caller); two lanes per row
__device__ __forceinline__ void store_head_rows(const float* Ss, bf16* dst, long ld, int r0, int lane) {
  const int r = r0 + lane / 2, c0 = (lane & 1) * 16;
  bf16* orow = dst + (long)r * ld;
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (c0 + c < HD) orow[c0 + c] = f2bf(Ss[r * LDS_S + c0 + c]);
}

// the shared memory of one (window, head)
struct AttnSmem {
  alignas(128) bf16 Qs[WIN_N * LDQ];
  alignas(128) bf16 Ks[WIN_N * LDQ];
  alignas(128) bf16 Vs[WIN_N * LDQ];
  alignas(128) float Ss[WIN_N * LDS_S];  // scores, then O
  alignas(128) bf16 Ps[WIN_N * LDP];
};

// window `win` (of B*nW), head h, by the block's ATT_THREADS threads; a
// caller that runs another (window, head) in the same shared memory
// synchronizes the block first
__device__ __forceinline__ void window_attention_tile(const bf16* qkv,
                                                      const float* __restrict__ bias,
                                                      const float* __restrict__ mask,
                                                      bf16* out, int C, int nW,
                                                      int win, int h, AttnSmem& sm) {
  bf16* Qs = sm.Qs;
  bf16* Ks = sm.Ks;
  bf16* Vs = sm.Vs;
  float* Ss = sm.Ss;  // scores, then O
  bf16* Ps = sm.Ps;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long row0 = (long)win * WIN_N;

  stage_head(qkv, nullptr, Qs, Ks, Vs, nullptr, row0, C, h, 3, tid);
  stage_bias(bias, mask, Ss, h, win, nW, tid);
  __syncthreads();

  const int r0 = warp * 16;
  scores_softmax(Qs, Ks, Ss, Ps, r0, lane);

#pragma unroll
  for (int dt = 0; dt < HDP / 16; ++dt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    wmma::fill_fragment(o, 0.f);
#pragma unroll
    for (int kk = 0; kk < WIN_N; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
      wmma::load_matrix_sync(fp, Ps + r0 * LDP + kk, LDP);
      wmma::load_matrix_sync(fv, Vs + kk * LDQ + dt * 16, LDQ);
      wmma::mma_sync(o, fp, fv, o);
    }
    wmma::store_matrix_sync(Ss + r0 * LDS_S + dt * 16, o, LDS_S, wmma::mem_row_major);
  }
  __syncwarp();
  store_head_rows(Ss, out + row0 * C + h * HD, C, r0, lane);
}

__global__ void __launch_bounds__(ATT_THREADS) window_attention_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ mask, bf16* __restrict__ out, int C, int nW) {
  __shared__ AttnSmem sm;
  window_attention_tile(qkv, bias, mask, out, C, nW, blockIdx.x, blockIdx.y, sm);
}

template <int AMODE, bool BT = false>
void launch_gemm(const GemmParams& p, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  if (p.aux != nullptr || p.dgelu != nullptr || p.out_f32 != nullptr || p.rscale != nullptr)
    gemm_kernel<AMODE, BT, true><<<grid, GEMM_THREADS, 0, stream>>>(p);
  else
    gemm_kernel<AMODE, BT, false><<<grid, GEMM_THREADS, 0, stream>>>(p);
}

template <int MERGE>
void launch_stats(const bf16* x, float* mean, float* rstd, int rows, int K,
                  const RowMap& g, cudaStream_t stream) {
  row_stats_kernel<MERGE><<<(rows + 7) / 8, 256, 0, stream>>>(x, mean, rstd, rows, K, g);
}

}  // namespace
