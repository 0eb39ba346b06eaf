// Kernel K6: the pre-LN ViT block of PaSST, eval form.
//
// Replaces the JAX package's ops/pallas/vit_block.py::vit_block_fused
// (_vit_kernel, attn_impl="exact"). x (B, N, C) bf16 -> (B, N, C):
//   LN1 (eps 1e-6) -> qkv -> per head S = (q / 8) K^T over all N tokens ->
//   max-subtracted float32 softmax -> P V -> proj -> + x -> LN2 -> fc1 ->
//   exact erf GELU -> fc2 -> + y.
// Matmul operands bf16 with float32 accumulation (tensor cores); LayerNorm
// and softmax in float32; activations rounded to bf16 where the Pallas kernel
// rounds them (qkv, probabilities, heads, proj, residual sums, GELU output).
// The q-scale 1/8 (head dim 64) is a power of two, so scaling the float32
// scores is the same arithmetic as scaling q in bf16 before the product.
//
// What bounds it on the H100: per image 2 N C (3C + C + 2 hidden) GEMM FLOPs
// and 4 N^2 C attention FLOPs (9.64 GFLOP at N = 602, C = 768, hidden 3072)
// against ~14 MB of weights and 2 N C bf16 activations per image: far above
// the bf16 balance point, so the bound is the tensor-core rate.
//
// Design (correct and simple first). One image's activations (602 x 768
// bf16, 925 KB) do not fit an SM's 227 KB of shared memory as they fit the
// TPU's VMEM, so the block is a sequence of launches from one C entry point,
// on the caller's stream, with qkv, the heads, y and the hidden activations
// through device memory:
//  * vit_row_stats: LayerNorm moments (two-pass, float32, eps as given), one
//    warp per row;
//  * gemm_kernel of swin_common.cuh (K2's 64x64x32 bf16 WMMA tile GEMM, no
//    window maps): qkv with the LN1 prologue; proj + bias, rounded, + x;
//    fc1 with the LN2 prologue, bias and GELU; fc2 + bias, rounded, + y;
//  * vit_attention: one block of 8 warps per (image, head, 32 query rows; 16
//    when N > 1664). Q is staged in shared memory; K is streamed in 64-key
//    tiles and S for every key of the query rows (N padded to a multiple of
//    64, the pad ignored by the softmax) stays in shared memory: 32 x 644 x
//    4 B = 82 KB at N = 602. The exact float32 softmax rounds P to bf16 in
//    place over S; V is streamed the same way for O = P V, and O is rounded
//    to bf16 into the head's columns of the (B N, C) attention matrix.
// The online-softmax (flash) form, wgmma, TMA and pipelining are later work:
// the flash form rounds the unnormalized P, other rounding points than the
// Pallas kernel's exact path.

#include "swin_common.cuh"

namespace {

constexpr int VHD = 64;         // head dim
constexpr int KT = 64;          // keys per streamed K or V tile
constexpr int LDT = VHD + 8;    // bf16 row stride of the Q, K and V tiles
constexpr int LDO = VHD + 4;    // float32 row stride of the staged O tile
constexpr int VIT_ATT_THREADS = 256;
constexpr int NWARP = VIT_ATT_THREADS / 32;
constexpr size_t SMEM_MAX = 232448;  // a block's shared memory on sm_90

__host__ __device__ inline int pad_keys(int N) { return (N + KT - 1) / KT * KT; }

// Q tile, K/V tile and the QT x (NP + 4) float32 scores
constexpr size_t attention_smem(int QT, int NP) {
  return (size_t)(QT + KT) * LDT * sizeof(bf16) + (size_t)QT * (NP + 4) * sizeof(float);
}

// the most tokens the scores of 16 query rows leave room for (ops/vit_block.py
// MAX_TOKENS)
constexpr int MAX_TOKENS = 3392;
static_assert(attention_smem(16, MAX_TOKENS) <= SMEM_MAX &&
                  attention_smem(16, MAX_TOKENS + KT) > SMEM_MAX,
              "MAX_TOKENS is the largest multiple of 64 that fits");

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(256) vit_row_stats(const bf16* __restrict__ x,
                                                     float* __restrict__ mean,
                                                     float* __restrict__ rstd,
                                                     int rows, int K, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (long)row * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += bf2f(xr[k]);
  const float mu = warp_sum(s) / K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = bf2f(xr[k]) - mu;
    v += d * d;
  }
  v = warp_sum(v) / K;
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rsqrtf(v + eps);
  }
}

// tokens r0 .. r0 + rows - 1 of one image (first row img0 of the (B N, 3C)
// qkv matrix), columns col0 .. col0 + 63, into a bf16 tile of row stride
// LDT; tokens at or past N are zero
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ qkv, bf16* dst, long img0,
                                           int r0, int rows, int N, int C, int col0) {
  for (int idx = threadIdx.x; idx < rows * (VHD / 8); idx += blockDim.x) {
    const int r = idx / (VHD / 8), piece = idx % (VHD / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < N)
      v = *reinterpret_cast<const uint4*>(qkv + (img0 + r0 + r) * (3L * C) + col0 + piece * 8);
    *reinterpret_cast<uint4*>(dst + r * LDT + piece * 8) = v;
  }
}

template <int QT>
__global__ void __launch_bounds__(VIT_ATT_THREADS) vit_attention(const bf16* __restrict__ qkv,
                                                                 bf16* __restrict__ out,
                                                                 int N, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ts = Qs + QT * LDT;                             // the K, then V, tile
  float* Ss = reinterpret_cast<float*>(Ts + KT * LDT);  // S, then P (bf16), then O
  const int NP = pad_keys(N), LDS = NP + 4, LDP = 2 * LDS;
  const int q0 = blockIdx.x * QT, h = blockIdx.y;
  const long img0 = (long)blockIdx.z * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int ST = (QT / 16) * (KT / 16);   // 16x16 tiles of a QT x KT score tile
  constexpr int OT = (QT / 16) * (VHD / 16);  // 16x16 tiles of the QT x 64 output
  constexpr int O_PER_WARP = (OT + NWARP - 1) / NWARP;

  stage_tile(qkv, Qs, img0, q0, QT, N, C, h * VHD);
  // S = Q K^T (unscaled), 64 keys at a time
  for (int k0 = 0; k0 < NP; k0 += KT) {
    __syncthreads();  // Q staged; the previous K tile consumed
    stage_tile(qkv, Ts, img0, k0, KT, N, C, C + h * VHD);
    __syncthreads();
    for (int t = warp; t < ST; t += NWARP) {
      const int ti = t / (KT / 16), tj = t % (KT / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < VHD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;  // K^T
        wmma::load_matrix_sync(fq, Qs + ti * 16 * LDT + kk, LDT);
        wmma::load_matrix_sync(fk, Ts + tj * 16 * LDT + kk, LDT);
        wmma::mma_sync(s, fq, fk, s);
      }
      wmma::store_matrix_sync(Ss + ti * 16 * LDS + k0 + tj * 16, s, LDS, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // softmax of (S / 8) over the N real keys, one warp per row; P (bf16)
  // overwrites the row's S from its start: each pass reads its 32 scores
  // before any lane writes, and a pass's writes end below the next one's reads
  for (int r = warp; r < QT; r += NWARP) {
    float* sr = Ss + r * LDS;
    bf16* pr = reinterpret_cast<bf16*>(sr);
    float mx = -INFINITY;
    for (int c = lane; c < N; c += 32) mx = fmaxf(mx, sr[c] * 0.125f);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) sum += expf(sr[c] * 0.125f - mx);
    sum = warp_sum(sum);
    for (int c0 = 0; c0 < NP; c0 += 32) {
      const int c = c0 + lane;
      const float v = c < N ? sr[c] : 0.f;
      __syncwarp();
      pr[c] = c < N ? f2bf(expf(v * 0.125f - mx) / sum) : f2bf(0.f);
    }
  }
  __syncthreads();

  // O = P V, 64 keys at a time; each warp keeps its output tiles
  const bf16* Ps = reinterpret_cast<const bf16*>(Ss);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[O_PER_WARP];
#pragma unroll
  for (int i = 0; i < O_PER_WARP; ++i) wmma::fill_fragment(o[i], 0.f);
  for (int k0 = 0; k0 < NP; k0 += KT) {
    stage_tile(qkv, Ts, img0, k0, KT, N, C, 2 * C + h * VHD);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < O_PER_WARP; ++i) {
      const int t = warp + i * NWARP;
      if (t >= OT) continue;
      const int ti = t / (VHD / 16), tj = t % (VHD / 16);
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fp, Ps + ti * 16 * LDP + k0 + kk, LDP);
        wmma::load_matrix_sync(fv, Ts + kk * LDT + tj * 16, LDT);
        wmma::mma_sync(o[i], fp, fv, o[i]);
      }
    }
    __syncthreads();  // V tile and P consumed
  }

  // O through shared memory (over P), rounded to bf16 into the head's columns
  float* Os = Ss;
#pragma unroll
  for (int i = 0; i < O_PER_WARP; ++i) {
    const int t = warp + i * NWARP;
    if (t >= OT) continue;
    const int ti = t / (VHD / 16), tj = t % (VHD / 16);
    wmma::store_matrix_sync(Os + ti * 16 * LDO + tj * 16, o[i], LDO, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < QT * (VHD / 8); idx += blockDim.x) {
    const int r = idx / (VHD / 8), c = (idx % (VHD / 8)) * 8;
    if (q0 + r >= N) continue;
    Pack8 pk;
#pragma unroll
    for (int e = 0; e < 8; ++e) pk.h[e] = f2bf(Os[r * LDO + c + e]);
    *reinterpret_cast<uint4*>(out + (img0 + q0 + r) * C + h * VHD + c) = pk.u;
  }
}

template <int QT>
cudaError_t launch_attention(const bf16* qkv, bf16* out, int B, int N, int C, int nh,
                             cudaStream_t stream) {
  const size_t smem = attention_smem(QT, pad_keys(N));
  const cudaError_t e = cudaFuncSetAttribute(
      vit_attention<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  vit_attention<QT><<<dim3((N + QT - 1) / QT, nh, B), VIT_ATT_THREADS, smem, stream>>>(
      qkv, out, N, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One eval ViT block. Weights are (in, out) bf16 matrices and float32
// vectors. Scratch: stats (2, B*N) f32, qkv (B*N, 3C), attn / y (B*N, C),
// hid (B*N, hidden) bf16. Output out (B*N, C) bf16. Needs C = 64 nh,
// C % 32 == 0, hidden % 32 == 0 and 1 <= N <= MAX_TOKENS.
extern "C" int vit_block_forward(
    const bf16* x, const float* ln1_w, const float* ln1_b, const bf16* qkv_w,
    const float* qkv_b, const bf16* proj_w, const float* proj_b, const float* ln2_w,
    const float* ln2_b, const bf16* fc1_w, const float* fc1_b, const bf16* fc2_w,
    const float* fc2_b, float* stats, bf16* qkv, bf16* attn, bf16* y, bf16* hid,
    bf16* out, int B, int N, int C, int nh, int hidden, float eps, cudaStream_t stream) {
  if (C != nh * VHD || C % 32 || hidden % 32 || N < 1 || N > MAX_TOKENS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * N;
  float* mean = stats;
  float* rstd = stats + M;

  // LN1 moments, then qkv
  vit_row_stats<<<(M + 7) / 8, 256, 0, stream>>>(x, mean, rstd, M, C, eps);
  GemmParams p{};
  p.A = x; p.lda = C; p.mean = mean; p.rstd = rstd; p.ln_w = ln1_w; p.ln_b = ln1_b;
  p.Bm = qkv_w; p.bias = qkv_b; p.out = qkv; p.M = M; p.N = 3 * C; p.K = C;
  launch_gemm<A_LN>(p, stream);

  const cudaError_t e = attention_smem(32, pad_keys(N)) <= SMEM_MAX
                            ? launch_attention<32>(qkv, attn, B, N, C, nh, stream)
                            : launch_attention<16>(qkv, attn, B, N, C, nh, stream);
  if (e != cudaSuccess) return static_cast<int>(e);

  // proj + residual
  p = GemmParams{};
  p.A = attn; p.lda = C; p.Bm = proj_w; p.bias = proj_b; p.resid = x; p.out = y;
  p.M = M; p.N = C; p.K = C;
  launch_gemm<A_PLAIN>(p, stream);

  // LN2 + fc1 + GELU, then fc2 + residual
  vit_row_stats<<<(M + 7) / 8, 256, 0, stream>>>(y, mean, rstd, M, C, eps);
  p = GemmParams{};
  p.A = y; p.lda = C; p.mean = mean; p.rstd = rstd; p.ln_w = ln2_w; p.ln_b = ln2_b;
  p.Bm = fc1_w; p.bias = fc1_b; p.out = hid; p.M = M; p.N = hidden; p.K = C; p.gelu = 1;
  launch_gemm<A_LN>(p, stream);
  p = GemmParams{};
  p.A = hid; p.lda = hidden; p.Bm = fc2_w; p.bias = fc2_b; p.resid = y; p.out = out;
  p.M = M; p.N = C; p.K = hidden;
  launch_gemm<A_PLAIN>(p, stream);
  return static_cast<int>(cudaGetLastError());
}
