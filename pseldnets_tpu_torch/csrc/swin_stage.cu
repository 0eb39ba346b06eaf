// Kernel K11: a whole eval Swin stage (every block of it) in one launch.
//
// Replaces the JAX package's ops/pallas/swin_block.py::swin_stage_fused
// (_stage_kernel, the depth unrolled, any 0/base shift per block) and
// swin_stage_fused_v2 (_stage2_kernel, a grid over depth, shifts 0, s, 0, s):
// both compute the same function. x (B, H*W, C) bf16 -> (B, H*W, C), equal to
// K2 (swin_block.cu) run block after block without the merge fold:
//   per block d: LN1 -> cyclic shift -> window partition -> qkv (q-scale
//   folded into the weights) -> per-head scores + relative-position bias[d]
//   (+ the shift mask when block d is shifted) -> max-subtracted float32
//   softmax -> PV -> proj -> window reverse + unshift -> residual -> LN2 ->
//   fc1 -> exact erf GELU -> fc2 -> residual.
// The numerics are K2's: bf16 matmul operands with float32 accumulation,
// LayerNorm and softmax in float32, activations rounded where K2 rounds
// them. The tile code is K2's own (swin_common.cuh), so the stage computes
// what K2 chained computes.
//
// What bounds it on the H100: K2's work summed over the stage's blocks, 24 L
// C^2 GEMM FLOPs and 4 L 64 C attention FLOPs per block and image, against
// one read and one write of the tokens: above the bf16 balance point at
// every stage width, so the bound is the tensor-core rate.
//
// Design (correct and simple first): one persistent cooperative launch of
// as many blocks of 128 threads as are co-resident on the card
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs). Each CTA loops over
// depth; each Swin block is K2's seven phases, each a grid-stride loop over
// its work items: LN1 moments (a warp per row) -> qkv GEMM tiles (LN
// prologue, shift + window-partition rows) -> (window, head) attention ->
// proj GEMM tiles (window reverse + unshift + residual) -> LN2 moments ->
// fc1 + GELU tiles -> fc2 + residual tiles. A shifted block's windows read
// tokens other CTAs wrote, so a grid barrier (cooperative_groups
// this_grid().sync(), which needs the cooperative launch) separates every
// two phases: 7 per block, less the last. Intermediates go through one
// scratch set (stats, qkv, attn, y, hid) sized for one block and reused over
// depth; the token stream ping-pongs between `out` and `tmp` so that the
// last block lands in `out` and the input x is never written. Keeping a
// window's activations on chip from qkv to fc2 (one CTA per window) is
// later work.

#include <cooperative_groups.h>

#include "swin_common.cuh"

namespace cg = cooperative_groups;

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int STAGE_THREADS = GEMM_THREADS;  // == ATT_THREADS
constexpr int STAGE_WARPS = STAGE_THREADS / 32;
constexpr int MAX_DEPTH = 31;  // block d is shifted when bit d of shift_bits is set

static_assert(GEMM_THREADS == ATT_THREADS, "one block size serves both tile kinds");

struct StageArgs {
  const bf16* x;  // (M, C) stage input, read only
  // depth-stacked weights: (depth, in, out) bf16 matrices, (depth, n) float32 vectors
  const float *ln1_w, *ln1_b;
  const bf16* qkv_w;
  const float* qkv_b;
  const bf16* proj_w;
  const float* proj_b;
  const float *ln2_w, *ln2_b;
  const bf16* fc1_w;
  const float* fc1_b;
  const bf16* fc2_w;
  const float* fc2_b;
  const float* bias;  // (depth, nh, 64, 64)
  const float* mask;  // (nW, 64, 64) of the base shift, or null
  // scratch for one block: stats (2, M) f32; qkv (M, 3C), attn / y (M, C),
  // hid (M, hidden) bf16; tmp (M, C) the other half of the token ping-pong
  float* stats;
  bf16 *qkv, *attn, *y, *hid, *tmp;
  bf16* out;  // (M, C)
  int B, H, W, C, nh, win, base_shift, shift_bits, depth, hidden;
};

union StageSmem {
  GemmSmem<false> gemm;
  AttnSmem attn;
};

__device__ __forceinline__ void stats_phase(const bf16* x, float* mean, float* rstd, int rows,
                                            const RowMap& g) {
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * STAGE_WARPS + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * STAGE_WARPS)
    row_stats_row<0>(x, mean, rstd, row, lane, g.C, g);
}

template <int AMODE>
__device__ __forceinline__ void gemm_phase(const GemmParams& p, GemmSmem<false>& sm) {
  const int tn = (p.N + BN - 1) / BN, tiles = tn * ((p.M + BM - 1) / BM);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    gemm_tile<AMODE, false, false>(p, (t / tn) * BM, (t % tn) * BN, sm);
    __syncthreads();
  }
}

// output buffer of block d: the last block writes `out`, the ones before
// alternate with `tmp`
__device__ __forceinline__ bf16* block_out(const StageArgs& a, int d) {
  return ((a.depth - 1 - d) & 1) ? a.tmp : a.out;
}

__global__ void __launch_bounds__(STAGE_THREADS) swin_stage_kernel(StageArgs a) {
  __shared__ StageSmem sm;
  cg::grid_group grid = cg::this_grid();
  const int L = a.H * a.W, M = a.B * L, C = a.C, hid = a.hidden;
  const int nW = (a.H / a.win) * (a.W / a.win), n_win = a.B * nW;
  float* mean = a.stats;
  float* rstd = a.stats + M;

  for (int d = 0; d < a.depth; ++d) {
    const int shift = ((a.shift_bits >> d) & 1) ? a.base_shift : 0;
    const RowMap g{L, a.H, a.W, a.win, shift, C};
    const bf16* xin = d == 0 ? a.x : block_out(a, d - 1);
    bf16* xout = block_out(a, d);

    // LN1 moments per token, then qkv of the shifted windows
    stats_phase(xin, mean, rstd, M, g);
    grid.sync();
    GemmParams p{};
    p.g = g;
    p.A = xin; p.lda = C; p.mean = mean; p.rstd = rstd;
    p.ln_w = a.ln1_w + (long)d * C; p.ln_b = a.ln1_b + (long)d * C;
    p.Bm = a.qkv_w + (long)d * C * 3 * C; p.bias = a.qkv_b + (long)d * 3 * C;
    p.out = a.qkv; p.M = M; p.N = 3 * C; p.K = C; p.a_window = 1;
    gemm_phase<A_LN>(p, sm.gemm);
    grid.sync();

    // window attention, one (window, head) per item
    const float* bias = a.bias + (long)d * a.nh * WIN_N * WIN_N;
    const float* mask = shift ? a.mask : nullptr;
    for (int t = blockIdx.x; t < n_win * a.nh; t += gridDim.x) {
      window_attention_tile(a.qkv, bias, mask, a.attn, C, nW, t % n_win, t / n_win, sm.attn);
      __syncthreads();
    }
    grid.sync();

    // proj, window reverse + unshift, residual
    p = GemmParams{};
    p.g = g;
    p.A = a.attn; p.lda = C; p.Bm = a.proj_w + (long)d * C * C; p.bias = a.proj_b + (long)d * C;
    p.resid = xin; p.out = a.y; p.M = M; p.N = C; p.K = C; p.out_window = 1;
    gemm_phase<A_PLAIN>(p, sm.gemm);
    grid.sync();

    // LN2 + fc1 + GELU, then fc2 + residual
    stats_phase(a.y, mean, rstd, M, g);
    grid.sync();
    p = GemmParams{};
    p.g = g;
    p.A = a.y; p.lda = C; p.mean = mean; p.rstd = rstd;
    p.ln_w = a.ln2_w + (long)d * C; p.ln_b = a.ln2_b + (long)d * C;
    p.Bm = a.fc1_w + (long)d * C * hid; p.bias = a.fc1_b + (long)d * hid;
    p.out = a.hid; p.M = M; p.N = hid; p.K = C; p.gelu = 1;
    gemm_phase<A_LN>(p, sm.gemm);
    grid.sync();
    p = GemmParams{};
    p.g = g;
    p.A = a.hid; p.lda = hid; p.Bm = a.fc2_w + (long)d * hid * C; p.bias = a.fc2_b + (long)d * C;
    p.resid = a.y; p.out = xout; p.M = M; p.N = C; p.K = hid;
    gemm_phase<A_PLAIN>(p, sm.gemm);
    if (d + 1 < a.depth) grid.sync();
  }
}

}  // namespace

// One eval Swin stage of `depth` blocks. Weights depth-stacked: ln*/proj_b/
// fc2_b (depth, C), qkv_b (depth, 3C), fc1_b (depth, hidden) float32; qkv_w
// (depth, C, 3C), proj_w (depth, C, C), fc1_w (depth, C, hidden), fc2_w
// (depth, hidden, C) bf16; bias (depth, nh, 64, 64) and mask (nW, 64, 64)
// float32 (mask null when no block is shifted). Block d is shifted by
// base_shift when bit d of shift_bits is set. Scratch as in StageArgs. One
// cooperative launch; a launch the card refuses returns its error.
extern "C" int swin_stage_forward(
    const bf16* x, const float* ln1_w, const float* ln1_b, const bf16* qkv_w,
    const float* qkv_b, const bf16* proj_w, const float* proj_b, const float* ln2_w,
    const float* ln2_b, const bf16* fc1_w, const float* fc1_b, const bf16* fc2_w,
    const float* fc2_b, const float* bias, const float* mask, float* stats, bf16* qkv,
    bf16* attn, bf16* y, bf16* hid, bf16* tmp, bf16* out, int B, int H, int W, int C,
    int nh, int win, int base_shift, int shift_bits, int depth, int hidden,
    cudaStream_t stream) {
  if (C / nh != HD || C % nh || win * win != WIN_N || H % win || W % win || C % 32 ||
      hidden % 32 || depth < 1 || depth > MAX_DEPTH ||
      (shift_bits >> depth) != 0 || (shift_bits != 0 && (mask == nullptr || base_shift <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const StageArgs a{x, ln1_w, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_w, ln2_b,
                    fc1_w, fc1_b, fc2_w, fc2_b, bias, mask, stats, qkv, attn, y, hid, tmp, out,
                    B, H, W, C, nh, win, base_shift, shift_bits, depth, hidden};
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, swin_stage_kernel, STAGE_THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {const_cast<StageArgs*>(&a)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(swin_stage_kernel),
                                  dim3(per_sm * sms), dim3(STAGE_THREADS), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
