// Kernel K11: a whole eval Swin stage (every block of it) in one launch, for
// Hopper (sm_90a).
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
// The numerics are K2's, and so are the bits: the phases are K2's own
// __device__ bodies (swin_fwd_sm90.cuh) with K2's tile widths, so each
// block computes what K2 computes on the same input.
//
// What bounds it on the H100: K2's work summed over the stage's blocks, 24 L
// C^2 GEMM FLOPs and 4 L 64 C attention FLOPs per block and image, against
// one read and one write of the tokens: above the bf16 balance point at
// every stage width, so the bound is the tensor-core rate.
//
// Design: one persistent cooperative launch, one block of 384 threads (three
// warpgroups) a SM (about 200 KB of shared memory each;
// cudaOccupancyMaxActiveBlocksPerMultiprocessor with that memory must give
// at least one, or the launch is refused). Each block loops over depth; each
// Swin block is K2's seven phases, each walking its work items from the
// block's index with the grid's stride: LN1 rows (a warp a row, 12 a block)
// -> qkv tiles -> (window group, head) attention items (each warpgroup one,
// in its own part of the ring's memory) -> proj tiles (residual through the
// window -> token map) -> LN2 rows -> fc1 + GELU tiles -> fc2 + residual
// tiles. The GEMM tiles take K2's roles: warpgroups 0 and 1 consume,
// thread 256 feeds the ring. Phases read rows other blocks wrote, so a grid
// barrier (cooperative_groups this_grid().sync(), after a proxy fence: TMA
// reads through the async proxy what the row passes and epilogues stored)
// separates every two phases: 7 per block, less the last. The ring's
// mbarriers are initialised once and each role's position in it carries
// from one GEMM to the next; its stages are sized for the widest tile of
// the stage (64 or 128: at 192 the accumulators spill beside the stage's
// loop state). The block gets 168 registers a thread; the row passes run
// as a function of their own (inlined, their unrolled rows spilled).
// Intermediates go through one scratch set (h, qkv, attn, y, hid) sized for
// one block and reused over depth; the token stream ping-pongs between
// `out` and `tmp` so that the last block lands in `out` and the input x is
// never written.

#include <cooperative_groups.h>

#include "swin_fwd_sm90.cuh"

namespace cg = cooperative_groups;

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int MAX_DEPTH = 31;  // block d is shifted when bit d of shift_bits is set
// three warpgroups: all run the rows and the attention; in the GEMMs,
// warpgroups 0 and 1 consume and thread 256 feeds the ring, as in K2 (with
// thread 0 feeding between its own waits instead, in a block of two
// warpgroups, the GEMM phases took 2.3x K2's on an H100)
constexpr int STAGE_THREADS = 384;
constexpr int STAGE_WARPS = STAGE_THREADS / 32;
constexpr int ATT_SLOTS = 3;  // attention items in flight a block (one a warpgroup)

// a GEMM phase, K2's roles (widths 64 and 128)
template <int EPI>
__device__ __forceinline__ void gemm_phase(int bn, const CUtensorMap* ta, const CUtensorMap* tw,
                                           const FwdGemm& a, Ring& r, uint32_t stg) {
  if (threadIdx.x >= 256) {
    if (threadIdx.x != 256) return;
    if (bn == 64)
      gemm_produce<64>(ta, tw, a, r, blockIdx.x, gridDim.x);
    else
      gemm_produce<128>(ta, tw, a, r, blockIdx.x, gridDim.x);
    return;
  }
  if (bn == 64)
    gemm_consume<64, EPI>(a, r, stg, blockIdx.x, gridDim.x);
  else
    gemm_consume<128, EPI>(a, r, stg, blockIdx.x, gridDim.x);
}

// TMA maps: the activations read as GEMM A (h: LN rows, attn, hid) and the
// depth-stacked weights (depth, K, N) as 3-D maps
struct StageMaps {
  CUtensorMap h, attn, hid, qkv_w, proj_w, fc1_w, fc2_w;
};

struct StageArgs {
  const bf16* x;  // (M, C) stage input, read only
  // depth-stacked float32 vectors (depth, n)
  const float *ln1_w, *ln1_b, *qkv_b, *proj_b, *ln2_w, *ln2_b, *fc1_b, *fc2_b;
  const float* bias;  // (depth, nh, 64, 64)
  const float* mask;  // (nW, 64, 64) of the base shift, or null
  // scratch for one block: h (M, C) the LN rows, qkv (M, 3C), attn / y (M,
  // C), hid (M, hidden) bf16; tmp (M, C) the other half of the token
  // ping-pong
  bf16 *h, *qkv, *attn, *y, *hid, *tmp;
  bf16* out;  // (M, C)
  int B, H, W, C, nh, win, base_shift, shift_bits, depth, hidden;
  FwdTiles t;
  int S, stage_bytes, stg_bytes, att_groups;  // the shared-memory layout
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// the row passes as a function of their own: inlined beside the rest of
// the stage, their unrolled rows spilled
template <int MODE>
__device__ __noinline__ void ln_phase(const bf16* x, const float* w, const float* b, bf16* h,
                                      int rows, RowMap g) {
  ln_rows_any<MODE>(x, w, b, h, rows, g, blockIdx.x * STAGE_WARPS + threadIdx.x / 32,
                    gridDim.x * STAGE_WARPS);
}

// output buffer of block d: the last block writes `out`, the ones before
// alternate with `tmp`
__device__ __forceinline__ bf16* block_out(const StageArgs& a, int d) {
  return ((a.depth - 1 - d) & 1) ? a.tmp : a.out;
}

__global__ void __launch_bounds__(STAGE_THREADS, 1)
    swin_stage_kernel(const __grid_constant__ StageMaps maps, const StageArgs a) {
  extern __shared__ unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t stg = base + a.S * a.stage_bytes;
  const uint32_t full = stg + a.stg_bytes, empty = full + 8 * a.S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  Ring r{base, static_cast<uint32_t>(a.stage_bytes), full, empty, a.S, 0, 0};
  const int L = a.H * a.W, M = a.B * L, C = a.C, hid = a.hidden, nh = a.nh;
  const int nW = (a.H / a.win) * (a.W / a.win);
  // every thread's stores before the barrier reach the next phase's TMA
  // loads (async proxy) and plain loads
  auto barrier = [&]() {
    fence_proxy_async();
    grid.sync();
  };
  // the GEMMs of block d: M, N, k-blocks and W's depth; returns the tile
  // width (K2's at this shape)
  auto gemm = [&](int d, int which, FwdGemm& p) -> int {
    p.M = M;
    p.wd = d;
    p.kb = (C + FW_BK - 1) / FW_BK;
    switch (which) {
      case 0: p.N = 3 * C; return a.t.qkv;
      case 1: p.N = C; return a.t.proj;
      case 2: p.N = hid; return a.t.fc1;
      default: p.N = C; p.kb = (hid + FW_BK - 1) / FW_BK; return a.t.fc2;
    }
  };
  const int slot = threadIdx.x / ATT_THREADS;
  for (int d = 0; d < a.depth; ++d) {
    const int shift = ((a.shift_bits >> d) & 1) ? a.base_shift : 0;
    const RowMap g{L, a.H, a.W, a.win, shift, C};
    const bf16* xin = d == 0 ? a.x : block_out(a, d - 1);
    bf16* xout = block_out(a, d);

    // LN1 rows in window order, then qkv
    ln_phase<LN_WINDOWS>(xin, a.ln1_w + (long)d * C, a.ln1_b + (long)d * C, a.h, M, g);
    barrier();
    FwdGemm p{};
    int bn = gemm(d, 0, p);
    p.bias = a.qkv_b + (long)d * 3 * C;
    p.out = a.qkv;
    gemm_phase<F_OUT>(bn, &maps.h, &maps.qkv_w, p, r, stg);
    barrier();

    // window attention, each warpgroup in its own part of the ring's memory
    attention_items(a.qkv, a.bias + (long)d * nh * WIN_N * WIN_N, shift ? a.mask : nullptr,
                    a.attn, C, nW, a.B * nW, a.att_groups, nh, base + slot * AttFwdSmem::END,
                    blockIdx.x * ATT_SLOTS + slot, gridDim.x * ATT_SLOTS, 1 + slot);
    fence_async_shared();  // the next GEMM's TMA loads overwrite these tiles
    barrier();

    // proj, window reverse + unshift, residual
    p = FwdGemm{};
    bn = gemm(d, 1, p);
    p.bias = a.proj_b + (long)d * C;
    p.out = a.y;
    p.resid = xin;
    p.map = MAP_WIN_TO_TOK;
    p.g = g;
    gemm_phase<F_RES>(bn, &maps.attn, &maps.proj_w, p, r, stg);
    barrier();

    // LN2 rows, fc1 + GELU, then fc2 + residual
    ln_phase<LN_TOKENS>(a.y, a.ln2_w + (long)d * C, a.ln2_b + (long)d * C, a.h, M, g);
    barrier();
    p = FwdGemm{};
    bn = gemm(d, 2, p);
    p.bias = a.fc1_b + (long)d * hid;
    p.gelu = 1;
    p.out = a.hid;
    gemm_phase<F_OUT>(bn, &maps.h, &maps.fc1_w, p, r, stg);
    barrier();
    p = FwdGemm{};
    bn = gemm(d, 3, p);
    p.bias = a.fc2_b + (long)d * C;
    p.out = xout;
    p.resid = a.y;
    p.g = g;
    gemm_phase<F_RES>(bn, &maps.hid, &maps.fc2_w, p, r, stg);
    if (d + 1 < a.depth) barrier();
  }
}

}  // namespace

// One eval Swin stage of `depth` blocks. Weights depth-stacked: ln*/proj_b/
// fc2_b (depth, C), qkv_b (depth, 3C), fc1_b (depth, hidden) float32; qkv_w
// (depth, C, 3C), proj_w (depth, C, C), fc1_w (depth, C, hidden), fc2_w
// (depth, hidden, C) bf16; bias (depth, nh, 64, 64) and mask (nW, 64, 64)
// float32 (mask null when no block is shifted). Block d is shifted by
// base_shift when bit d of shift_bits is set. Scratch as in StageArgs.
// Tiles: K2's tile widths of qkv, proj, fc1, fc2 at this shape (so the
// stage gives K2's bits; 64 or 128) and the ring depth (0: as deep as
// fits). One
// cooperative launch; a launch the card refuses returns its error.
extern "C" int swin_stage_forward(
    const bf16* x, const float* ln1_w, const float* ln1_b, const bf16* qkv_w,
    const float* qkv_b, const bf16* proj_w, const float* proj_b, const float* ln2_w,
    const float* ln2_b, const bf16* fc1_w, const float* fc1_b, const bf16* fc2_w,
    const float* fc2_b, const float* bias, const float* mask, bf16* h, bf16* qkv, bf16* attn,
    bf16* y, bf16* hid, bf16* tmp, bf16* out, int B, int H, int W, int C, int nh, int win,
    int base_shift, int shift_bits, int depth, int hidden, int bn_qkv, int bn_proj, int bn_fc1,
    int bn_fc2, int stages, cudaStream_t stream) {
  const FwdTiles t{bn_qkv, bn_proj, bn_fc1, bn_fc2, 64, stages};
  if (bad_block(H, W, C, nh, win, hidden) || bad_tiles(t) || depth < 1 || depth > MAX_DEPTH ||
      std::max(std::max(bn_qkv, bn_proj), std::max(bn_fc1, bn_fc2)) > 128 ||
      (shift_bits >> depth) != 0 || (shift_bits != 0 && (mask == nullptr || base_shift <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  // shared memory: the ring for the widest tile, its staged rows, the barriers
  const int bn = std::max(std::max(bn_qkv, bn_proj), std::max(bn_fc1, bn_fc2));
  const int stage_bytes = FW_A_BYTES + bn * FW_BK * 2;
  const int stg_bytes = 2048 + 2 * 64 * (bn * 2 + 16);  // FwdStage<bn>::BYTES
  int S = std::min(6, (FW_RING_BUDGET - stg_bytes) / stage_bytes);
  if (stages > 0) S = std::min(S, stages);
  if (S * stage_bytes < ATT_SLOTS * AttFwdSmem::END) S = (ATT_SLOTS * AttFwdSmem::END +
                                                          stage_bytes - 1) / stage_bytes;
  const int smem = S * stage_bytes + stg_bytes + 16 * S + 1024;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(swin_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, swin_stage_kernel, STAGE_THREADS,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = per_sm * sms;

  const long M = (long)B * H * W;
  StageMaps maps;
  e = tmap(&maps.h, h, M, C, FW_BM);
  if (e == cudaSuccess) e = tmap(&maps.attn, attn, M, C, FW_BM);
  if (e == cudaSuccess) e = tmap(&maps.hid, hid, M, hidden, FW_BM);
  if (e == cudaSuccess) e = tmap_w3(&maps.qkv_w, qkv_w, depth, C, 3 * C);
  if (e == cudaSuccess) e = tmap_w3(&maps.proj_w, proj_w, depth, C, C);
  if (e == cudaSuccess) e = tmap_w3(&maps.fc1_w, fc1_w, depth, C, hidden);
  if (e == cudaSuccess) e = tmap_w3(&maps.fc2_w, fc2_w, depth, hidden, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_windows = B * (H / win) * (W / win);
  // (window group, head) items: about one per warpgroup of the grid
  const int groups = std::max(1, std::min(n_windows, (ATT_SLOTS * grid + nh - 1) / nh));
  const StageArgs a{x, ln1_w, ln1_b, qkv_b, proj_b, ln2_w, ln2_b, fc1_b, fc2_b, bias, mask,
                    h, qkv, attn, y, hid, tmp, out, B, H, W, C, nh, win, base_shift,
                    shift_bits, depth, hidden, t, S, stage_bytes, stg_bytes, groups};
  void* args[] = {&maps, const_cast<StageArgs*>(&a)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(swin_stage_kernel), dim3(grid),
                                  dim3(STAGE_THREADS), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
