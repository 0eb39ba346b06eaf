// Kernel K2: fused Swin block, with the stage's PatchMerging folded into its
// last block (eval) or per-image drop-path masks (training), for Hopper
// (sm_90a).
//
// Replaces the JAX package's ops/pallas/swin_block.py::swin_block_fused
// (_block_kernel, attn_impl="exact", merge_params, dp_masks). x (B, H*W, C)
// bf16 -> (B, H*W, C), or (B, H*W/4, 2C) with the merge:
//   LN1 -> cyclic shift -> window partition -> qkv (q-scale folded into the
//   weights) -> per-head scores + relative-position bias + shift mask ->
//   max-subtracted float32 softmax -> PV -> proj -> window reverse + unshift
//   -> residual -> LN2 -> fc1 -> exact erf GELU -> fc2 -> residual
//   [-> 2x2 gather (h0,w0) (h1,w0) (h0,w1) (h1,w1) -> LN(4C) -> 4C->2C].
// Matmul operands bf16 with float32 accumulation (tensor cores); LayerNorm and
// softmax in float32; activations rounded to bf16 where the Pallas kernel
// rounds them (LN rows, qkv, probabilities, heads, proj, residual sums, GELU
// output). With drop-path masks m (B, 2) the residual adds are
// x + bf16(m0) * proj and y + bf16(m1) * fc2, each product rounded to bf16
// (swin_block.py:351, :389).
//
// What bounds it on the H100: per block, 24*L*C^2 (+4*L*C^2 with the merge)
// GEMM FLOPs and 4*L*64*C attention FLOPs against ~2*L*C*2 bytes of
// activations in and out: at C = 96..768 that is 100-800 FLOP per byte, above
// the bf16 balance point, so the bound is the tensor-core rate
// (chip_smoke.py::k2_work). The short-K GEMMs of stage 0 (K = C = 96) are
// bound by their epilogues' bytes instead.
//
// Design, on the Hopper forward layer swin_fwd_sm90.cuh (shared with K11):
// one launch a phase, in order on the caller's stream: LN1 rows in window
// order; qkv (TMA-fed, warp-specialised wgmma GEMM, one persistent block of
// 384 threads a SM: a producer warpgroup, of which one thread issues the
// loads, and two consumer warpgroups; no setmaxnreg, which ptxas ignored
// here (C7507) while the consumers fit 168 registers a thread without
// spills at every tile width); the window attention (one warpgroup a (window group,
// head), wgmma with the bias as the scores' initial accumulator); proj with
// the residual stored through the window -> token map; LN2 rows; fc1 with
// GELU; fc2 with the residual; with the merge, its LN rows over the 4C
// gather and the 4C -> 2C GEMM. The GEMMs' tile widths and ring depth are
// the caller's (ops/swin_block.py TILES). Intermediates (LN rows, qkv, the
// attention output, the residual stream, the hidden activations) go through
// device memory; keeping a window's rows on chip from LN1 to fc2 is later
// work.

#include "swin_fwd_sm90.cuh"

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One Swin block (+ PatchMerging when merge_w is not null). Weights are
// (in, out) bf16 matrices and float32 vectors; bias (nh, 64, 64) and mask
// (nW, 64, 64) float32 (mask null when unshifted); dp (B, 2) float32
// drop-path masks or null (not with the merge). Scratch: h (B*L, C) (the
// LN rows; with the merge, its (B*L/4, 4C) rows), qkv (B*L, 3C), attn / y
// (B*L, C), hid (B*L, hidden) bf16. The block output is z (B*L, C), or out
// (B*L/4, 2C) with the merge. Tiles: each GEMM's tile width (64, 128, 192)
// and the ring depth (0: as deep as fits).
extern "C" int swin_block_forward(
    const bf16* x, const float* ln1_w, const float* ln1_b, const bf16* qkv_w,
    const float* qkv_b, const bf16* proj_w, const float* proj_b, const float* ln2_w,
    const float* ln2_b, const bf16* fc1_w, const float* fc1_b, const bf16* fc2_w,
    const float* fc2_b, const float* bias, const float* mask, const float* dp,
    const float* mln_w, const float* mln_b, const bf16* merge_w, bf16* h, bf16* qkv, bf16* attn,
    bf16* y, bf16* hid, bf16* z, bf16* out, int B, int H, int W, int C, int nh, int win,
    int shift, int hidden, int bn_qkv, int bn_proj, int bn_fc1, int bn_fc2, int bn_merge,
    int stages, cudaStream_t stream) {
  const FwdTiles t{bn_qkv, bn_proj, bn_fc1, bn_fc2, bn_merge, stages};
  const bool merge = merge_w != nullptr;
  if (bad_block(H, W, C, nh, win, hidden) || bad_tiles(t) || (dp != nullptr && merge) ||
      (merge && (H % 2 || W % 2 || 4 * C > 8 * 32 * MAX_LN_GROUPS)))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowMap g{H * W, H, W, win, shift, C};
  const int M = B * H * W;
  const int nW = (H / win) * (W / win);
  cudaError_t e = ln_rows_launch<LN_WINDOWS>(x, ln1_w, ln1_b, h, M, g, stream);

  FwdGemm a{};
  a.M = M;
  a.N = 3 * C;
  a.bias = qkv_b;
  a.out = qkv;
  if (e == cudaSuccess) e = fwd_gemm_bn<F_OUT>(t.qkv, h, qkv_w, C, a, t.stages, stream);
  if (e == cudaSuccess) e = attention_launch(qkv, bias, mask, attn, C, nh, nW, B * nW, stream);

  // proj, window reverse + unshift, residual
  a = FwdGemm{};
  a.M = M;
  a.N = C;
  a.bias = proj_b;
  a.out = y;
  a.resid = x;
  a.scale = dp;
  a.map = MAP_WIN_TO_TOK;
  a.g = g;
  if (e == cudaSuccess) e = fwd_gemm_bn<F_RES>(t.proj, attn, proj_w, C, a, t.stages, stream);

  // LN2 + fc1 + GELU, then fc2 + residual
  if (e == cudaSuccess) e = ln_rows_launch<LN_TOKENS>(y, ln2_w, ln2_b, h, M, g, stream);
  a = FwdGemm{};
  a.M = M;
  a.N = hidden;
  a.bias = fc1_b;
  a.gelu = 1;
  a.out = hid;
  if (e == cudaSuccess) e = fwd_gemm_bn<F_OUT>(t.fc1, h, fc1_w, C, a, t.stages, stream);
  a = FwdGemm{};
  a.M = M;
  a.N = C;
  a.bias = fc2_b;
  a.out = z;
  a.resid = y;
  a.scale = dp != nullptr ? dp + 1 : nullptr;
  a.g = g;
  if (e == cudaSuccess) e = fwd_gemm_bn<F_RES>(t.fc2, hid, fc2_w, hidden, a, t.stages, stream);

  if (merge && e == cudaSuccess) {  // PatchMerging: 2x2 gather + LN(4C) + 4C->2C
    e = ln_rows_launch<LN_MERGE>(z, mln_w, mln_b, h, M / 4, g, stream);
    a = FwdGemm{};
    a.M = M / 4;
    a.N = 2 * C;
    a.out = out;
    if (e == cudaSuccess) e = fwd_gemm_bn<F_OUT>(t.merge, h, merge_w, 4 * C, a, t.stages, stream);
  }
  return static_cast<int>(e);
}

// One GEMM form alone, for the tests: out (M, N) = A (M, K) . W (K, N) with
// epilogue epi (0 F_OUT: bias, GELU when gelu; 1 F_RES: bias, the scale of
// image row / L from scale (stride 2) when not null, + resid, the output
// row through the window -> token map of (L, H, W, win, shift) when map)
extern "C" int swin_fwd_gemm(int epi, int bn, int stages, const bf16* A, const bf16* Wt,
                             const float* bias, int gelu, const bf16* resid, const float* scale,
                             bf16* out, int M, int N, int K, int L, int H, int W, int win,
                             int shift, int map, cudaStream_t stream) {
  if (bad_bn(bn) || stages < 0 || stages == 1 || M < 1 || N < 8 || N % 8 || K < 8 || K % 8 ||
      (epi != F_OUT && epi != F_RES) || (epi == F_RES && resid == nullptr) ||
      (map && (win < 1 || H % win || W % win || L != H * W)) ||
      ((map || scale != nullptr) && (L < 1 || M % L)))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdGemm a{};
  a.M = M;
  a.N = N;
  a.bias = bias;
  a.gelu = gelu;
  a.out = out;
  a.resid = resid;
  a.scale = scale;
  a.map = map ? MAP_WIN_TO_TOK : MAP_NONE;
  a.g = RowMap{L, H, W, win, shift, 0};
  const cudaError_t e = epi == F_OUT ? fwd_gemm_bn<F_OUT>(bn, A, Wt, K, a, stages, stream)
                                     : fwd_gemm_bn<F_RES>(bn, A, Wt, K, a, stages, stream);
  return static_cast<int>(e);
}
