// Kernel K2: fused Swin transformer block, with the stage's PatchMerging
// folded into its last block (eval) or per-image drop-path masks (training).
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
// rounds them (qkv, probabilities, heads, proj, residual sums, GELU output).
// With drop-path masks m (B, 2) the residual adds are x + bf16(m0) * proj and
// y + bf16(m1) * fc2, each product rounded to bf16 (swin_block.py:351, :389).
//
// What bounds it on the H100: per block, 24*L*C^2 (+4*L*C^2 with the merge)
// GEMM FLOPs and 4*L*64*C attention FLOPs against ~2*L*C*2 bytes of
// activations in and out: at C = 96..768 that is 100-800 FLOP per byte, above
// the bf16 balance point, so the bound is the tensor-core rate.
//
// Design (correct and simple first): a few __global__ functions launched in
// sequence by one C entry point.
//  * row_stats: LayerNorm moments (two-pass, float32), one warp per row, over
//    a token row or over the 4C gather of a merged row.
//  * gemm: a 64x64x32 bf16 WMMA tile GEMM (4 warps, 32x32 each) whose A
//    loader applies the LayerNorm (prologue) and whose row addressing does
//    the shift + window partition or the 2x2 merge gather; the epilogue adds
//    the bias, applies GELU, rounds, scales by the image's mask, adds the
//    residual and scatters rows back through the window reverse + unshift.
// The device code lives in swin_common.cuh, shared with the backward K3.
//  * window_attention: one block of 4 warps per (window, head); Q, K, V
//    (head dim 24 zero-padded to 32, the tensor-core tile width) and the
//    bias (+ mask) in shared memory; S = bias + Q K^T and O = P V on the
//    tensor cores, the float32 softmax between them warp-local.
// Intermediates (qkv, attention output, the residual stream, the hidden
// activations) go through device memory. The Pallas kernel's one read and
// one write of the tokens per block (everything else in VMEM), and wgmma/TMA
// pipelining, are later work.

#include "swin_common.cuh"

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One eval Swin block (+ PatchMerging when merge_w is not null). Weights are
// (in, out) bf16 matrices and float32 vectors; bias (nh, 64, 64) and mask
// (nW, 64, 64) float32 (mask null when unshifted); dp (B, 2) float32
// drop-path masks or null (not with the merge). Scratch: stats (2, B*L)
// f32, qkv (B*L, 3C), attn / y / z (B*L, C), hid (B*L, hidden) bf16. The
// block output is z, or out (B*L/4, 2C) with the merge.
extern "C" int swin_block_forward(
    const bf16* x, const float* ln1_w, const float* ln1_b, const bf16* qkv_w,
    const float* qkv_b, const bf16* proj_w, const float* proj_b, const float* ln2_w,
    const float* ln2_b, const bf16* fc1_w, const float* fc1_b, const bf16* fc2_w,
    const float* fc2_b, const float* bias, const float* mask, const float* dp,
    const float* mln_w,
    const float* mln_b, const bf16* merge_w, float* stats, bf16* qkv, bf16* attn,
    bf16* y, bf16* hid, bf16* z, bf16* out, int B, int H, int W, int C, int nh,
    int win, int shift, int hidden, cudaStream_t stream) {
  const RowMap g{H * W, H, W, win, shift, C};
  const int M = B * H * W, hd = C / nh;
  const int nW = (H / win) * (W / win);
  float* mean = stats;
  float* rstd = stats + M;

  // LN1 moments per token, then qkv of the shifted windows
  launch_stats<0>(x, mean, rstd, M, C, g, stream);
  GemmParams p{};
  p.g = g;
  p.A = x; p.lda = C; p.mean = mean; p.rstd = rstd; p.ln_w = ln1_w; p.ln_b = ln1_b;
  p.Bm = qkv_w; p.bias = qkv_b; p.out = qkv; p.M = M; p.N = 3 * C; p.K = C;
  p.a_window = 1;
  launch_gemm<A_LN>(p, stream);

  if (hd != HD || (dp != nullptr && merge_w != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  window_attention_kernel<<<dim3(B * nW, nh), ATT_THREADS, 0, stream>>>(qkv, bias, mask, attn, C, nW);

  // proj, window reverse + unshift, residual
  p = GemmParams{};
  p.g = g;
  p.A = attn; p.lda = C; p.Bm = proj_w; p.bias = proj_b; p.resid = x; p.out = y;
  p.rscale = dp;
  p.M = M; p.N = C; p.K = C; p.out_window = 1;
  launch_gemm<A_PLAIN>(p, stream);

  // LN2 + fc1 + GELU, then fc2 + residual
  launch_stats<0>(y, mean, rstd, M, C, g, stream);
  p = GemmParams{};
  p.g = g;
  p.A = y; p.lda = C; p.mean = mean; p.rstd = rstd; p.ln_w = ln2_w; p.ln_b = ln2_b;
  p.Bm = fc1_w; p.bias = fc1_b; p.out = hid; p.M = M; p.N = hidden; p.K = C; p.gelu = 1;
  launch_gemm<A_LN>(p, stream);
  p = GemmParams{};
  p.g = g;
  p.A = hid; p.lda = hidden; p.Bm = fc2_w; p.bias = fc2_b; p.resid = y; p.out = z;
  p.rscale = dp != nullptr ? dp + 1 : nullptr;
  p.M = M; p.N = C; p.K = hidden;
  launch_gemm<A_PLAIN>(p, stream);

  if (merge_w != nullptr) {  // PatchMerging: 2x2 gather + LN(4C) + 4C->2C
    launch_stats<1>(z, mean, rstd, M / 4, 4 * C, g, stream);
    p = GemmParams{};
    p.g = g;
    p.A = z; p.lda = C; p.mean = mean; p.rstd = rstd; p.ln_w = mln_w; p.ln_b = mln_b;
    p.Bm = merge_w; p.out = out; p.M = M / 4; p.N = 2 * C; p.K = 4 * C;
    launch_gemm<A_MERGE>(p, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
