// Kernel K4: the Swin block with AdapterBit bottleneck adapters, forward
// (serving with masks of ones, and training with drop-path masks).
//
// Replaces the JAX package's ops/pallas/swin_block_adapt_vjp.py::_fwd_kernel
// (via _fwd_call: swin_block_adapt_eval and the swin_block_train_adapt
// forward). With s the constant adapter scalar, masks m (B, 2) float32 and a
// the block's attention output after proj, window reverse and unshift (bf16,
// token order):
//   branch = a + s * (gelu(a Wsa1 + bsa1) Wsa2 + bsa2)           (float32)
//   y      = x + m0 * branch                                     (float32)
//   h2     = bf16(LN2(y))
//   mo     = gelu(h2 fc1 + b1) fc2 + b2 + s * (gelu(h2 Wma1 + bma1) Wma2 + bma2)
//   out    = bf16(y + m1 * mo)
// Unlike K2, y stays float32 between the two halves and only out is rounded
// (swin_block_adapt_vjp.py:126-152). GELU outputs, qkv, P, the heads and a are
// rounded to bf16 where the Pallas kernel rounds them; GELU uses the exact
// erff (the Pallas bf16 path uses a fast erf). The spatial adapter is
// row-wise, so it runs on the token-order rows, as the Pallas kernel does
// after its window reverse.
//
// The adapter width is the wrapper's: C * mlp_ratio padded with zero columns
// (Wa1, ba1) and zero rows (Wa2) to a multiple of 32, the GEMM's K step; the
// padded units compute gelu(0) = 0.
//
// What bounds it on the H100: K2's 24 M C^2 GEMM FLOPs and 4 M 64 C of
// attention plus the adapters' 4 M C^2 (two bottlenecks of width C/2, two
// GEMMs each): tensor-core work above the bf16 balance point, so operations.
//
// Design (correct and simple first): K2's device code (swin_common.cuh: the
// LayerNorm-prologue GEMM for qkv, the window attention, proj scattered to
// token order) with the adapters as four more GEMMs, the GEMMs that feed the
// float32 residual writing float32, and two row kernels of its own: the
// float32 residual + LayerNorm that builds y and h2 (swin_adapt_common.cuh)
// and the final residual. Intermediates go through a workspace in device
// memory. K2's source is not touched: its served and training variants
// compile as before.

#include "swin_adapt_common.cuh"

namespace {

// out = bf16(y + m1 * (mo + s * ta)) over n4 groups of 4 float32 elements
__global__ void adapt_output_kernel(const float* __restrict__ y, const float* __restrict__ mo,
                                    const float* __restrict__ ta, const float* __restrict__ masks,
                                    float s, bf16* __restrict__ out, long n4, long image_len) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float m1 = masks[2 * (i * 4 / image_len) + 1];
  const float4 yv = reinterpret_cast<const float4*>(y)[i];
  const float4 mv = reinterpret_cast<const float4*>(mo)[i];
  const float4 tv = reinterpret_cast<const float4*>(ta)[i];
  const float yy[4] = {yv.x, yv.y, yv.z, yv.w}, mm[4] = {mv.x, mv.y, mv.z, mv.w};
  const float tt[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) out[i * 4 + e] = f2bf(yy[e] + m1 * (mm[e] + s * tt[e]));
}

struct FwdWorkspace {
  bf16 *qkv, *attn, *a2d, *gs, *h2, *hid, *hm;
  float *stats, *t, *y, *ta;
  long bytes;

  FwdWorkspace(const AdaptShapes& s, char* base) {
    const long M = s.M();
    const int C = s.C;
    Carver c{base};
    stats = c.fl(2 * M);
    qkv = c.bf(M * 3 * C); attn = c.bf(M * C); a2d = c.bf(M * C); gs = c.bf(M * s.ch);
    h2 = c.bf(M * C); hid = c.bf(M * s.hidden); hm = c.bf(M * s.ch);
    t = c.fl(M * C); y = c.fl(M * C); ta = c.fl(M * C);
    bytes = c.off;
  }
};

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of workspace swin_block_adapt_forward needs at these shapes, into
// *bytes; ch is the padded adapter width.
extern "C" int swin_block_adapt_forward_workspace(int B, int H, int W, int C, int nh, int win,
                                                  int shift, int hidden, int ch,
                                                  long long* bytes) {
  const AdaptShapes s{{B, H, W, C, nh, win, shift, hidden}, ch};
  *bytes = FwdWorkspace(s, nullptr).bytes;
  return 0;
}

// K4: one Swin block with adapters. x (B*H*W, C) bf16; masks (B, 2) float32;
// K2's weights ((in, out) bf16 matrices with the q-scale folded into qkv,
// float32 vectors, bias (nh, 64, 64), shift mask (nW, 64, 64) or null); the
// adapters' (in, out) bf16 matrices sa1 (C, ch), sa2 (ch, C), ma1, ma2 and
// float32 biases; s the adapter scalar. out (B*H*W, C) bf16. ws: the forward
// workspace.
extern "C" int swin_block_adapt_forward(
    const bf16* x, const float* masks, const float* ln1_w, const float* ln1_b, const bf16* qkv_w,
    const float* qkv_b, const bf16* proj_w, const float* proj_b, const float* ln2_w,
    const float* ln2_b, const bf16* fc1_w, const float* fc1_b, const bf16* fc2_w,
    const float* fc2_b, const bf16* sa1_w, const float* sa1_b, const bf16* sa2_w,
    const float* sa2_b, const bf16* ma1_w, const float* ma1_b, const bf16* ma2_w,
    const float* ma2_b, const float* bias, const float* mask, float s, bf16* out, void* ws_base,
    int B, int H, int W, int C, int nh, int win, int shift, int hidden, int ch,
    cudaStream_t stream) {
  const AdaptShapes sh{{B, H, W, C, nh, win, shift, hidden}, ch};
  if (bad_shapes(sh)) return static_cast<int>(cudaErrorInvalidValue);
  const RowMap g{H * W, H, W, win, shift, C};
  const long M = sh.M();
  const int nW = (H / win) * (W / win);
  FwdWorkspace ws(sh, static_cast<char*>(ws_base));
  float* mean = ws.stats;
  float* rstd = ws.stats + M;

  // LN1 moments, qkv of the shifted windows, attention, proj to token order
  launch_stats<0>(x, mean, rstd, static_cast<int>(M), C, g, stream);
  GemmParams p = plain_gemm(g, x, C, qkv_w, 3 * C, M);
  p.mean = mean; p.rstd = rstd; p.ln_w = ln1_w; p.ln_b = ln1_b; p.bias = qkv_b; p.out = ws.qkv;
  p.a_window = 1;
  launch_gemm<A_LN>(p, stream);
  window_attention_kernel<<<dim3(sh.n_windows(), nh), ATT_THREADS, 0, stream>>>(
      ws.qkv, bias, mask, ws.attn, C, nW);
  p = plain_gemm(g, ws.attn, C, proj_w, C, M);
  p.bias = proj_b; p.out = ws.a2d; p.out_window = 1;
  launch_gemm<A_PLAIN>(p, stream);

  // spatial adapter: gs = bf16(gelu(a Wsa1 + b)), t = gs Wsa2 + b (float32)
  p = plain_gemm(g, ws.a2d, C, sa1_w, ch, M);
  p.bias = sa1_b; p.gelu = 1; p.out = ws.gs;
  launch_gemm<A_PLAIN>(p, stream);
  p = plain_gemm(g, ws.gs, ch, sa2_w, C, M);
  p.bias = sa2_b; p.out_f32 = ws.t;
  launch_gemm<A_PLAIN>(p, stream);
  // y = x + m0 (a + s t) (float32), h2 = bf16(LN2(y))
  adapt_residual_ln_kernel<<<(unsigned)row_blocks(M), ROW_THREADS, 0, stream>>>(
      x, ws.a2d, ws.t, masks, s, ln2_w, ln2_b, ws.y, ws.h2, nullptr, nullptr,
      static_cast<int>(M), H * W, C);

  // MLP and MLP adapter: mo = fc2(gelu(fc1 h2)) (into t), ta = ma2(gelu(ma1 h2))
  p = plain_gemm(g, ws.h2, C, fc1_w, hidden, M);
  p.bias = fc1_b; p.gelu = 1; p.out = ws.hid;
  launch_gemm<A_PLAIN>(p, stream);
  p = plain_gemm(g, ws.h2, C, ma1_w, ch, M);
  p.bias = ma1_b; p.gelu = 1; p.out = ws.hm;
  launch_gemm<A_PLAIN>(p, stream);
  p = plain_gemm(g, ws.hid, hidden, fc2_w, C, M);
  p.bias = fc2_b; p.out_f32 = ws.t;
  launch_gemm<A_PLAIN>(p, stream);
  p = plain_gemm(g, ws.hm, ch, ma2_w, C, M);
  p.bias = ma2_b; p.out_f32 = ws.ta;
  launch_gemm<A_PLAIN>(p, stream);
  const long n4 = M * C / 4;
  adapt_output_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      ws.y, ws.t, ws.ta, masks, s, out, n4, (long)H * W * C);
  return static_cast<int>(cudaGetLastError());
}

