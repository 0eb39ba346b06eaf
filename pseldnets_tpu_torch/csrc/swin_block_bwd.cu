// Kernel K3: backward of the training Swin block (drop-path masks, no merge).
//
// Replaces the JAX package's ops/pallas/swin_block_vjp.py::_bwd_kernel (via
// _bwd_call). From the block input x (B, H*W, C) bf16, the masks m (B, 2)
// float32 and the output cotangent dout (B, H*W, C) bf16 it recomputes the
// forward and returns dx (bf16) and float32 gradients of every parameter in
// the kernel layout of K2: LN1/LN2 scale and bias, qkv (q-scale folded, as K2
// reads it), proj, fc1 and fc2 (in, out) weights and biases, and the
// (nh, 64, 64) gathered relative-position bias. Nothing but x is saved by the
// forward.
//
// Numerics follow _bwd_kernel step by step (the plain version
// ops/swin_block_vjp.py::swin_block_backward_plain spells them out): matmul
// operands bf16 with float32 accumulation; LayerNorm, softmax and every grad
// chain in float32; y = x + m0 * proj recomputed in float32; qkv, P, the
// heads, proj, GELU output, the drop-path-scaled cotangents, dS, dqkv, the
// attention-output grad and the window-order input grad rounded to bf16
// where the Pallas kernel rounds them. GELU and its derivative use the exact
// erff (the Pallas bf16 path uses a fast erf, swin_block_vjp.py:143-144).
// The q-scale is folded into the qkv weights, so the q-column gradients come
// out per folded weight; the wrapper multiplies them by the scale.
//
// What bounds it on the H100: per block the forward recompute (24*M*C^2 GEMM
// FLOPs) plus twice that for the backward GEMMs (activation and weight
// grads, 48*M*C^2), and the attention recompute and backward (~16*M*64*C):
// tensor-core work, about 3x K2's. Bytes: x and dout in, dx out, the weights
// and their float32 grads: operations bound it.
//
// Design (correct and simple first): a sequence of __global__ functions
// launched by one C entry point, intermediates through device memory in a
// workspace the wrapper allocates (swin_block_backward_workspace):
//  * ln_rows: LayerNorm forward, one warp per row, in window order (LN1, the
//    bf16 normalized rows are the qkv GEMM's A) or token order (LN2, after
//    y = x + m0 * proj in float32); keeps xhat and 1/sigma per token.
//  * gemm (swin_common.cuh): the recompute GEMMs (qkv, proj scattered back to
//    token order, fc1 with GELU keeping its float32 pre-activation) and the
//    activation-grad GEMMs against the transposed weights (B read as (N, K)),
//    with gelu' folded into the fc2 grad's epilogue.
//  * gemm_tn: weight grads dW = A^T dY, a reduction over the M = B*H*W rows:
//    M is split across blocks that write float32 partial tiles, and
//    reduce_partials sums the partials in a fixed order (no atomics, so every
//    run gives the same bits).
//  * col_sums: bias and LayerNorm grads (column sums of dY, of dH * xhat),
//    row chunks to partials, then the same fixed-order reduction.
//  * ln_bwd_rows: the LayerNorm backward per row plus the residual, and the
//    drop-path scale and window partition of the attention-branch grad.
//  * window_attention_bwd: per (window group, head), P recomputed from q, k,
//    the bias and the shift mask; dV = P^T dO, dP = dO V^T, dS = P (dP -
//    rowsum(dP P)), dq = dS K, dk = dS^T q on WMMA tensor cores (head dim
//    24 zero-padded to 32); each block sums dS over its windows in registers
//    for the bias grad, and the per-block partials are reduced in order.
// Row maps (shift + window partition, window reverse + unshift) are
// window_token index arithmetic, as in K2: no permuted copy of the tokens.
// All but scale_rows live in swin_bwd_common.cuh, shared with K5.

#include "swin_bwd_common.cuh"

namespace {

// out[t] = bf16(m1[image] * dout[t]) over all M * C elements, 8 per thread
__global__ void scale_rows_kernel(const bf16* __restrict__ dout, const float* __restrict__ masks,
                                  bf16* __restrict__ out, long n8, int rowlen) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const long e0 = i * 8;
  const float m1 = masks[2 * (e0 / rowlen) + 1];
  Pack8 v;
  v.u = reinterpret_cast<const uint4*>(dout)[i];
#pragma unroll
  for (int e = 0; e < 8; ++e) v.h[e] = f2bf(m1 * bf2f(v.h[e]));
  reinterpret_cast<uint4*>(out)[i] = v.u;
}

// ---- host side -----------------------------------------------------------

// bytes of float32 partials the reductions need at these shapes
long partial_floats(const Shapes& s) {
  const long M = s.M();
  const int C = s.C, hid = s.hidden;
  long most = 0;
  auto tn = [&](int Ka, int N) {
    const int tiles = ((Ka + 63) / 64) * ((N + 63) / 64);
    const long splits = (M + tn_rows_per_split(M, tiles) - 1) / tn_rows_per_split(M, tiles);
    most = std::max(most, splits * Ka * N);
  };
  tn(hid, C);
  tn(C, hid);
  tn(C, C);
  tn(C, 3 * C);
  const long chunks = (M + COL_CHUNK - 1) / COL_CHUNK;
  most = std::max(most, 2 * chunks * 3 * C);
  most = std::max(most, 2 * chunks * (long)hid);
  most = std::max(most, (long)s.att_groups() * s.nh * WIN_N * WIN_N);
  return most;
}

// the workspace, carved in one order for the size query and the call
struct Workspace {
  bf16 *win, *qkv, *attn, *img2, *h2, *fg, *df2, *df1, *dA, *dattn, *dqkv;
  float *xhat1, *r1, *yhat2, *r2, *f1, *dh2, *dy, *dwin, *dh, *part;
  long bytes;

  Workspace(const Shapes& s, char* base) {
    const long M = s.M();
    const int C = s.C, hid = s.hidden;
    long off = 0;
    auto take = [&](long n, long elem) -> char* {
      char* p = base != nullptr ? base + off : nullptr;
      off += (n * elem + 255) / 256 * 256;
      return p;
    };
    auto bf = [&](long n) { return reinterpret_cast<bf16*>(take(n, 2)); };
    auto fl = [&](long n) { return reinterpret_cast<float*>(take(n, 4)); };
    win = bf(M * C); qkv = bf(M * 3 * C); attn = bf(M * C); img2 = bf(M * C);
    h2 = bf(M * C); fg = bf(M * hid); df2 = bf(M * C); df1 = bf(M * hid);
    dA = bf(M * C); dattn = bf(M * C); dqkv = bf(M * 3 * C);
    xhat1 = fl(M * C); r1 = fl(M); yhat2 = fl(M * C); r2 = fl(M); f1 = fl(M * hid);
    dh2 = fl(M * C); dy = fl(M * C); dwin = fl(M * C); dh = fl(M * C);
    part = fl(partial_floats(s));
    bytes = off;
  }
};

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of workspace swin_block_backward needs at these shapes, into *bytes.
extern "C" int swin_block_backward_workspace(int B, int H, int W, int C, int nh, int win,
                                             int shift, int hidden, long long* bytes) {
  const Shapes s{B, H, W, C, nh, win, shift, hidden};
  *bytes = Workspace(s, nullptr).bytes;
  return 0;
}

// Backward of one training Swin block. Inputs: x, dout (B*H*W, C) bf16;
// masks (B, 2) float32; K2's weights ((in, out) bf16 matrices with the
// q-scale folded into qkv, float32 vectors, bias (nh, 64, 64), shift mask
// (nW, 64, 64) or null). Outputs: dx (B*H*W, C) bf16 and float32 grads
// d_ln1_w/b (C), d_qkv_w (C, 3C), d_qkv_b (3C), d_proj_w (C, C), d_proj_b,
// d_ln2_w/b (C), d_fc1_w (C, hidden), d_fc1_b (hidden), d_fc2_w (hidden, C),
// d_fc2_b (C), d_bias (nh, 64, 64). ws: swin_block_backward_workspace bytes.
extern "C" int swin_block_backward(
    const bf16* x, const bf16* dout, const float* masks, const float* ln1_w, const float* ln1_b,
    const bf16* qkv_w, const float* qkv_b, const bf16* proj_w, const float* proj_b,
    const float* ln2_w, const float* ln2_b, const bf16* fc1_w, const float* fc1_b,
    const bf16* fc2_w, const float* fc2_b, const float* bias, const float* mask, bf16* dx,
    float* d_ln1_w, float* d_ln1_b, float* d_qkv_w, float* d_qkv_b, float* d_proj_w,
    float* d_proj_b, float* d_ln2_w, float* d_ln2_b, float* d_fc1_w, float* d_fc1_b,
    float* d_fc2_w, float* d_fc2_b, float* d_bias, void* ws_base, int B, int H, int W, int C,
    int nh, int win, int shift, int hidden, cudaStream_t stream) {
  const Shapes s{B, H, W, C, nh, win, shift, hidden};
  if (C / nh != HD || C % nh || win * win != WIN_N || C % 32 || hidden % 32 || H % win ||
      W % win)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowMap g{H * W, H, W, win, shift, C};
  const long M = s.M();
  const int rows = static_cast<int>(M);
  const int nW = (H / win) * (W / win);
  Workspace ws(s, static_cast<char*>(ws_base));
  const unsigned row_blocks = (unsigned)((M + 7) / 8);

  // ---- forward recompute
  // LN1 into window order; qkv; attention; proj scattered to token order
  ln_rows_kernel<<<row_blocks, ROW_THREADS, 0, stream>>>(x, nullptr, masks, ln1_w, ln1_b, ws.win,
                                                          ws.xhat1, ws.r1, rows, g, 1);
  GemmParams p{};
  p.g = g;
  p.A = ws.win; p.lda = C; p.Bm = qkv_w; p.bias = qkv_b; p.out = ws.qkv;
  p.M = rows; p.N = 3 * C; p.K = C;
  launch_gemm<A_PLAIN>(p, stream);
  window_attention_kernel<<<dim3(s.n_windows(), nh), ATT_THREADS, 0, stream>>>(
      ws.qkv, bias, mask, ws.attn, C, nW);
  p = GemmParams{};
  p.g = g;
  p.A = ws.attn; p.lda = C; p.Bm = proj_w; p.bias = proj_b; p.out = ws.img2;
  p.M = rows; p.N = C; p.K = C; p.out_window = 1;
  launch_gemm<A_PLAIN>(p, stream);
  // y = x + m0 * proj (float32) -> LN2 (token order); fc1 -> GELU, keeping f1
  ln_rows_kernel<<<row_blocks, ROW_THREADS, 0, stream>>>(x, ws.img2, masks, ln2_w, ln2_b, ws.h2,
                                                          ws.yhat2, ws.r2, rows, g, 0);
  p = GemmParams{};
  p.g = g;
  p.A = ws.h2; p.lda = C; p.Bm = fc1_w; p.bias = fc1_b; p.aux = ws.f1; p.gelu = 1;
  p.out = ws.fg; p.M = rows; p.N = hidden; p.K = C;
  launch_gemm<A_PLAIN>(p, stream);

  // ---- MLP branch
  const long n8 = M * C / 8;
  scale_rows_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, stream>>>(dout, masks, ws.df2, n8,
                                                                       H * W * C);
  // df1 = bf16((df2 fc2_w^T) * gelu'(f1)); dh2 = df1 fc1_w^T (float32)
  p = GemmParams{};
  p.g = g;
  p.A = ws.df2; p.lda = C; p.Bm = fc2_w; p.dgelu = ws.f1; p.out = ws.df1;
  p.M = rows; p.N = hidden; p.K = C;
  launch_gemm<A_PLAIN, true>(p, stream);
  p = GemmParams{};
  p.g = g;
  p.A = ws.df1; p.lda = hidden; p.Bm = fc1_w; p.out_f32 = ws.dh2;
  p.M = rows; p.N = C; p.K = hidden;
  launch_gemm<A_PLAIN, true>(p, stream);
  weight_grad(ws.fg, ws.df2, M, hidden, C, ws.part, d_fc2_w, stream);
  weight_grad(ws.h2, ws.df1, M, C, hidden, ws.part, d_fc1_w, stream);
  col_sums<bf16>(ws.df2, nullptr, M, C, ws.part, d_fc2_b, nullptr, stream);
  col_sums<bf16>(ws.df1, nullptr, M, hidden, ws.part, d_fc1_b, nullptr, stream);
  col_sums<float>(ws.dh2, ws.yhat2, M, C, ws.part, d_ln2_b, d_ln2_w, stream);

  // dy = dout + LN2'(dh2) (token order); dA = bf16(m0 * dy) in window order
  LnBwdParams lb{};
  lb.dh_src = ws.dh2; lb.dh_window = 0; lb.round_dh = 0; lb.xhat = ws.yhat2; lb.rstd = ws.r2;
  lb.w = ln2_w; lb.res_bf16 = dout; lb.out_f32 = ws.dy; lb.scaled_out = ws.dA; lb.masks = masks;
  lb.rows = rows; lb.g = g;
  ln_bwd_rows_kernel<<<row_blocks, ROW_THREADS, 0, stream>>>(lb);

  // ---- attention branch
  weight_grad(ws.attn, ws.dA, M, C, C, ws.part, d_proj_w, stream);
  col_sums<bf16>(ws.dA, nullptr, M, C, ws.part, d_proj_b, nullptr, stream);
  p = GemmParams{};
  p.g = g;
  p.A = ws.dA; p.lda = C; p.Bm = proj_w; p.out = ws.dattn; p.M = rows; p.N = C; p.K = C;
  launch_gemm<A_PLAIN, true>(p, stream);
  const int groups = s.att_groups();
  window_attention_bwd_kernel<<<dim3(groups, nh), ATT_THREADS, 0, stream>>>(
      ws.qkv, ws.dattn, bias, mask, ws.dqkv, ws.part, C, nh, nW, s.n_windows());
  reduce_partials(ws.part, groups, (long)nh * WIN_N * WIN_N, d_bias, stream);
  weight_grad(ws.win, ws.dqkv, M, C, 3 * C, ws.part, d_qkv_w, stream);
  col_sums<bf16>(ws.dqkv, nullptr, M, 3 * C, ws.part, d_qkv_b, nullptr, stream);
  p = GemmParams{};
  p.g = g;
  p.A = ws.dqkv; p.lda = 3 * C; p.Bm = qkv_w; p.out_f32 = ws.dwin;
  p.M = rows; p.N = C; p.K = 3 * C;
  launch_gemm<A_PLAIN, true>(p, stream);

  // dx = dy + LN1'(bf16(dwin) unpartitioned + unshifted)
  lb = LnBwdParams{};
  lb.dh_src = ws.dwin; lb.dh_window = 1; lb.round_dh = 1; lb.dh_copy = ws.dh; lb.xhat = ws.xhat1;
  lb.rstd = ws.r1; lb.w = ln1_w; lb.res_f32 = ws.dy; lb.out_bf16 = dx; lb.masks = masks;
  lb.rows = rows; lb.g = g;
  ln_bwd_rows_kernel<<<row_blocks, ROW_THREADS, 0, stream>>>(lb);
  col_sums<float>(ws.dh, ws.xhat1, M, C, ws.part, d_ln1_b, d_ln1_w, stream);
  return static_cast<int>(cudaGetLastError());
}
