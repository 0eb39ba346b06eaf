// Kernel K5: backward of the Swin block with AdapterBit bottleneck adapters
// (training, drop-path masks).
//
// Replaces the JAX package's ops/pallas/swin_block_adapt_vjp.py::_bwd_kernel
// (via _bwd_call, the swin_block_train_adapt backward). From x (B, H*W, C)
// bf16, the masks m (B, 2) float32 and dout (B, H*W, C) bf16 it recomputes
// K4's forward (y in float32) and returns dx (bf16) and float32 grads of every
// block parameter (K3's set, in K2's kernel layout) and of the eight adapter
// tensors (sa1/sa2/ma1/ma2 weights and biases, padded width). Its rounding
// points follow _bwd_kernel (:241-368): df2 = bf16(m1 dout), g2m = bf16(s m1
// dout), df1 = bf16(dfg gelu'), df1m = bf16(dgm gelu'); dh2 = df1 fc1^T +
// df1m Wma1^T in float32; dy = dout + LN2'(dh2); g2s = bf16(s m0 dy), df1s =
// bf16(dgs gelu'); dA = bf16(partition(m0 dy + df1s Wsa1^T)); from there K3's
// attention branch. The fc2 and adapter-fc2 bias grads sum the float32 m1
// dout and s m1 dout, dsa2b the float32 s m0 dy. GELU' uses the exact erff.
//
// What bounds it on the H100: K3's work (the forward recompute, activation
// and weight grads, attention backward; ~64 M C^2 + 16 M 64 C FLOPs) plus the
// adapters' recompute (4 M C^2) and backward (8 M C^2): tensor-core work,
// operations.
//
// Design (correct and simple first): K3's device code (swin_bwd_common.cuh:
// LayerNorm rows, transposed-B GEMMs with GELU' in the epilogue, the split
// weight-grad GEMM with its ordered reduction, column sums, the attention
// backward) with the adapter chains as eight more GEMMs and four row kernels
// of its own: the masked scale of a cotangent (to bf16), the masked column
// sums of the bias grads, a float32 add, and the window partition of the
// attention branch's grad. Weight grads are split partials summed in a fixed
// order, as in K3: runs repeat bit for bit. The frozen backbone's weight
// grads are computed, as the Pallas kernel computes them; skipping them is
// later work. K3's source is not touched.

#include "swin_adapt_common.cuh"

namespace {

// v = m[image][col] * src (bf16 or float32 src); out_a = bf16(v) and, with
// out_b, out_b = bf16(s * v); n8 groups of 8 elements
template <typename T>
__global__ void masked_scale_kernel(const T* __restrict__ src, const float* __restrict__ masks,
                                    int col, float s, bf16* __restrict__ out_a,
                                    bf16* __restrict__ out_b, long n8, long image_len) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float m = masks[2 * (i * 8 / image_len) + col];
  Pack8 pa, pb;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float v;
    if constexpr (std::is_same<T, bf16>::value)
      v = bf2f(src[i * 8 + e]);
    else
      v = src[i * 8 + e];
    v = m * v;
    pa.h[e] = f2bf(v);
    pb.h[e] = f2bf(s * v);
  }
  if (out_a != nullptr) reinterpret_cast<uint4*>(out_a)[i] = pa.u;
  if (out_b != nullptr) reinterpret_cast<uint4*>(out_b)[i] = pb.u;
}

// Partial column sums of s * (m[image][col] * a[r][c]) over chunks of rows;
// one thread per column, rows in order
template <typename T>
__global__ void masked_col_sums_kernel(const T* __restrict__ a, const float* __restrict__ masks,
                                       int col, float s, int L, int M, int N, int rows_per_chunk,
                                       float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int chunk = blockIdx.y;
  if (c >= N) return;
  const int r0 = chunk * rows_per_chunk, r1 = min(M, r0 + rows_per_chunk);
  float sum = 0.f;
  for (int r = r0; r < r1; ++r) {
    float av;
    if constexpr (std::is_same<T, bf16>::value)
      av = bf2f(a[(long)r * N + c]);
    else
      av = a[(long)r * N + c];
    sum += s * (masks[2 * (r / L) + col] * av);
  }
  part[(long)chunk * N + c] = sum;
}

// a[i] += b[i], float32, n4 groups of 4
__global__ void add_f32_kernel(float* __restrict__ a, const float* __restrict__ b, long n4) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 u = reinterpret_cast<float4*>(a)[i];
  const float4 v = reinterpret_cast<const float4*>(b)[i];
  u.x += v.x;
  u.y += v.y;
  u.z += v.z;
  u.w += v.w;
  reinterpret_cast<float4*>(a)[i] = u;
}

// dA[r] = bf16(m0[image] * dy[t] + da[t]) over window-order rows r, t =
// window_token(r): the attention branch's grad at proj, in window order
__global__ void __launch_bounds__(ROW_THREADS) adapt_partition_grad_kernel(
    const float* __restrict__ dy, const float* __restrict__ da, const float* __restrict__ masks,
    bf16* __restrict__ dA, int rows, RowMap g) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int t = window_token(g, r);
  const float m0 = masks[2 * (t / g.L)];
  const long src = (long)t * g.C, dst = (long)r * g.C;
  for (int k = lane; k < g.C; k += 32) dA[dst + k] = f2bf(m0 * dy[src + k] + da[src + k]);
}

// ---- host side -----------------------------------------------------------

template <typename T>
void masked_col_sums(const T* a, const float* masks, int col, float s, const AdaptShapes& sh,
                     int N, float* part, float* out, cudaStream_t stream) {
  const long M = sh.M();
  const int chunks = static_cast<int>((M + COL_CHUNK - 1) / COL_CHUNK);
  masked_col_sums_kernel<T><<<dim3((N + 127) / 128, chunks), 128, 0, stream>>>(
      a, masks, col, s, sh.H * sh.W, static_cast<int>(M), N, COL_CHUNK, part);
  reduce_partials(part, chunks, N, out, stream);
}

// float32 partials the backward's reductions need at these shapes
long adapt_partial_floats(const AdaptShapes& s) {
  const long M = s.M();
  const int C = s.C, hid = s.hidden, ch = s.ch;
  long most = 0;
  auto tn = [&](int Ka, int N) {
    const int rows = tn_rows_per_split(M, ((Ka + 63) / 64) * ((N + 63) / 64));
    most = std::max(most, (M + rows - 1) / rows * Ka * N);
  };
  tn(hid, C);
  tn(C, hid);
  tn(ch, C);
  tn(C, ch);
  tn(C, C);
  tn(C, 3 * C);
  const long chunks = (M + COL_CHUNK - 1) / COL_CHUNK;
  most = std::max(most, 2 * chunks * 3 * C);
  most = std::max(most, 2 * chunks * (long)std::max(hid, ch));
  most = std::max(most, (long)s.att_groups() * s.nh * WIN_N * WIN_N);
  return most;
}

struct BwdWorkspace {
  bf16 *win, *qkv, *attn, *a2d, *gs, *h2, *fg, *gm, *df2, *g2m, *df1, *df1m, *g2s, *df1s, *dA,
      *dattn, *dqkv;
  float *xhat1, *r1, *f1s, *tmp, *yhat2, *r2, *f1, *f1m, *dh2, *dy, *dwin, *dh, *part;
  long bytes;

  BwdWorkspace(const AdaptShapes& s, char* base) {
    const long M = s.M();
    const int C = s.C, hid = s.hidden, ch = s.ch;
    Carver c{base};
    win = c.bf(M * C); qkv = c.bf(M * 3 * C); attn = c.bf(M * C); a2d = c.bf(M * C);
    gs = c.bf(M * ch); h2 = c.bf(M * C); fg = c.bf(M * hid); gm = c.bf(M * ch);
    df2 = c.bf(M * C); g2m = c.bf(M * C); df1 = c.bf(M * hid); df1m = c.bf(M * ch);
    g2s = c.bf(M * C); df1s = c.bf(M * ch); dA = c.bf(M * C); dattn = c.bf(M * C);
    dqkv = c.bf(M * 3 * C);
    xhat1 = c.fl(M * C); r1 = c.fl(M); f1s = c.fl(M * ch); tmp = c.fl(M * C);
    yhat2 = c.fl(M * C); r2 = c.fl(M); f1 = c.fl(M * hid); f1m = c.fl(M * ch);
    dh2 = c.fl(M * C); dy = c.fl(M * C); dwin = c.fl(M * C); dh = c.fl(M * C);
    part = c.fl(adapt_partial_floats(s));
    bytes = c.off;
  }
};

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of workspace swin_block_adapt_backward needs at these shapes, into
// *bytes; ch is the padded adapter width.
extern "C" int swin_block_adapt_backward_workspace(int B, int H, int W, int C, int nh, int win,
                                                   int shift, int hidden, int ch,
                                                   long long* bytes) {
  const AdaptShapes s{{B, H, W, C, nh, win, shift, hidden}, ch};
  *bytes = BwdWorkspace(s, nullptr).bytes;
  return 0;
}

// K5: backward of one Swin block with adapters. Inputs as K4's plus dout
// (B*H*W, C) bf16. Outputs: dx (B*H*W, C) bf16 and float32 grads, K3's
// (d_ln1_w/b (C), d_qkv_w (C, 3C), d_qkv_b (3C), d_proj_w (C, C), d_proj_b,
// d_ln2_w/b, d_fc1_w (C, hidden), d_fc1_b, d_fc2_w (hidden, C), d_fc2_b,
// d_bias (nh, 64, 64)) then the adapters' (d_sa1_w (C, ch), d_sa1_b (ch),
// d_sa2_w (ch, C), d_sa2_b (C), and the same four for ma). ws: the backward
// workspace.
extern "C" int swin_block_adapt_backward(
    const bf16* x, const bf16* dout, const float* masks, const float* ln1_w, const float* ln1_b,
    const bf16* qkv_w, const float* qkv_b, const bf16* proj_w, const float* proj_b,
    const float* ln2_w, const float* ln2_b, const bf16* fc1_w, const float* fc1_b,
    const bf16* fc2_w, const float* fc2_b, const bf16* sa1_w, const float* sa1_b,
    const bf16* sa2_w, const float* sa2_b, const bf16* ma1_w, const float* ma1_b,
    const bf16* ma2_w, const float* ma2_b, const float* bias, const float* mask, float s,
    bf16* dx, float* d_ln1_w, float* d_ln1_b, float* d_qkv_w, float* d_qkv_b, float* d_proj_w,
    float* d_proj_b, float* d_ln2_w, float* d_ln2_b, float* d_fc1_w, float* d_fc1_b,
    float* d_fc2_w, float* d_fc2_b, float* d_bias, float* d_sa1_w, float* d_sa1_b,
    float* d_sa2_w, float* d_sa2_b, float* d_ma1_w, float* d_ma1_b, float* d_ma2_w,
    float* d_ma2_b, void* ws_base, int B, int H, int W, int C, int nh, int win, int shift,
    int hidden, int ch, cudaStream_t stream) {
  const AdaptShapes sh{{B, H, W, C, nh, win, shift, hidden}, ch};
  if (bad_shapes(sh)) return static_cast<int>(cudaErrorInvalidValue);
  const RowMap g{H * W, H, W, win, shift, C};
  const long M = sh.M();
  const int rows = static_cast<int>(M);
  const int nW = (H / win) * (W / win);
  const long image_len = (long)H * W * C;
  BwdWorkspace ws(sh, static_cast<char*>(ws_base));
  const unsigned rb = (unsigned)row_blocks(M);
  const long n8 = M * C / 8;
  const unsigned eb8 = (unsigned)((n8 + 255) / 256);

  // ---- forward recompute
  ln_rows_kernel<<<rb, ROW_THREADS, 0, stream>>>(x, nullptr, masks, ln1_w, ln1_b, ws.win,
                                                 ws.xhat1, ws.r1, rows, g, 1);
  GemmParams p = plain_gemm(g, ws.win, C, qkv_w, 3 * C, M);
  p.bias = qkv_b; p.out = ws.qkv;
  launch_gemm<A_PLAIN>(p, stream);
  window_attention_kernel<<<dim3(sh.n_windows(), nh), ATT_THREADS, 0, stream>>>(
      ws.qkv, bias, mask, ws.attn, C, nW);
  p = plain_gemm(g, ws.attn, C, proj_w, C, M);
  p.bias = proj_b; p.out = ws.a2d; p.out_window = 1;
  launch_gemm<A_PLAIN>(p, stream);
  p = plain_gemm(g, ws.a2d, C, sa1_w, ch, M);
  p.bias = sa1_b; p.aux = ws.f1s; p.gelu = 1; p.out = ws.gs;
  launch_gemm<A_PLAIN>(p, stream);
  p = plain_gemm(g, ws.gs, ch, sa2_w, C, M);
  p.bias = sa2_b; p.out_f32 = ws.tmp;
  launch_gemm<A_PLAIN>(p, stream);
  adapt_residual_ln_kernel<<<rb, ROW_THREADS, 0, stream>>>(
      x, ws.a2d, ws.tmp, masks, s, ln2_w, ln2_b, nullptr, ws.h2, ws.yhat2, ws.r2, rows, H * W, C);
  p = plain_gemm(g, ws.h2, C, fc1_w, hidden, M);
  p.bias = fc1_b; p.aux = ws.f1; p.gelu = 1; p.out = ws.fg;
  launch_gemm<A_PLAIN>(p, stream);
  p = plain_gemm(g, ws.h2, C, ma1_w, ch, M);
  p.bias = ma1_b; p.aux = ws.f1m; p.gelu = 1; p.out = ws.gm;
  launch_gemm<A_PLAIN>(p, stream);

  // ---- MLP branch and MLP adapter
  // df2 = bf16(m1 dout), g2m = bf16(s m1 dout)
  masked_scale_kernel<bf16><<<eb8, 256, 0, stream>>>(dout, masks, 1, s, ws.df2, ws.g2m, n8,
                                                     image_len);
  // df1 = bf16((df2 fc2_w^T) gelu'(f1)); dh2 = df1 fc1_w^T
  p = plain_gemm(g, ws.df2, C, fc2_w, hidden, M);
  p.dgelu = ws.f1; p.out = ws.df1;
  launch_gemm<A_PLAIN, true>(p, stream);
  p = plain_gemm(g, ws.df1, hidden, fc1_w, C, M);
  p.out_f32 = ws.dh2;
  launch_gemm<A_PLAIN, true>(p, stream);
  // df1m = bf16((g2m ma2_w^T) gelu'(f1m)); dh2 += df1m ma1_w^T
  p = plain_gemm(g, ws.g2m, C, ma2_w, ch, M);
  p.dgelu = ws.f1m; p.out = ws.df1m;
  launch_gemm<A_PLAIN, true>(p, stream);
  p = plain_gemm(g, ws.df1m, ch, ma1_w, C, M);
  p.out_f32 = ws.tmp;
  launch_gemm<A_PLAIN, true>(p, stream);
  add_f32_kernel<<<(unsigned)((M * C / 4 + 255) / 256), 256, 0, stream>>>(ws.dh2, ws.tmp,
                                                                          M * C / 4);
  weight_grad(ws.fg, ws.df2, M, hidden, C, ws.part, d_fc2_w, stream);
  weight_grad(ws.h2, ws.df1, M, C, hidden, ws.part, d_fc1_w, stream);
  weight_grad(ws.gm, ws.g2m, M, ch, C, ws.part, d_ma2_w, stream);
  weight_grad(ws.h2, ws.df1m, M, C, ch, ws.part, d_ma1_w, stream);
  masked_col_sums<bf16>(dout, masks, 1, 1.f, sh, C, ws.part, d_fc2_b, stream);
  masked_col_sums<bf16>(dout, masks, 1, s, sh, C, ws.part, d_ma2_b, stream);
  col_sums<bf16>(ws.df1, nullptr, M, hidden, ws.part, d_fc1_b, nullptr, stream);
  col_sums<bf16>(ws.df1m, nullptr, M, ch, ws.part, d_ma1_b, nullptr, stream);
  col_sums<float>(ws.dh2, ws.yhat2, M, C, ws.part, d_ln2_b, d_ln2_w, stream);

  // dy = dout + LN2'(dh2) (float32, token order)
  LnBwdParams lb{};
  lb.dh_src = ws.dh2; lb.dh_window = 0; lb.round_dh = 0; lb.xhat = ws.yhat2; lb.rstd = ws.r2;
  lb.w = ln2_w; lb.res_bf16 = dout; lb.out_f32 = ws.dy; lb.masks = masks;
  lb.rows = rows; lb.g = g;
  ln_bwd_rows_kernel<<<rb, ROW_THREADS, 0, stream>>>(lb);

  // ---- spatial adapter, at dbranch = m0 dy
  // g2s = bf16(s m0 dy); df1s = bf16((g2s sa2_w^T) gelu'(f1s)); da = df1s sa1_w^T
  masked_scale_kernel<float><<<eb8, 256, 0, stream>>>(ws.dy, masks, 0, s, nullptr, ws.g2s, n8,
                                                      image_len);
  p = plain_gemm(g, ws.g2s, C, sa2_w, ch, M);
  p.dgelu = ws.f1s; p.out = ws.df1s;
  launch_gemm<A_PLAIN, true>(p, stream);
  p = plain_gemm(g, ws.df1s, ch, sa1_w, C, M);
  p.out_f32 = ws.tmp;
  launch_gemm<A_PLAIN, true>(p, stream);
  weight_grad(ws.gs, ws.g2s, M, ch, C, ws.part, d_sa2_w, stream);
  weight_grad(ws.a2d, ws.df1s, M, C, ch, ws.part, d_sa1_w, stream);
  masked_col_sums<float>(ws.dy, masks, 0, s, sh, C, ws.part, d_sa2_b, stream);
  col_sums<bf16>(ws.df1s, nullptr, M, ch, ws.part, d_sa1_b, nullptr, stream);
  // dA = bf16(m0 dy + da) in window order
  adapt_partition_grad_kernel<<<rb, ROW_THREADS, 0, stream>>>(ws.dy, ws.tmp, masks, ws.dA, rows,
                                                              g);

  // ---- attention branch (K3's)
  weight_grad(ws.attn, ws.dA, M, C, C, ws.part, d_proj_w, stream);
  col_sums<bf16>(ws.dA, nullptr, M, C, ws.part, d_proj_b, nullptr, stream);
  p = plain_gemm(g, ws.dA, C, proj_w, C, M);
  p.out = ws.dattn;
  launch_gemm<A_PLAIN, true>(p, stream);
  const int groups = sh.att_groups();
  window_attention_bwd_kernel<<<dim3(groups, nh), ATT_THREADS, 0, stream>>>(
      ws.qkv, ws.dattn, bias, mask, ws.dqkv, ws.part, C, nh, nW, sh.n_windows());
  reduce_partials(ws.part, groups, (long)nh * WIN_N * WIN_N, d_bias, stream);
  weight_grad(ws.win, ws.dqkv, M, C, 3 * C, ws.part, d_qkv_w, stream);
  col_sums<bf16>(ws.dqkv, nullptr, M, 3 * C, ws.part, d_qkv_b, nullptr, stream);
  p = plain_gemm(g, ws.dqkv, 3 * C, qkv_w, C, M);
  p.out_f32 = ws.dwin;
  launch_gemm<A_PLAIN, true>(p, stream);

  // dx = dy + LN1'(bf16(dwin) unpartitioned + unshifted)
  lb = LnBwdParams{};
  lb.dh_src = ws.dwin; lb.dh_window = 1; lb.round_dh = 1; lb.dh_copy = ws.dh; lb.xhat = ws.xhat1;
  lb.rstd = ws.r1; lb.w = ln1_w; lb.res_f32 = ws.dy; lb.out_bf16 = dx; lb.masks = masks;
  lb.rows = rows; lb.g = g;
  ln_bwd_rows_kernel<<<rb, ROW_THREADS, 0, stream>>>(lb);
  col_sums<float>(ws.dh, ws.xhat1, M, C, ws.part, d_ln1_b, d_ln1_w, stream);
  return static_cast<int>(cudaGetLastError());
}
