// Kernel K5: backward of the Swin block with AdapterBit bottleneck adapters
// (training, drop-path masks), for Hopper (sm_90a).
//
// Replaces the JAX package's ops/pallas/swin_block_adapt_vjp.py::_bwd_kernel
// (via _bwd_call, the swin_block_train_adapt backward). From x (B, H*W, C)
// bf16, the masks m (B, 2) float32 and dout (B, H*W, C) bf16 it recomputes
// K4's forward (y in float32) and returns dx (bf16) and float32 grads of the
// block parameters (K3's set, in K2's kernel layout) and of the eight
// adapter tensors (sa1/sa2/ma1/ma2 weights and biases, padded width). A null
// grad pointer is a grad not wanted: AdapterBit training trains only biases
// and adapters (train/optim.py::trainable_mask), so its backward skips the
// frozen weights' four weight-grad GEMMs, the LayerNorm-scale sums and the
// bias-table sums. Its rounding points follow _bwd_kernel (:241-368): df2 =
// bf16(m1 dout), g2m = bf16(s m1 dout), df1 = bf16(dfg gelu'), df1m =
// bf16(dgm gelu'); dh2 = df1 fc1^T + df1m Wma1^T in float32; dy = dout +
// LN2'(dh2); g2s = bf16(s m0 dy), df1s = bf16(dgs gelu'); dA = bf16(partition(
// m0 dy + df1s Wsa1^T)); from there K3's attention branch. The fc2 and
// adapter-fc2 bias grads sum the float32 m1 dout and s m1 dout, dsa2b the
// float32 s m0 dy. GELU' uses the exact erff.
//
// What bounds it on the H100: K3's work plus the adapters' recompute and
// backward (24 M C ch FLOPs at width ch): operations (chip_smoke.py::
// k5_work); the training form without the frozen weight grads does 24 M C^2
// less (k5_work's masked form).
//
// Design: K3's (swin_block_bwd.cu), on the same Hopper layer
// (swin_bwd_sm90.cuh), with the adapter chains folded into it: the spatial
// adapter's recompute (sa1 with GELU, sa2 in float32) feeds LN2's y; the MLP
// adapter runs as a second DUAL GEMM beside fc1/fc2 (gm and df1m, no float32
// pre-activation) and shares dh2's GEMM with fc1 (CAT: two K ranges into one
// accumulator); scale_rows writes df2 and g2m together; LN2's backward
// writes g2s; the spatial adapter's backward is a DUAL GEMM (df1s) and an NT
// GEMM whose epilogue adds m0 dy and stores dA through the token -> window
// map with proj_b's sums. 27 launches a block (23 in the training form).

#include "swin_bwd_sm90.cuh"

namespace {

bool bad_shapes(const BwdShapes& s) {
  return s.C / s.nh != HD || s.C % s.nh || s.win * s.win != WIN_N || s.C % 32 || s.C > 768 ||
         s.hidden % 32 || s.ch % 32 || s.ch <= 0 || s.H % s.win || s.W % s.win;
}

struct K5Work {
  bf16 *h1, *qkv, *attn, *a, *gs, *h2, *df2, *g2m, *fg, *df1, *gm, *df1m, *g2s, *df1s, *dA,
      *dattn, *dqkv, *dh;
  float2 *st1, *st2;
  float *t, *dh2, *dy;
  float *p_fc2b, *p_ma2b, *p_fc1b, *p_ma1b, *p_ln2b, *p_ln2w, *p_sa2b, *p_sa1b, *p_projb,
      *p_qkvb, *p_bias, *p_ln1b, *p_ln1w;
  WGrad w_fc2, w_fc1, w_ma2, w_ma1, w_sa2, w_sa1, w_proj, w_qkv;
  long bytes;

  K5Work(const BwdShapes& s, const BwTiles& tl, char* base) {
    const long M = s.M();
    const int C = s.C, hid = s.hidden, ch = s.ch, rg = row_grid(M);
    const int groups = att_groups(s.n_windows(), s.nh);
    const long mt = (M + BW_BM - 1) / BW_BM;
    Carver c{base};
    h1 = c.bf(M * C); qkv = c.bf(M * 3 * C); attn = c.bf(M * C); a = c.bf(M * C);
    gs = c.bf(M * ch); h2 = c.bf(M * C); df2 = c.bf(M * C); g2m = c.bf(M * C);
    fg = c.bf(M * hid); df1 = c.bf(M * hid); gm = c.bf(M * ch); df1m = c.bf(M * ch);
    g2s = c.bf(M * C); df1s = c.bf(M * ch); dA = c.bf(M * C); dattn = c.bf(M * C);
    dqkv = c.bf(M * 3 * C); dh = c.bf(M * C);
    st1 = reinterpret_cast<float2*>(c.fl(2 * M));
    st2 = reinterpret_cast<float2*>(c.fl(2 * M));
    t = c.fl(M * C); dh2 = c.fl(M * C); dy = c.fl(M * C);
    p_fc2b = c.fl((long)rg * C); p_ma2b = c.fl((long)rg * C);
    p_fc1b = c.fl(mt * hid); p_ma1b = c.fl(mt * ch);
    p_ln2b = c.fl((long)rg * C); p_ln2w = c.fl((long)rg * C); p_sa2b = c.fl((long)rg * C);
    p_sa1b = c.fl(mt * ch); p_projb = c.fl(mt * C);
    p_qkvb = c.fl((long)groups * 3 * C);
    p_bias = c.fl((long)groups * s.nh * WIN_N * WIN_N);
    p_ln1b = c.fl((long)rg * C); p_ln1w = c.fl((long)rg * C);
    w_fc2.plan(c, M, hid, C, tl);
    w_fc1.plan(c, M, C, hid, tl);
    w_ma2.plan(c, M, ch, C, tl);
    w_ma1.plan(c, M, C, ch, tl);
    w_sa2.plan(c, M, ch, C, tl);
    w_sa1.plan(c, M, C, ch, tl);
    w_proj.plan(c, M, C, C, tl);
    w_qkv.plan(c, M, C, 3 * C, tl);
    bytes = c.off;
  }
};

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of workspace swin_block_adapt_backward needs at these shapes and
// tiles, into *bytes; ch is the padded adapter width.
extern "C" int swin_block_adapt_backward_workspace(int B, int H, int W, int C, int nh, int win,
                                                   int shift, int hidden, int ch, int bn_nn,
                                                   int bn_nt, int bn_dual, int bn_tt,
                                                   int tt_items, int stages, long long* bytes) {
  const BwdShapes s{B, H, W, C, nh, win, shift, hidden, ch};
  const BwTiles t{bn_nn, bn_nt, bn_dual, bn_tt, tt_items, stages};
  if (bad_shapes(s) || bad_tiles(t)) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = K5Work(s, t, nullptr).bytes;
  return 0;
}

#define TRY(expr)                                      \
  do {                                                 \
    const cudaError_t e_ = (expr);                     \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// K5: backward of one Swin block with adapters. Inputs as K4's plus dout
// (B*H*W, C) bf16. Outputs: dx (B*H*W, C) bf16 and float32 grads, K3's
// (d_ln1_w/b (C), d_qkv_w (C, 3C), d_qkv_b (3C), d_proj_w (C, C), d_proj_b,
// d_ln2_w/b, d_fc1_w (C, hidden), d_fc1_b, d_fc2_w (hidden, C), d_fc2_b,
// d_bias (nh, 64, 64)) then the adapters' (d_sa1_w (C, ch), d_sa1_b (ch),
// d_sa2_w (ch, C), d_sa2_b (C), and the same four for ma), each null when
// not wanted. ws: the backward workspace at the same tiles.
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
    int hidden, int ch, int bn_nn, int bn_nt, int bn_dual, int bn_tt, int tt_items,
    int stages, cudaStream_t stream) {
  const BwdShapes sh{B, H, W, C, nh, win, shift, hidden, ch};
  const BwTiles t{bn_nn, bn_nt, bn_dual, bn_tt, tt_items, stages};
  if (bad_shapes(sh) || bad_tiles(t)) return static_cast<int>(cudaErrorInvalidValue);
  const RowMap g{H * W, H, W, win, shift, C};
  const long M = sh.M();
  const int rows = static_cast<int>(M), L = H * W, rg = row_grid(M);
  const int nW = sh.nW(), nwin = sh.n_windows(), groups = att_groups(nwin, nh);
  const int mt = (rows + BW_BM - 1) / BW_BM;
  const unsigned rb = static_cast<unsigned>((M + 7) / 8);
  K5Work w(sh, t, static_cast<char*>(ws_base));
  Reducer red;
  BwArgs a;

  // ---- forward recompute: LN1, qkv, attention, proj (token order), the
  // spatial adapter (gs, t in float32), LN2 of y = x + m0 (a + s t)
  const YSrc yx{x, nullptr, nullptr, masks, 0.f, L};
  ROW_PASS(ln_fwd_rows, rb, 0, stream, C, yx, ln1_w, ln1_b, w.h1, w.st1, rows, g, 1);
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = 3 * C; a.bias = qkv_b; a.out = w.qkv; a.g = g;
  TRY((bw_gemm_bn<BW_NN, E_BF16>(t.bn_nn, BwPair{w.h1, qkv_w, C}, BwPair{}, a, stream)));
  TRY(attention_fwd(w.qkv, bias, mask, w.attn, C, nh, nW, nwin, stream));
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = C; a.bias = proj_b; a.out = w.a; a.map = MAP_WIN_TO_TOK; a.g = g;
  TRY((bw_gemm_bn<BW_NN, E_BF16>(t.bn_nn, BwPair{w.attn, proj_w, C}, BwPair{}, a, stream)));
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = ch; a.bias = sa1_b; a.gelu = 1; a.out = w.gs; a.g = g;
  TRY((bw_gemm_bn<BW_NN, E_BF16>(t.bn_nn, BwPair{w.a, sa1_w, C}, BwPair{}, a, stream)));
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = C; a.bias = sa2_b; a.out_f32 = w.t; a.g = g;
  TRY((bw_gemm_bn<BW_NN, E_F32>(t.bn_nn, BwPair{w.gs, sa2_w, ch}, BwPair{}, a, stream)));
  const YSrc yy{x, w.a, w.t, masks, s, L};
  ROW_PASS(ln_fwd_rows, rb, 0, stream, C, yy, ln2_w, ln2_b, w.h2, w.st2, rows, g, 0);

  // ---- MLP branch and MLP adapter: df2 = bf16(m1 dout), g2m = bf16(s m1
  // dout); fg, df1 and gm, df1m from the two DUAL GEMMs; dh2 = df1 fc1^T +
  // df1m Wma1^T (float32)
  ROW_PASS(scale_rows, rg, row_smem(C), stream, C, dout, masks, 1, s, w.df2, w.g2m, 0, w.p_fc2b,
                                             w.p_ma2b, M, L, C);
  red.add(w.p_fc2b, rg, C, d_fc2_b);
  red.add(w.p_ma2b, rg, C, d_ma2_b);
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = hidden; a.bias = fc1_b; a.out = w.fg; a.out1 = w.df1; a.colsum = w.p_fc1b;
  a.g = g;
  TRY((bw_gemm_bn<BW_DUAL, E_DUAL>(t.bn_dual, BwPair{w.h2, fc1_w, C}, BwPair{w.df2, fc2_w, C}, a,
                                   stream)));
  red.add(w.p_fc1b, mt, hidden, d_fc1_b);
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = ch; a.bias = ma1_b; a.out = w.gm; a.out1 = w.df1m; a.colsum = w.p_ma1b;
  a.g = g;
  TRY((bw_gemm_bn<BW_DUAL, E_DUAL>(t.bn_dual, BwPair{w.h2, ma1_w, C}, BwPair{w.g2m, ma2_w, C}, a,
                                   stream)));
  red.add(w.p_ma1b, mt, ch, d_ma1_b);
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = C; a.out_f32 = w.dh2; a.g = g;
  TRY((bw_gemm_bn<BW_CAT, E_F32>(t.bn_nt, BwPair{w.df1, fc1_w, hidden},
                                 BwPair{w.df1m, ma1_w, ch}, a, stream)));
  TRY(weight_grad(w.w_fc2, w.fg, w.df2, M, hidden, C, d_fc2_w, t, red, stream));
  TRY(weight_grad(w.w_fc1, w.h2, w.df1, M, C, hidden, d_fc1_w, t, red, stream));
  TRY(weight_grad(w.w_ma2, w.gm, w.g2m, M, ch, C, d_ma2_w, t, red, stream));
  TRY(weight_grad(w.w_ma1, w.h2, w.df1m, M, C, ch, d_ma1_w, t, red, stream));

  // dy = dout + LN2'(dh2) (float32, token order), g2s = bf16(s m0 dy)
  ROW_PASS(ln2_bwd_rows, rg, row_smem(C), stream, C, w.dh2, yy, w.st2, ln2_w, dout, w.dy, nullptr,
                                               w.g2s, w.p_ln2b,
                                               d_ln2_w != nullptr ? w.p_ln2w : nullptr, w.p_sa2b,
                                               M, g);
  red.add(w.p_ln2b, rg, C, d_ln2_b);
  red.add(w.p_ln2w, rg, C, d_ln2_w);
  red.add(w.p_sa2b, rg, C, d_sa2_b);

  // ---- spatial adapter: df1s = bf16((g2s Wsa2^T) gelu'(a Wsa1 + b)); dA =
  // bf16(m0 dy + df1s Wsa1^T) in window order
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = ch; a.bias = sa1_b; a.out1 = w.df1s; a.colsum = w.p_sa1b; a.g = g;
  TRY((bw_gemm_bn<BW_DUAL, E_DUAL>(t.bn_dual, BwPair{w.a, sa1_w, C}, BwPair{w.g2s, sa2_w, C}, a,
                                   stream)));
  red.add(w.p_sa1b, mt, ch, d_sa1_b);
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = C; a.out = w.dA; a.map = MAP_TOK_TO_WIN; a.g = g; a.add = w.dy;
  a.masks = masks; a.colsum = w.p_projb;
  TRY((bw_gemm_bn<BW_NT, E_ADD>(t.bn_nt, BwPair{w.df1s, sa1_w, ch}, BwPair{}, a, stream)));
  red.add(w.p_projb, mt, C, d_proj_b);
  TRY(weight_grad(w.w_sa2, w.gs, w.g2s, M, ch, C, d_sa2_w, t, red, stream));
  TRY(weight_grad(w.w_sa1, w.a, w.df1s, M, C, ch, d_sa1_w, t, red, stream));

  // ---- attention branch (K3's)
  TRY(weight_grad(w.w_proj, w.attn, w.dA, M, C, C, d_proj_w, t, red, stream));
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = C; a.out = w.dattn; a.g = g;
  TRY((bw_gemm_bn<BW_NT, E_BF16>(t.bn_nt, BwPair{w.dA, proj_w, C}, BwPair{}, a, stream)));
  TRY(attention_bwd(w.qkv, w.dattn, bias, mask, w.dqkv, d_bias != nullptr ? w.p_bias : nullptr,
                    w.p_qkvb, C, nh, nW, nwin, stream));
  red.add(w.p_qkvb, groups, 3L * C, d_qkv_b);
  red.add(w.p_bias, groups, (long)nh * WIN_N * WIN_N, d_bias);
  TRY(weight_grad(w.w_qkv, w.h1, w.dqkv, M, C, 3 * C, d_qkv_w, t, red, stream));
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = C; a.out = w.dh; a.map = MAP_WIN_TO_TOK; a.g = g;
  TRY((bw_gemm_bn<BW_NT, E_BF16>(t.bn_nt, BwPair{w.dqkv, qkv_w, 3 * C}, BwPair{}, a, stream)));

  // dx = dy + LN1'(dh)
  ROW_PASS(ln1_bwd_rows, rg, row_smem(C), stream, C, w.dh, x, w.st1, ln1_w, w.dy, dx, w.p_ln1b,
                                               d_ln1_w != nullptr ? w.p_ln1w : nullptr, M, C);
  red.add(w.p_ln1b, rg, C, d_ln1_b);
  red.add(w.p_ln1w, rg, C, d_ln1_w);
  TRY(red.launch(stream));
  return static_cast<int>(cudaGetLastError());
}
