// Kernel K3: backward of the training Swin block (drop-path masks, no merge),
// for Hopper (sm_90a).
//
// Replaces the JAX package's ops/pallas/swin_block_vjp.py::_bwd_kernel (via
// _bwd_call). From the block input x (B, H*W, C) bf16, the masks m (B, 2)
// float32 and the output cotangent dout (B, H*W, C) bf16 it recomputes the
// forward and returns dx (bf16) and float32 gradients of the parameters in
// the kernel layout of K2: LN1/LN2 scale and bias, qkv (q-scale folded, as K2
// reads it), proj, fc1 and fc2 (in, out) weights and biases, and the
// (nh, 64, 64) gathered relative-position bias. A null grad pointer is a grad
// not wanted (training with frozen parameters): its weight-grad GEMM, its
// LayerNorm-scale sums or the bias-table sums are skipped.
//
// Numerics follow _bwd_kernel step by step (the plain version
// ops/swin_block_vjp.py::swin_block_backward_plain spells them out): matmul
// operands bf16 with float32 accumulation; LayerNorm, softmax and every grad
// chain in float32; y = x + m0 * proj recomputed in float32; qkv, P, the
// heads, proj, GELU output, df2 = bf16(m1 dout), df1, dS, dqkv, the
// attention-output grad and the window-order input grad rounded to bf16
// where the Pallas kernel rounds them; GELU and GELU' with the exact erff.
// The q-scale is folded into the qkv weights, so the q-column gradients come
// out per folded weight; the wrapper multiplies them by the scale.
//
// What bounds it on the H100: per block the forward recompute (24 M C^2 GEMM
// FLOPs) and the activation and weight grads (48 M C^2), plus the attention
// recompute and backward (~16 M 64 C): operations (chip_smoke.py::k3_work).
// At stage 1 (M = 131072, C = 96) every GEMM is short in K, and the bytes of
// the intermediates (~1.8 GB a block in this design) are what the time
// follows.
//
// Design, on the Hopper layer swin_bwd_sm90.cuh (18 launches a block, on the
// caller's stream; intermediates in a workspace the wrapper allocates):
//  * ln_fwd_rows: LN1 into window order (the qkv GEMM's A) keeping only the
//    token's (mean, rstd); LN2 on y = x + m0 proj the same way. xhat and yhat
//    are recomputed from x (and proj) where the backward needs them.
//  * bw_gemm NN: qkv, proj (stored through the window -> token map).
//  * attention_fwd_sm90: P V on wgmma.
//  * scale_rows: df2 = bf16(m1 dout) with fc2_b's column sums.
//  * bw_gemm DUAL: fc1's recompute and fc2's activation grad on one 128-row
//    tile, the epilogue writing fg = bf16(gelu(f1)) and df1 = bf16(dfg
//    gelu'(f1)) and fc1_b's sums; no float32 f1.
//  * bw_gemm NT: dh2 = df1 fc1^T (float32), dattn, and dh = bf16(dqkv qkv^T)
//    stored through the window -> token map.
//  * ln2_bwd_rows: dy = dout + LN2'(dh2), dA = bf16(m0 dy) in window order,
//    with the ln2 and proj_b sums; ln1_bwd_rows: dx, with the ln1 sums.
//  * attention_bwd_sm90: dqkv on wgmma, with the bias-table and qkv_b sums.
//  * bw_gemm TT: the four weight grads, rows split over the blocks.
//  * reduce_jobs: every split partial and column-sum partial summed in a
//    fixed order, in one launch: a launch repeated gives the same bits.

#include "swin_bwd_sm90.cuh"

namespace {

bool bad_shapes(const BwdShapes& s) {
  return s.C / s.nh != HD || s.C % s.nh || s.win * s.win != WIN_N || s.C % 32 || s.C > 768 ||
         s.hidden % 32 || s.H % s.win || s.W % s.win;
}

// the workspace, carved in one order for the size query and the call
struct K3Work {
  bf16 *h1, *qkv, *attn, *img2, *h2, *df2, *fg, *df1, *dA, *dattn, *dqkv, *dh;
  float2 *st1, *st2;
  float *dh2, *dy;
  float *p_fc2b, *p_fc1b, *p_ln2b, *p_ln2w, *p_projb, *p_qkvb, *p_bias, *p_ln1b, *p_ln1w;
  WGrad w_fc2, w_fc1, w_proj, w_qkv;
  long bytes;

  K3Work(const BwdShapes& s, const BwTiles& t, char* base) {
    const long M = s.M();
    const int C = s.C, hid = s.hidden, rg = row_grid(M);
    const int groups = att_groups(s.n_windows(), s.nh);
    Carver c{base};
    h1 = c.bf(M * C); qkv = c.bf(M * 3 * C); attn = c.bf(M * C); img2 = c.bf(M * C);
    h2 = c.bf(M * C); df2 = c.bf(M * C); fg = c.bf(M * hid); df1 = c.bf(M * hid);
    dA = c.bf(M * C); dattn = c.bf(M * C); dqkv = c.bf(M * 3 * C); dh = c.bf(M * C);
    st1 = reinterpret_cast<float2*>(c.fl(2 * M));
    st2 = reinterpret_cast<float2*>(c.fl(2 * M));
    dh2 = c.fl(M * C); dy = c.fl(M * C);
    p_fc2b = c.fl((long)rg * C);
    p_fc1b = c.fl((M + BW_BM - 1) / BW_BM * hid);
    p_ln2b = c.fl((long)rg * C); p_ln2w = c.fl((long)rg * C); p_projb = c.fl((long)rg * C);
    p_qkvb = c.fl((long)groups * 3 * C);
    p_bias = c.fl((long)groups * s.nh * WIN_N * WIN_N);
    p_ln1b = c.fl((long)rg * C); p_ln1w = c.fl((long)rg * C);
    w_fc2.plan(c, M, hid, C, t);
    w_fc1.plan(c, M, C, hid, t);
    w_proj.plan(c, M, C, C, t);
    w_qkv.plan(c, M, C, 3 * C, t);
    bytes = c.off;
  }
};

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of workspace swin_block_backward needs at these shapes and tiles,
// into *bytes.
extern "C" int swin_block_backward_workspace(int B, int H, int W, int C, int nh, int win,
                                             int shift, int hidden, int bn_nn, int bn_nt,
                                             int bn_dual, int bn_tt, int tt_items, int stages,
                                             long long* bytes) {
  const BwdShapes s{B, H, W, C, nh, win, shift, hidden, 0};
  const BwTiles t{bn_nn, bn_nt, bn_dual, bn_tt, tt_items, stages};
  if (bad_shapes(s) || bad_tiles(t)) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = K3Work(s, t, nullptr).bytes;
  return 0;
}

#define TRY(expr)                                      \
  do {                                                 \
    const cudaError_t e_ = (expr);                     \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// Backward of one training Swin block. Inputs: x, dout (B*H*W, C) bf16;
// masks (B, 2) float32; K2's weights ((in, out) bf16 matrices with the
// q-scale folded into qkv, float32 vectors, bias (nh, 64, 64), shift mask
// (nW, 64, 64) or null). Outputs: dx (B*H*W, C) bf16 and float32 grads
// d_ln1_w/b (C), d_qkv_w (C, 3C), d_qkv_b (3C), d_proj_w (C, C), d_proj_b,
// d_ln2_w/b (C), d_fc1_w (C, hidden), d_fc1_b (hidden), d_fc2_w (hidden, C),
// d_fc2_b (C), d_bias (nh, 64, 64), each null when not wanted. ws:
// swin_block_backward_workspace bytes at the same tiles.
extern "C" int swin_block_backward(
    const bf16* x, const bf16* dout, const float* masks, const float* ln1_w, const float* ln1_b,
    const bf16* qkv_w, const float* qkv_b, const bf16* proj_w, const float* proj_b,
    const float* ln2_w, const float* ln2_b, const bf16* fc1_w, const float* fc1_b,
    const bf16* fc2_w, const float* fc2_b, const float* bias, const float* mask, bf16* dx,
    float* d_ln1_w, float* d_ln1_b, float* d_qkv_w, float* d_qkv_b, float* d_proj_w,
    float* d_proj_b, float* d_ln2_w, float* d_ln2_b, float* d_fc1_w, float* d_fc1_b,
    float* d_fc2_w, float* d_fc2_b, float* d_bias, void* ws_base, int B, int H, int W, int C,
    int nh, int win, int shift, int hidden, int bn_nn, int bn_nt, int bn_dual, int bn_tt,
    int tt_items, int stages, cudaStream_t stream) {
  const BwdShapes s{B, H, W, C, nh, win, shift, hidden, 0};
  const BwTiles t{bn_nn, bn_nt, bn_dual, bn_tt, tt_items, stages};
  if (bad_shapes(s) || bad_tiles(t)) return static_cast<int>(cudaErrorInvalidValue);
  const RowMap g{H * W, H, W, win, shift, C};
  const long M = s.M();
  const int rows = static_cast<int>(M), L = H * W, rg = row_grid(M);
  const int nW = s.nW(), nwin = s.n_windows(), groups = att_groups(nwin, nh);
  const unsigned rb = static_cast<unsigned>((M + 7) / 8);
  K3Work w(s, t, static_cast<char*>(ws_base));
  Reducer red;
  BwArgs a;

  // ---- forward recompute
  const YSrc yx{x, nullptr, nullptr, masks, 0.f, L};
  ROW_PASS(ln_fwd_rows, rb, 0, stream, C, yx, ln1_w, ln1_b, w.h1, w.st1, rows, g, 1);
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = 3 * C; a.bias = qkv_b; a.out = w.qkv; a.g = g;
  TRY((bw_gemm_bn<BW_NN, E_BF16>(t.bn_nn, BwPair{w.h1, qkv_w, C}, BwPair{}, a, stream)));
  TRY(attention_fwd(w.qkv, bias, mask, w.attn, C, nh, nW, nwin, stream));
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = C; a.bias = proj_b; a.out = w.img2; a.map = MAP_WIN_TO_TOK; a.g = g;
  TRY((bw_gemm_bn<BW_NN, E_BF16>(t.bn_nn, BwPair{w.attn, proj_w, C}, BwPair{}, a, stream)));
  const YSrc yy{x, w.img2, nullptr, masks, 0.f, L};
  ROW_PASS(ln_fwd_rows, rb, 0, stream, C, yy, ln2_w, ln2_b, w.h2, w.st2, rows, g, 0);

  // ---- MLP branch: df2 = bf16(m1 dout); fg, df1 = bf16((df2 fc2^T) gelu'(f1));
  // dh2 = df1 fc1^T (float32)
  ROW_PASS(scale_rows, rg, row_smem(C), stream, C, dout, masks, 1, 1.f, w.df2, nullptr, 1, w.p_fc2b,
                                             nullptr, M, L, C);
  red.add(w.p_fc2b, rg, C, d_fc2_b);
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = hidden; a.bias = fc1_b; a.out = w.fg; a.out1 = w.df1; a.colsum = w.p_fc1b;
  a.g = g;
  TRY((bw_gemm_bn<BW_DUAL, E_DUAL>(t.bn_dual, BwPair{w.h2, fc1_w, C}, BwPair{w.df2, fc2_w, C}, a,
                                   stream)));
  red.add(w.p_fc1b, (rows + BW_BM - 1) / BW_BM, hidden, d_fc1_b);
  a = BwArgs{};
  a.stages = t.stages;
  a.M = rows; a.N = C; a.out_f32 = w.dh2; a.g = g;
  TRY((bw_gemm_bn<BW_NT, E_F32>(t.bn_nt, BwPair{w.df1, fc1_w, hidden}, BwPair{}, a, stream)));
  TRY(weight_grad(w.w_fc2, w.fg, w.df2, M, hidden, C, d_fc2_w, t, red, stream));
  TRY(weight_grad(w.w_fc1, w.h2, w.df1, M, C, hidden, d_fc1_w, t, red, stream));

  // dy = dout + LN2'(dh2) (float32, token order); dA = bf16(m0 dy), window order
  ROW_PASS(ln2_bwd_rows, rg, row_smem(C), stream, C, w.dh2, yy, w.st2, ln2_w, dout, w.dy, w.dA, nullptr,
                                               w.p_ln2b, d_ln2_w != nullptr ? w.p_ln2w : nullptr,
                                               w.p_projb, M, g);
  red.add(w.p_ln2b, rg, C, d_ln2_b);
  red.add(w.p_ln2w, rg, C, d_ln2_w);
  red.add(w.p_projb, rg, C, d_proj_b);

  // ---- attention branch
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
  // dh = bf16(dqkv qkv^T), window reverse + unshift into token order
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

// Bytes of float32 partials the TT form of swin_bwd_gemm needs: (splits, Ka,
// N) over `rows`, or none with one split.
extern "C" int swin_bwd_gemm_workspace(int rows, int Ka, int N, int bn, int tt_items,
                                       long long* bytes) {
  int rps, splits;
  tt_split(rows, Ka, N, bn, tt_items, &rps, &splits);
  *bytes = splits > 1 ? 4LL * splits * Ka * N : 0;
  return 0;
}

// One GEMM form of the backward layer alone (its card tests hold each form
// against its plain version at every tile and split it uses). form: 0 NN
// with a bf16 out (bias, GELU), 1 NN float32, 2 NT bf16, 3 NT float32, 4 CAT
// float32, 5 DUAL (out = bf16(gelu(A0 B0 + bias)), out1 = bf16((A1 B1^T)
// gelu'(...)), colsum = per-128-row-tile column sums of out1), 6 TT (out_f32
// (M, N) = A0^T B0 over K0 rows, A0 (K0, M), B0 (K0, N), split over the rows
// and reduced in order through ws). Other operands: NN B (K, N), NT B (N, K).
extern "C" int swin_bwd_gemm(int form, int bn, int tt_items, const bf16* A0, const bf16* B0,
                             int K0, const bf16* A1, const bf16* B1, int K1, int M, int N,
                             const float* bias, int gelu, bf16* out, bf16* out1, float* out_f32,
                             float* colsum, void* ws, cudaStream_t stream) {
  if (M < 1 || N < 1 || K0 < 1 || N % 8 || (form != 6 && K0 % 8) || K1 % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  BwArgs a{};
  a.M = M; a.N = N; a.bias = bias; a.gelu = gelu; a.out = out; a.out1 = out1;
  a.out_f32 = out_f32; a.colsum = colsum;
  const BwPair p0{A0, B0, K0}, p1{A1, B1, K1};
  switch (form) {
    case 0: return static_cast<int>(bw_gemm_bn<BW_NN, E_BF16>(bn, p0, p1, a, stream));
    case 1: return static_cast<int>(bw_gemm_bn<BW_NN, E_F32>(bn, p0, p1, a, stream));
    case 2: return static_cast<int>(bw_gemm_bn<BW_NT, E_BF16>(bn, p0, p1, a, stream));
    case 3: return static_cast<int>(bw_gemm_bn<BW_NT, E_F32>(bn, p0, p1, a, stream));
    case 4: return static_cast<int>(bw_gemm_bn<BW_CAT, E_F32>(bn, p0, p1, a, stream));
    case 5: return static_cast<int>(bw_gemm_bn<BW_DUAL, E_DUAL>(bn, p0, p1, a, stream));
    case 6: {
      const BwTiles t{bn, bn, bn, bn, tt_items, 0};
      WGrad w;
      tt_split(K0, M, N, bn, tt_items, &w.rps, &w.splits);
      w.part = static_cast<float*>(ws);
      Reducer red;
      TRY(weight_grad(w, A0, B0, K0, M, N, out_f32, t, red, stream));
      TRY(red.launch(stream));
      return static_cast<int>(cudaGetLastError());
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
