// Kernel K4: the Swin block with AdapterBit bottleneck adapters, forward
// (serving with masks of ones, and training with drop-path masks), for
// Hopper (sm_90a).
//
// Replaces the JAX package's ops/pallas/swin_block_adapt_vjp.py::_fwd_kernel
// (via _fwd_call: swin_block_adapt_eval and the swin_block_train_adapt
// forward). With s the constant adapter scalar, masks m (B, 2) float32 and a
// the block's attention output after proj, window reverse and unshift (bf16,
// token order):
//   gs  = bf16(gelu(a Wsa1 + bsa1))
//   y   = x + m0 * (a + s * (gs Wsa2 + bsa2))                    (float32)
//   h2  = bf16(LN2(y))
//   fg  = bf16(gelu(h2 fc1 + b1)),  gm = bf16(gelu(h2 Wma1 + bma1))
//   out = bf16(y + m1 * ((fg fc2 + b2) + s * (gm Wma2 + bma2)))
// Unlike K2, y stays float32 between the two halves, the masks multiply
// unrounded and only out is rounded (swin_block_adapt_vjp.py:126-152). GELU
// outputs, qkv, P, the heads and a are rounded to bf16 where the Pallas
// kernel rounds them; GELU uses the exact erff (the Pallas bf16 path uses a
// fast erf). The spatial adapter is row-wise, so it runs on the token-order
// rows, as the Pallas kernel does after its window reverse.
//
// The adapter width is the wrapper's: C * mlp_ratio padded with zero columns
// (Wa1, ba1) and zero rows (Wa2) to a multiple of 32; the padded units
// compute gelu(0) = 0. At stage 0 (48 -> 64) the adapter GEMMs have K = 64,
// one k-block.
//
// What bounds it on the H100: K2's 24 M C^2 GEMM FLOPs and 4 M 64 C of
// attention plus the adapters' 8 M C ch: tensor-core work above the bf16
// balance point, so operations (chip_smoke.py::k4_work).
//
// Design, on the Hopper forward layer swin_fwd_sm90.cuh (K2's phase bodies):
// one launch a phase, in order on the caller's stream, ten a block:
//   LN1 rows in window order; qkv (F_OUT); the window attention; proj
//   (F_OUT, a = bf16(acc + b) stored through the window -> token map, no
//   residual); sa1 (F_OUT with GELU, N = ch); sa2 (F_BRANCH: y in float32
//   from x, a and the mask); LN2 rows of the float32 y; fc1 and ma1 (F_OUT
//   with GELU); fc2 and ma2 on one tile (F_ADAPT_OUT: two accumulator
//   chains through one ring, then out from y and the mask).
// The GEMMs are the layer's TMA-fed warp-specialised wgmma GEMM; the bf16
// GEMMs' tile widths and the ring depth are the caller's
// (ops/swin_block_adapt.py TILES), the float32 forms' width is FW_BN_F32.
// Intermediates go through a workspace in device memory.

#include "swin_fwd_sm90.cuh"

namespace {

struct FwdWorkspace {
  bf16 *h, *qkv, *attn, *a, *gs, *hid;  // h: LN1 rows, then LN2's h2; gs, then gm
  float* y;
  long bytes;

  FwdWorkspace(const BwdShapes& s, char* base) {
    const long M = s.M();
    const int C = s.C;
    Carver c{base};
    h = c.bf(M * C);
    qkv = c.bf(M * 3 * C);
    attn = c.bf(M * C);
    a = c.bf(M * C);
    gs = c.bf(M * s.ch);
    hid = c.bf(M * s.hidden);
    y = c.fl(M * C);
    bytes = c.off;
  }
};

// the tile choices a call passes (ops/swin_block_adapt.py TILES): the bf16
// GEMMs' tile widths and the ring depth (0: as deep as fits)
struct AdaptTiles {
  int qkv, proj, sa1, fc1, ma1, stages;
};

bool bad_adapt(const BwdShapes& s, const AdaptTiles& t) {
  return bad_block(s.H, s.W, s.C, s.nh, s.win, s.hidden) || s.ch < 32 || s.ch % 32 ||
         bad_bn(t.qkv) || bad_bn(t.proj) || bad_bn(t.sa1) || bad_bn(t.fc1) || bad_bn(t.ma1) ||
         t.stages < 0 || t.stages == 1;
}

FwdGemm gemm_args(long M, int N, const float* bias, int gelu, bf16* out) {
  FwdGemm a{};
  a.M = static_cast<int>(M);
  a.N = N;
  a.bias = bias;
  a.gelu = gelu;
  a.out = out;
  return a;
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of workspace swin_block_adapt_forward needs at these shapes, into
// *bytes; ch is the padded adapter width.
extern "C" int swin_block_adapt_forward_workspace(int B, int H, int W, int C, int nh, int win,
                                                  int shift, int hidden, int ch,
                                                  long long* bytes) {
  const BwdShapes s{B, H, W, C, nh, win, shift, hidden, ch};
  *bytes = FwdWorkspace(s, nullptr).bytes;
  return 0;
}

// K4: one Swin block with adapters. x (B*H*W, C) bf16; masks (B, 2) float32;
// K2's weights ((in, out) bf16 matrices with the q-scale folded into qkv,
// float32 vectors, bias (nh, 64, 64), shift mask (nW, 64, 64) or null); the
// adapters' (in, out) bf16 matrices sa1 (C, ch), sa2 (ch, C), ma1, ma2 and
// float32 biases; s the adapter scalar. out (B*H*W, C) bf16. ws: the forward
// workspace. Tiles: each GEMM's tile width and the ring depth.
extern "C" int swin_block_adapt_forward(
    const bf16* x, const float* masks, const float* ln1_w, const float* ln1_b, const bf16* qkv_w,
    const float* qkv_b, const bf16* proj_w, const float* proj_b, const float* ln2_w,
    const float* ln2_b, const bf16* fc1_w, const float* fc1_b, const bf16* fc2_w,
    const float* fc2_b, const bf16* sa1_w, const float* sa1_b, const bf16* sa2_w,
    const float* sa2_b, const bf16* ma1_w, const float* ma1_b, const bf16* ma2_w,
    const float* ma2_b, const float* bias, const float* mask, float s, bf16* out, void* ws_base,
    int B, int H, int W, int C, int nh, int win, int shift, int hidden, int ch, int bn_qkv,
    int bn_proj, int bn_sa1, int bn_fc1, int bn_ma1, int stages, cudaStream_t stream) {
  const BwdShapes sh{B, H, W, C, nh, win, shift, hidden, ch};
  const AdaptTiles t{bn_qkv, bn_proj, bn_sa1, bn_fc1, bn_ma1, stages};
  if (bad_adapt(sh, t)) return static_cast<int>(cudaErrorInvalidValue);
  const RowMap g{H * W, H, W, win, shift, C};
  const long M = sh.M();
  FwdWorkspace ws(sh, static_cast<char*>(ws_base));

  // LN1 rows in window order, qkv, the window attention
  cudaError_t e = ln_rows_launch<LN_WINDOWS>(x, ln1_w, ln1_b, ws.h, (int)M, g, stream);
  if (e == cudaSuccess)
    e = fwd_gemm_bn<F_OUT>(t.qkv, ws.h, qkv_w, C, gemm_args(M, 3 * C, qkv_b, 0, ws.qkv),
                           t.stages, stream);
  if (e == cudaSuccess)
    e = attention_launch(ws.qkv, bias, mask, ws.attn, C, nh, sh.nW(), sh.n_windows(), stream);

  // proj: a = bf16(acc + b), through the window -> token map
  FwdGemm a = gemm_args(M, C, proj_b, 0, ws.a);
  a.map = MAP_WIN_TO_TOK;
  a.g = g;
  if (e == cudaSuccess) e = fwd_gemm_bn<F_OUT>(t.proj, ws.attn, proj_w, C, a, t.stages, stream);

  // spatial adapter: gs = bf16(gelu(a Wsa1 + b)); y = x + m0 (a + s (gs Wsa2 + b))
  if (e == cudaSuccess)
    e = fwd_gemm_bn<F_OUT>(t.sa1, ws.a, sa1_w, C, gemm_args(M, ch, sa1_b, 1, ws.gs), t.stages,
                           stream);
  a = gemm_args(M, C, sa2_b, 0, nullptr);
  a.resid = x;
  a.add = ws.a;
  a.scale = masks;
  a.s = s;
  a.out_f32 = ws.y;
  a.g = g;
  if (e == cudaSuccess)
    e = fwd_gemm_launch<FW_BN_F32, F_BRANCH>(ws.gs, sa2_w, ch, a, t.stages, stream);

  // h2 = bf16(LN2(y)); fg = bf16(gelu(h2 fc1 + b1)); gm = bf16(gelu(h2 Wma1 + b))
  if (e == cudaSuccess) e = ln_rows_launch<LN_TOKENS>(ws.y, ln2_w, ln2_b, ws.h, (int)M, g, stream);
  if (e == cudaSuccess)
    e = fwd_gemm_bn<F_OUT>(t.fc1, ws.h, fc1_w, C, gemm_args(M, hidden, fc1_b, 1, ws.hid),
                           t.stages, stream);
  if (e == cudaSuccess)
    e = fwd_gemm_bn<F_OUT>(t.ma1, ws.h, ma1_w, C, gemm_args(M, ch, ma1_b, 1, ws.gs), t.stages,
                           stream);

  // out = bf16(y + m1 ((fg fc2 + b2) + s (gm Wma2 + b)))
  a = gemm_args(M, C, fc2_b, 0, out);
  a.bias1 = ma2_b;
  a.y32 = ws.y;
  a.scale = masks + 1;
  a.s = s;
  a.g = g;
  if (e == cudaSuccess)
    e = fwd_gemm_two_launch(ws.hid, fc2_w, hidden, ws.gs, ma2_w, ch, a, t.stages, stream);
  return static_cast<int>(e);
}

// One of K4's GEMM forms alone, for the tests: epi 0 (F_OUT: bias, GELU
// when gelu, the output row through the window -> token map of (L, H, W,
// win, shift) when map), 2 (F_BRANCH: float32 y = x + m0 (add + s (A W +
// bias)), m0 = m[2 (r / L)]) or 3 (F_ADAPT_OUT: bf16(y32 + m1 ((A W + bias)
// + s (A1 W1 + bias1))), m1 = m[2 (r / L)]); m points at the masks' column;
// the float32 forms take width FW_BN_F32 only.
extern "C" int swin_adapt_gemm(int epi, int bn, int stages, const bf16* A, const bf16* Wt,
                               const float* bias, int gelu, const bf16* A1, const bf16* W1,
                               const float* bias1, const bf16* x, const bf16* add,
                               const float* y32, const float* m, float s, void* out, int M, int N,
                               int K, int K1, int L, int H, int W, int win, int shift, int map,
                               cudaStream_t stream) {
  const bool two = epi == F_ADAPT_OUT;
  if (bad_bn(bn) || (epi != F_OUT && bn != FW_BN_F32) || stages < 0 || stages == 1 || M < 1 ||
      N < 8 || N % 8 || K < 8 || K % 8 || (two && (K1 < 8 || K1 % 8)) ||
      (epi != F_OUT && epi != F_BRANCH && !two) || (epi != F_OUT && (m == nullptr || L < 1)) ||
      (epi == F_BRANCH && (x == nullptr || add == nullptr || bias == nullptr)) ||
      (two && (A1 == nullptr || W1 == nullptr || y32 == nullptr || bias == nullptr ||
               bias1 == nullptr)) ||
      (map && (epi != F_OUT || win < 1 || H % win || W % win || L != H * W || M % L)))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdGemm a = gemm_args(M, N, bias, gelu, static_cast<bf16*>(out));
  a.map = map ? MAP_WIN_TO_TOK : MAP_NONE;
  a.g = RowMap{L, H, W, win, shift, 0};
  a.scale = m;
  a.s = s;
  cudaError_t e;
  if (epi == F_OUT) {
    e = fwd_gemm_bn<F_OUT>(bn, A, Wt, K, a, stages, stream);
  } else if (epi == F_BRANCH) {
    a.out = nullptr;
    a.out_f32 = static_cast<float*>(out);
    a.resid = x;
    a.add = add;
    e = fwd_gemm_launch<FW_BN_F32, F_BRANCH>(A, Wt, K, a, stages, stream);
  } else {
    a.bias1 = bias1;
    a.y32 = y32;
    e = fwd_gemm_two_launch(A, Wt, K, A1, W1, K1, a, stages, stream);
  }
  return static_cast<int>(e);
}

// K4's LN2 rows alone, for the tests: h (rows, C) = bf16(LN(y) w + b) of
// float32 rows y (rows, C), C % 8 == 0, C <= 1536
extern "C" int swin_adapt_ln_rows(const float* y, const float* w, const float* b, bf16* h,
                                  int rows, int C, cudaStream_t stream) {
  if (rows < 1 || C < 8 || C % 8 || C > 8 * 32 * MAX_LN_GROUPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowMap g{rows, 0, 0, 0, 0, C};
  return static_cast<int>(ln_rows_launch<LN_TOKENS>(y, w, b, h, rows, g, stream));
}
