// The Swin block forward layer for Hopper (sm_90a), shared by K2
// (swin_block.cu: one block a call, a launch a phase), K11
// (swin_stage.cu: a whole stage in one cooperative launch) and K4
// (swin_block_adapt.cu: the block with AdapterBit adapters, a launch a
// phase). Each phase of
// the block is a __device__ body that walks its work items from a given
// start with a given stride; K2's __global__ kernels run one phase each,
// K11 runs the same bodies between grid barriers, so the two give the same
// bits: the same tiles, the same wgmma sequence along K, the same epilogue
// and softmax arithmetic. Built on swin_bwd_sm90.cuh (row maps, the wgmma
// window attention's helpers, tensor maps) and sm90_gemm.cuh (TMA,
// mbarrier rings, wgmma).
//
// Phases of one block (bf16 activations, float32 sums and statistics):
//   LN rows   bf16((v - mean) rstd w + b) of each row, float32 two-pass
//             moments, one warp a row: LN1 of the tokens written in
//             shifted-window order (the qkv GEMM then reads a plain matrix
//             by TMA), LN2 in token order, the merge's LN over the 4C
//             gather (h0,w0) (h1,w0) (h0,w1) (h1,w1) of each merged row;
//             K4's LN2 reads its float32 residual stream y in token order
//   GEMM      out (M, N) = A (M, K) . W, W (K, N) row-major (wgmma's
//             MN-major, transposed B, in 64-column boxes), 128 x BN output
//             tiles (BN 64, 128 or 192), k-blocks of 64 (K's tail and M's
//             arrive as zeros from TMA); epilogues:
//               F_OUT  bf16(acc + b) or bf16(gelu(acc + b)) (qkv, fc1,
//                      the merge without bias)
//               F_RES  bf16(r + bf16(bf16(m) bf16(acc + b))), r the
//                      residual at the output row, m the image's drop-path
//                      scale (only with masks), the output row through the
//                      window -> token map (proj) or the same row (fc2):
//                      the rounding order of the Pallas kernel
//                      (swin_block.py:351, :354)
//               F_BRANCH    (K4) y = x + m0 (a + s (acc + b)) in float32,
//                           x and a bf16 at the output row, m0 the image's
//                           mask unrounded (swin_block_adapt_vjp.py:126-128)
//               F_ADAPT_OUT (K4) two accumulator chains on one tile, acc
//                           over (A, W) then acc1 over (A1, W1) on the same
//                           ring: bf16(y + m1 ((acc + b) + s (acc1 + b1))),
//                           y float32 at the output row (:146-152)
//             the float32 forms stage float32 rows; each product and sum
//             is rounded once, in the plain version's order (no FMA)
//   attention one warpgroup per (window group, head), walking its windows:
//             S = bias (+ shift mask) + Q K^T on wgmma (the bias as the
//             initial accumulator), float32 max-subtracted softmax with
//             the plain version's arithmetic (expf, the IEEE quotient by the
//             row's sum), P rounded to bf16, O = P V on wgmma with P from
//             the registers, rounded (head dim 24 zero-padded to 32 in
//             shared memory only)
// The GEMM body has two roles: a producer thread (thread 256, of a third
// warpgroup) issues the TMA boxes of A (128 x 64) and W (64 x 64, BN / 64 of
// them) into a ring of stages with a full and an empty mbarrier each; two
// consumer warpgroups run wgmma
// m64nBNk16 on their 64-row halves, keep one commit group in flight, free
// a stage when the group that read it has retired, then stage their rows,
// rounded, in padded rows of shared memory and copy them out 16 bytes a
// lane, each row to its place under the row map (a cyclic shift is not one
// TMA box). The ring's position (stage, parity) is each role's own and
// carries from one GEMM to the next within a launch.
//
// Every function lives in an anonymous namespace, as in sm90_gemm.cuh.

#pragma once

#include "swin_bwd_sm90.cuh"

namespace {

// merged row r (image, i, j), piece p of the 2x2 gather -> source token
__device__ __forceinline__ int merge_token(const RowMap& g, int r, int piece) {
  const int l4 = g.L / 4, w2 = g.W / 2;
  const int b = r / l4, rr = r - b * l4;
  const int i = rr / w2, j = rr - i * w2;
  return b * g.L + (2 * i + (piece & 1)) * g.W + 2 * j + (piece >> 1);
}

// ---------------------------------------------------------------------------
// LayerNorm rows

enum { LN_TOKENS = 0, LN_WINDOWS = 1, LN_MERGE = 2 };
constexpr int LN_THREADS = 256;
constexpr int MAX_LN_GROUPS = 6;  // 8-column groups a lane: rows of at most 1536

// the sum over the SEG lanes that share a row (lanes l / SEG alike)
template <int SEG>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// h[r] = bf16((v - mean) rstd w + b) of row r of K values (C, or 4C for
// LN_MERGE), v read from x (tokens, C): LN_TOKENS token r, LN_WINDOWS token
// window_token(r), LN_MERGE the 4C gather of merged row r. SEG lanes a row
// (32, or 16 for rows of at most 128: two rows a warp), lane l of a segment
// holding 8-column groups l, l + SEG, ...; RPI of a warp's row sets in
// flight at once (their loads issued together); the caller's warps warp0,
// warp0 + nwarps, ... x (bf16, or float32 for K4's y) carries no
// __restrict__: K11 reads tokens other blocks wrote earlier in the same
// launch.
template <int G, int SEG, int RPI, int MODE, typename T = bf16>
__device__ __forceinline__ void ln_rows(const T* x, const float* w, const float* b, bf16* h,
                                        int rows, const RowMap& g, int warp0, int nwarps) {
  constexpr int RPW = 32 / SEG;  // rows a warp at a time
  const int lane = threadIdx.x % 32, sl = lane % SEG;
  const int K = MODE == LN_MERGE ? 4 * g.C : g.C;
  for (int r0 = warp0 * RPW * RPI; r0 < rows; r0 += nwarps * RPW * RPI) {
    float v[RPI][G][8];
    float s[RPI], var[RPI], mu[RPI], rs[RPI];
#pragma unroll
    for (int k = 0; k < RPI; ++k) {
      const int r = r0 + k * RPW + lane / SEG;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int c = 8 * (sl + SEG * q);
        if (c >= K || r >= rows) continue;
        const T* src;
        if constexpr (MODE == LN_MERGE) {
          const int piece = c / g.C;
          src = x + (long)merge_token(g, r, piece) * g.C + (c - piece * g.C);
        } else {
          const long t = MODE == LN_WINDOWS ? window_token(g, r) : r;
          src = x + t * g.C + c;
        }
        load8(src, v[k][q]);
      }
    }
#pragma unroll
    for (int k = 0; k < RPI; ++k) {
      const int r = r0 + k * RPW + lane / SEG;
      s[k] = 0.f;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (8 * (sl + SEG * q) >= K || r >= rows) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) s[k] += v[k][q][e];
      }
      mu[k] = seg_sum<SEG>(s[k]) / K;
      var[k] = 0.f;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (8 * (sl + SEG * q) >= K || r >= rows) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = v[k][q][e] - mu[k];
          var[k] += d * d;
        }
      }
      rs[k] = rsqrtf(seg_sum<SEG>(var[k]) / K + LN_EPS);
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = 8 * (sl + SEG * q);
      if (c >= K) continue;
      float wv[8], bv[8];
      load8(w + c, wv);
      load8(b + c, bv);
#pragma unroll
      for (int k = 0; k < RPI; ++k) {
        const int r = r0 + k * RPW + lane / SEG;
        if (r >= rows) continue;
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = (v[k][q][e] - mu[k]) * rs[k] * wv[e] + bv[e];
        store8(h + (long)r * K + c, o);
      }
    }
  }
}

// rows a warp of the row pass takes at a time over rows of K values: two
// rows of 16 lanes each for K <= 128; for token rows (no row map to work
// out before the loads) several row sets in flight at once
__host__ __device__ __forceinline__ int ln_rows_per_warp(int K, int mode) {
  const int rpw = K <= 128 ? 2 : 1;
  if (mode != LN_TOKENS) return rpw;
  return rpw * (K <= 256 ? 4 : K <= 768 ? 2 : 1);
}

// the row pass with its segment, column groups a lane and row sets in
// flight chosen at run time (K <= 1536), as ln_rows_per_warp counts them
template <int MODE, typename T = bf16>
__device__ __forceinline__ void ln_rows_any(const T* x, const float* w, const float* b, bf16* h,
                                            int rows, const RowMap& g, int warp0, int nwarps) {
  constexpr bool SETS = MODE == LN_TOKENS;  // row sets in flight
  const int K = MODE == LN_MERGE ? 4 * g.C : g.C;
  if (K <= 128) {
    ln_rows<1, 16, SETS ? 4 : 1, MODE, T>(x, w, b, h, rows, g, warp0, nwarps);
    return;
  }
  switch ((K + 255) / 256) {
    case 1: ln_rows<1, 32, SETS ? 4 : 1, MODE, T>(x, w, b, h, rows, g, warp0, nwarps); break;
    case 2: ln_rows<2, 32, SETS ? 2 : 1, MODE, T>(x, w, b, h, rows, g, warp0, nwarps); break;
    case 3: ln_rows<3, 32, SETS ? 2 : 1, MODE, T>(x, w, b, h, rows, g, warp0, nwarps); break;
    case 4: ln_rows<4, 32, 1, MODE, T>(x, w, b, h, rows, g, warp0, nwarps); break;
    case 5: ln_rows<5, 32, 1, MODE, T>(x, w, b, h, rows, g, warp0, nwarps); break;
    default: ln_rows<6, 32, 1, MODE, T>(x, w, b, h, rows, g, warp0, nwarps); break;
  }
}

// ---------------------------------------------------------------------------
// window attention

// S = bias (+ mask) + Q K^T for the warpgroup's 64 query rows (wgmma
// accumulating onto the bias), then P = bf16(exp(S - max) / sum) in float32
// as the plain version computes it: expf of the max-subtracted scores, and
// the quotient by the row's reciprocal and one FMA correction step (the
// IEEE quotient for normal values but in rare cases), without the slow path
// of IEEE division that the shift mask's subnormal exponentials take. So P
// is the plain version's wherever the scores and the sums agree. p holds P
// (rounded, as float) in the accumulator layout.
__device__ __forceinline__ void att_scores_exact(uint32_t q_tile, uint32_t k_tile,
                                                 const float (&bm)[32], float (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = bm[i];
  fence_regs(p);  // the copies stay before the pipeline stage, or ptxas serialises it
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_ss<64>(p, desc_sw128(q_tile) + 2 * kk, desc_sw128(k_tile) + 2 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(p);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], p[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p[i] = expf(p[i] - mx[(i % 4) / 2]);
    sum[(i % 4) / 2] += p[i];
  }
  float tot[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tot[h] = quad_sum(sum[h]);
    inv[h] = 1.f / tot[h];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i % 4) / 2;
    const float q0 = p[i] * inv[h];
    p[i] = round_bf(fmaf(fmaf(-q0, tot[h], p[i]), inv[h], q0));
  }
}

// (window group, head) items; item t is head t / groups
// and windows t % groups, + groups, ... One warpgroup an item, its tiles
// (AttFwdSmem) at `base`, its named barrier `bar`.

__device__ __forceinline__ void attention_items(const bf16* qkv, const float* __restrict__ bias,
                                                const float* __restrict__ mask, bf16* out, int C,
                                                int nW, int n_windows, int groups, int nh,
                                                uint32_t base, int item0, int stride, int bar) {
  using L = AttFwdSmem;
  {
    const int t64[2] = {L::Q, L::K}, t32[1] = {L::VT};
    att_zero_pads(base, t64, 2, t32, 1);
  }
  const int tile[3] = {L::Q, L::K, -1}, tt[3] = {-1, -1, L::VT};
  for (int it = item0; it < groups * nh; it += stride) {
    const int h = it / groups, grp = it % groups;
    const float* bias_h = bias + (long)h * WIN_N * WIN_N;
    float bm[32];
    int bm_win = -1;
    AttChunks<3> ch;
    if (grp < n_windows) ch.load(qkv, nullptr, (long)grp * WIN_N, C, h);
    for (int win = grp; win < n_windows; win += groups) {
      const long row0 = (long)win * WIN_N;
      const int mw = mask != nullptr ? win % nW : 0;
      if (mw != bm_win) {
        att_bias(bias_h, mask != nullptr ? mask + (long)mw * WIN_N * WIN_N : nullptr, bm);
        bm_win = mw;
      }
      named_barrier(bar, ATT_THREADS);  // the previous window's wgmma reads are done
      ch.store(base, tile, tt);
      if (win + groups < n_windows) ch.load(qkv, nullptr, row0 + (long)groups * WIN_N, C, h);
      fence_async_shared();
      named_barrier(bar, ATT_THREADS);
      float p[32];
      att_scores_exact(base + L::Q, base + L::K, bm, p);
      uint32_t pa[4][4];
      att_frags(p, pa);
      float o[16] = {};
      fence_regs(o);  // defined before the pipeline stage, or ptxas serialises it
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs32(o, pa[kk], desc_sw128(base + L::VT) + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      float cs[6] = {};
      att_store_head(o, out + row0 * C + h * HD, C, cs);
    }
  }
}

// ---------------------------------------------------------------------------
// the GEMM

enum FwdEpi { F_OUT = 0, F_RES = 1, F_BRANCH = 2, F_ADAPT_OUT = 3 };
// bytes of a staged value: float32 for K4's forms, else bf16
__host__ __device__ constexpr int fwd_elem(int epi) { return epi >= F_BRANCH ? 4 : 2; }
// K4's float32 forms run at this tile width only: wider, their row operands
// and accumulators spilled (ptxas: F_BRANCH 76 B at 128, 548 B at 192;
// F_ADAPT_OUT 600 B at 128) and ran slower at every stage width
constexpr int FW_BN_F32 = 64;
constexpr int FW_BM = 128;  // two consumer warpgroups of 64 rows
constexpr int FW_BK = 64;   // one 128-byte swizzle row of bf16
constexpr int FW_THREADS = 384;
constexpr int FW_A_BYTES = FW_BM * FW_BK * 2;
constexpr int FW_RING_BUDGET = 230400;  // what the ring and its staged rows may take

struct FwdGemm {
  int M, N;            // output rows and columns
  int kb;              // k-blocks of 64 (K rounded up)
  int wd;              // W's depth coordinate (3-D weight maps), -1 for a 2-D map
  const float* bias;   // (N) or null
  int gelu;            // F_OUT: GELU after the bias
  bf16* out;           // (rows, N)
  const bf16* resid;   // F_RES: (rows, N) at the output row
  const float* scale;  // F_RES: the image's scale (stride 2; image = row / g.L), or null
  int map;             // MAP_NONE or MAP_WIN_TO_TOK: where row r goes
  RowMap g;
  // K4's forms; scale then points at the masks' column, read unrounded
  float* out_f32;      // F_BRANCH: y (rows, N) float32
  const bf16* add;     // F_BRANCH: a (rows, N) at the output row (resid: x)
  const float* y32;    // F_ADAPT_OUT: y (rows, N) float32 at the output row
  const float* bias1;  // F_ADAPT_OUT: the second chain's bias (N)
  float s;             // F_BRANCH, F_ADAPT_OUT: the adapter scalar
  int kb1;             // F_ADAPT_OUT: k-blocks of the second chain
};

// the ring of one GEMM launch (or of K11's launch): stage s at base + s
// stage, a full and an empty mbarrier per stage 8 bytes apart, and this
// role's position in it
struct Ring {
  uint32_t base, stage, full, empty;
  int S;
  int s;
  uint32_t ph;
  __device__ __forceinline__ void next() {
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
  }
};

// the staged output rows of one tile width: the 2 x 64 rows' byte offsets
// in the output, for this tile and the one before (2048 bytes), then 64
// rows of BN values of ELEM bytes (bf16, or float32 for K4's forms; + 16
// bytes, so the accumulator layout's writes miss each other's banks) for
// each consumer warpgroup
template <int BN, int ELEM = 2>
struct FwdStage {
  static constexpr int SROW = BN * ELEM + 16;
  static constexpr int BYTES = 2048 + 2 * 64 * SROW;
};

// a GEMM launch at tile width BN: the ring (as deep as fits, at most 6),
// the staged rows, the mbarriers, 1024 bytes of alignment
template <int BN, int ELEM = 2>
struct FwdTile {
  static constexpr int STAGE = FW_A_BYTES + BN * FW_BK * 2;
  static constexpr int STAGES_FIT = (FW_RING_BUDGET - FwdStage<BN, ELEM>::BYTES) / STAGE;
  static constexpr int STAGES = STAGES_FIT > 6 ? 6 : STAGES_FIT;
  static constexpr int SMEM = STAGES * STAGE + FwdStage<BN, ELEM>::BYTES + 16 * STAGES + 1024;
  static_assert(STAGES >= 2 && SMEM <= 232448, "ring of at least 2 stages in 227 KB");
};

template <int BN>
__device__ __forceinline__ int gemm_tiles(const FwdGemm& a, int* tiles_n) {
  *tiles_n = (a.N + BN - 1) / BN;
  return (a.M + FW_BM - 1) / FW_BM * *tiles_n;
}

// the TMA boxes of k-block kb of tile `it` into the ring's next stage: A
// (128 x 64) and W's 64 x 64 boxes, those wholly past N not loaded (their
// columns are never stored)
template <int BN>
__device__ __forceinline__ void gemm_issue(const CUtensorMap* ta, const CUtensorMap* tw,
                                           const FwdGemm& a, Ring& r, int it, int kb, int tiles_n) {
  const int m0 = it / tiles_n * FW_BM, n0 = it % tiles_n * BN;
  const int boxes = min(BN / 64, (a.N - n0 + 63) / 64);
  const uint32_t bar = r.full + 8 * r.s;
  mbar_expect_tx(bar, FW_A_BYTES + boxes * 8192);
  const uint32_t sa = r.base + r.s * r.stage, sb = sa + FW_A_BYTES;
  tma_load_2d(sa, ta, kb * FW_BK, m0, bar);
  for (int b = 0; b < boxes; ++b) {
    if (a.wd < 0)
      tma_load_2d(sb + b * 8192, tw, n0 + 64 * b, kb * FW_BK, bar);
    else
      tma_load_3d(sb + b * 8192, tw, n0 + 64 * b, kb * FW_BK, a.wd, bar);
  }
  r.next();
}

// producer (one thread): the tiles item0, item0 + stride, ..., every
// k-block through the ring
template <int BN>
__device__ __forceinline__ void gemm_produce(const CUtensorMap* ta, const CUtensorMap* tw,
                                             const FwdGemm& a, Ring& r, int item0, int stride) {
  int tiles_n;
  const int tiles = gemm_tiles<BN>(a, &tiles_n);
  for (int it = item0; it < tiles; it += stride) {
    for (int kb = 0; kb < a.kb; ++kb) {
      mbar_wait(r.empty + 8 * r.s, r.ph ^ 1);
      gemm_issue<BN>(ta, tw, a, r, it, kb, tiles_n);
    }
  }
}

// producer of F_ADAPT_OUT: each tile's k-blocks of (ta, tw), then those of
// the second chain (ta1, tw1), through one ring
template <int BN>
__device__ __forceinline__ void gemm_produce_two(const CUtensorMap* ta, const CUtensorMap* tw,
                                                 const CUtensorMap* ta1, const CUtensorMap* tw1,
                                                 const FwdGemm& a, Ring& r, int item0,
                                                 int stride) {
  int tiles_n;
  const int tiles = gemm_tiles<BN>(a, &tiles_n);
  for (int it = item0; it < tiles; it += stride) {
    for (int kb = 0; kb < a.kb + a.kb1; ++kb) {
      mbar_wait(r.empty + 8 * r.s, r.ph ^ 1);
      if (kb < a.kb)
        gemm_issue<BN>(ta, tw, a, r, it, kb, tiles_n);
      else
        gemm_issue<BN>(ta1, tw1, a, r, it, kb - a.kb, tiles_n);
    }
  }
}

// the row operands of K4's float32 forms for the chunks of the tile at
// (m0, n0) that this consumer thread copies out (four float32 columns a
// chunk, at element eo of the row; the forms take no row map): x and a
// (F_BRANCH) or y (F_ADAPT_OUT) as 32-bit words, and the mask of the row's
// image. Loaded all at once, before any of the tile's stores.
template <int BN, int EPI>
__device__ __forceinline__ void fwd_row_operands(const FwdGemm& a, int m0, int n0,
                                                 uint32_t (&op)[BN / 8][4], float (&mk)[BN / 8]) {
  constexpr int CPR = BN / 4;  // 16-byte chunks a staged float32 row
  const int wg = threadIdx.x / 128, tl = threadIdx.x % 128;
  const int valid = min(BN, a.N - n0) / 4;
#pragma unroll
  for (int k = 0; k < BN / 8; ++k) {
    const int idx = tl + 128 * k, lr = idx / CPR, ck = idx % CPR, row = m0 + wg * 64 + lr;
    if (row >= a.M || ck >= valid) continue;
    const long eo = (long)row * a.N + n0 + 4 * ck;
    mk[k] = a.scale[2 * (row / a.g.L)];
    if constexpr (EPI == F_BRANCH) {
      const uint2 xv = *reinterpret_cast<const uint2*>(a.resid + eo);
      const uint2 av = *reinterpret_cast<const uint2*>(a.add + eo);
      op[k][0] = xv.x, op[k][1] = xv.y, op[k][2] = av.x, op[k][3] = av.y;
    } else {
      const uint4 yv = *reinterpret_cast<const uint4*>(a.y32 + eo);
      op[k][0] = yv.x, op[k][1] = yv.y, op[k][2] = yv.z, op[k][3] = yv.w;
    }
  }
}

// consumers (warpgroups 0 and 1, 64 rows each of every tile): the
// mainloop (F_ADAPT_OUT: then the second chain's into acc1), then the
// epilogue through the staged rows at stg (FwdStage<BN, fwd_elem(EPI)>, at
// a 1024-byte boundary). The tile's row offsets are written before its
// mainloop, into the half of the offsets the tile before did not use; the
// residual (F_RES) is loaded while the rows are staged. The float32 forms
// (width FW_BN_F32) load their row operands (fwd_row_operands) before the
// mainloop, so the loads complete under it.
template <int BN, int EPI>
__device__ __forceinline__ void gemm_consume(const FwdGemm& a, Ring& r, uint32_t stg, int item0,
                                             int stride) {
  constexpr int ELEM = fwd_elem(EPI);
  using SG = FwdStage<BN, ELEM>;
  constexpr int CPR = BN * ELEM / 16;  // 16-byte chunks a staged row
  constexpr int CPT = 64 * CPR / 128;  // chunks a thread copies out
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tl = threadIdx.x % 128;
  const uint32_t my = stg + 2048 + wg * 64 * SG::SROW;
  extern __shared__ unsigned char smem_raw[];
  long* offs = reinterpret_cast<long*>(smem_raw + (stg - smem_u32(smem_raw))) + wg * 64;
  int tiles_n;
  const int tiles = gemm_tiles<BN>(a, &tiles_n);
  float acc[BN / 2];
  float acc1[EPI == F_ADAPT_OUT ? BN / 2 : 1];
  int parity = 0;
  for (int it = item0; it < tiles; it += stride, parity ^= 1) {
    const int m0 = it / tiles_n * FW_BM, n0 = it % tiles_n * BN;
    long* myoff = offs + parity * 128;
    if (tl < 64) {  // read after the barrier below, which follows the mainloop
      const int row = m0 + wg * 64 + tl;
      int o = -1;
      if (row < a.M) o = a.map == MAP_WIN_TO_TOK ? window_token(a.g, row) : row;
      myoff[tl] = o < 0 ? -1L : ((long)o * a.N + n0) * 2;
    }
    // K4's float32 forms: their row operands, loaded before the mainloop
    uint32_t op[ELEM == 4 ? CPT : 1][4];
    float mk[ELEM == 4 ? CPT : 1];
    if constexpr (ELEM == 4) fwd_row_operands<BN, EPI>(a, m0, n0, op, mk);
    int prev = -1;
    for (int kb = 0; kb < a.kb; ++kb) {
      mbar_wait(r.full + 8 * r.s, r.ph);
      const uint32_t sa = r.base + r.s * r.stage, sb = sa + FW_A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FW_BK / 16; ++kk)
        wgmma_ss<BN, 1>(acc, desc_sw128(sa + wg * 64 * 128) + 2 * kk,
                        desc_sw128_mn(sb, 8192) + 128 * kk, kb > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the group before this one has retired: its stage is free
      if (prev >= 0 && lane == 0) mbar_arrive(r.empty + 8 * prev);
      prev = r.s;
      r.next();
    }
    if constexpr (EPI == F_ADAPT_OUT) {
      for (int kb = 0; kb < a.kb1; ++kb) {
        mbar_wait(r.full + 8 * r.s, r.ph);
        const uint32_t sa = r.base + r.s * r.stage, sb = sa + FW_A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < FW_BK / 16; ++kk)
          wgmma_ss<BN, 1>(acc1, desc_sw128(sa + wg * 64 * 128) + 2 * kk,
                          desc_sw128_mn(sb, 8192) + 128 * kk, kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(r.empty + 8 * prev);
        prev = r.s;
        r.next();
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (EPI == F_ADAPT_OUT) fence_regs(acc1);
    if (lane == 0 && prev >= 0) mbar_arrive(r.empty + 8 * prev);

    // epilogue: this thread's rows of the output (-1 past M), columns
    // n0 + 8 j + 2 (lane % 4)
    int srow[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * half;
      srow[half] = row < a.M ? row : -1;
    }
    // the previous tile's rows have been copied out; this tile's offsets
    // are written
    named_barrier(1 + wg, 128);
    const int valid = min(BN, a.N - n0) * ELEM / 16;
    Pack8 res[EPI == F_RES ? CPT : 1];
    if constexpr (EPI == F_RES) {
      const char* rp = reinterpret_cast<const char*>(a.resid);
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int idx = tl + 128 * k, lr = idx / CPR, ck = idx % CPR;
        const long off = myoff[lr];
        if (off >= 0 && ck < valid) res[k].u = *reinterpret_cast<const uint4*>(rp + off + 16 * ck);
      }
    }
    float sc[2] = {1.f, 1.f};
    if (EPI == F_RES && a.scale != nullptr) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (srow[half] >= 0) sc[half] = round_bf(a.scale[2 * (srow[half] / a.g.L)]);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = 8 * j + 2 * (lane % 4), c = n0 + cl;
      float2 bv = make_float2(0.f, 0.f), bv1 = make_float2(0.f, 0.f);
      if (a.bias != nullptr && c < a.N) bv = *reinterpret_cast<const float2*>(a.bias + c);
      if (EPI == F_ADAPT_OUT && c < a.N) bv1 = *reinterpret_cast<const float2*>(a.bias1 + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half, lr = warp * 16 + lane / 4 + 8 * half;
        float v0 = acc[i] + bv.x, v1 = acc[i + 1] + bv.y;
        if constexpr (EPI == F_OUT) {
          if (a.gelu) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          }
        } else if constexpr (EPI == F_RES) {
          v0 = round_bf(v0);
          v1 = round_bf(v1);
          if (a.scale != nullptr) {
            v0 = sc[half] * v0;
            v1 = sc[half] * v1;
          }
        } else if constexpr (EPI == F_BRANCH) {  // s (acc + b)
          v0 = __fmul_rn(a.s, v0);
          v1 = __fmul_rn(a.s, v1);
        } else {  // F_ADAPT_OUT: (acc + b) + s (acc1 + b1)
          v0 = __fadd_rn(v0, __fmul_rn(a.s, acc1[i] + bv1.x));
          v1 = __fadd_rn(v1, __fmul_rn(a.s, acc1[i + 1] + bv1.y));
        }
        if constexpr (ELEM == 2) {
          st_shared_b32(my + lr * SG::SROW + cl * 2, pack_bf16(v0, v1));
        } else {
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(my + lr * SG::SROW + cl * 4),
                       "f"(v0), "f"(v1));
        }
      }
    }
    named_barrier(1 + wg, 128);
    // the warpgroup's 64 rows out, 16 bytes a lane (+ the residual, F_RES)
    if constexpr (ELEM == 2) {
      char* dst = reinterpret_cast<char*>(a.out);
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int idx = tl + 128 * k, lr = idx / CPR, ck = idx % CPR;
        const long off = myoff[lr];
        if (off < 0 || ck >= valid) continue;
        Pack8 v;
        v.u = ld_shared_v4(my + lr * SG::SROW + 16 * ck);
        if constexpr (EPI == F_RES) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v.h[e] = f2bf(bf2f(res[k].h[e]) + bf2f(v.h[e]));
        }
        *reinterpret_cast<uint4*>(dst + off + 16 * ck) = v.u;
      }
    } else {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int idx = tl + 128 * k, lr = idx / CPR, ck = idx % CPR, row = m0 + wg * 64 + lr;
        if (row >= a.M || ck >= valid) continue;
        const long eo = (long)row * a.N + n0 + 4 * ck;
        const uint4 u = ld_shared_v4(my + lr * SG::SROW + 16 * ck);
        const float t[4] = {__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                            __uint_as_float(u.w)};
        if constexpr (EPI == F_BRANCH) {  // y = x + m0 (a + s (acc + b))
          const bf16* xh = reinterpret_cast<const bf16*>(&op[k][0]);
          const bf16* ah = reinterpret_cast<const bf16*>(&op[k][2]);
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[e] = __fadd_rn(bf2f(xh[e]), __fmul_rn(mk[k], __fadd_rn(bf2f(ah[e]), t[e])));
          *reinterpret_cast<float4*>(a.out_f32 + eo) = make_float4(y[0], y[1], y[2], y[3]);
        } else {  // out = bf16(y + m1 mo)
          union { uint2 u; bf16 h[4]; } o;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o.h[e] = f2bf(__fadd_rn(__uint_as_float(op[k][e]), __fmul_rn(mk[k], t[e])));
          *reinterpret_cast<uint2*>(a.out + eo) = o.u;
        }
      }
    }
  }
}

inline bool bad_bn(int bn) { return bn != 64 && bn != 128 && bn != 192; }

// W (depth, K, N) bf16 row-major as a 3-D map in 64 x 64 boxes of one depth
// (zeros past K within a depth)
inline cudaError_t tmap_w3(CUtensorMap* map, const bf16* base, int depth, int K, int N) {
  const uint64_t dims[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                            static_cast<uint64_t>(depth)};
  const uint64_t strides[2] = {static_cast<uint64_t>(N) * 2, static_cast<uint64_t>(K) * N * 2};
  const uint32_t box[3] = {64, 64, 1};
  return make_tmap(map, base, 3, dims, strides, box);
}

// ---------------------------------------------------------------------------
// K2's and K4's kernels: one phase a launch

template <int MODE, typename T = bf16>
__global__ void __launch_bounds__(LN_THREADS) ln_rows_kernel(const T* __restrict__ x,
                                                             const float* __restrict__ w,
                                                             const float* __restrict__ b,
                                                             bf16* __restrict__ h, int rows,
                                                             RowMap g) {
  ln_rows_any<MODE, T>(x, w, b, h, rows, g, (blockIdx.x * LN_THREADS + threadIdx.x) / 32,
                       gridDim.x * (LN_THREADS / 32));
}

__global__ void __launch_bounds__(ATT_THREADS, 3) attention_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ mask,
    bf16* __restrict__ out, int C, int nW, int n_windows, int groups, int nh) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  attention_items(qkv, bias, mask, out, C, nW, n_windows, groups, nh, base, blockIdx.x, gridDim.x,
                  1);
}

// the ring's mbarriers of a GEMM launch (thread 0), and the ring
template <int BN, int EPI>
__device__ __forceinline__ Ring fwd_ring(int S, uint32_t* stg) {
  using T = FwdTile<BN, fwd_elem(EPI)>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  *stg = base + T::STAGES * T::STAGE;
  const uint32_t full = *stg + FwdStage<BN, fwd_elem(EPI)>::BYTES, empty = full + 8 * T::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  return Ring{base, static_cast<uint32_t>(T::STAGE), full, empty, S, 0, 0};
}

template <int BN, int EPI>
__global__ void __launch_bounds__(FW_THREADS, 1)
    fwd_gemm(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
             const FwdGemm a, int S) {
  uint32_t stg;
  Ring r = fwd_ring<BN, EPI>(S, &stg);
  if (threadIdx.x >= 256) {  // the producer warpgroup: thread 256 feeds the ring
    if (threadIdx.x == 256) gemm_produce<BN>(&ta, &tw, a, r, blockIdx.x, gridDim.x);
  } else {
    gemm_consume<BN, EPI>(a, r, stg, blockIdx.x, gridDim.x);
  }
}

// F_ADAPT_OUT: the two chains (ta, tw) and (ta1, tw1) on one ring
template <int BN>
__global__ void __launch_bounds__(FW_THREADS, 1)
    fwd_gemm_two(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap ta1, const __grid_constant__ CUtensorMap tw1,
                 const FwdGemm a, int S) {
  uint32_t stg;
  Ring r = fwd_ring<BN, F_ADAPT_OUT>(S, &stg);
  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) gemm_produce_two<BN>(&ta, &tw, &ta1, &tw1, a, r, blockIdx.x, gridDim.x);
  } else {
    gemm_consume<BN, F_ADAPT_OUT>(a, r, stg, blockIdx.x, gridDim.x);
  }
}

// host: the LN rows of `rows` rows, a warp each (x bf16, or float32)
template <int MODE, typename T = bf16>
cudaError_t ln_rows_launch(const T* x, const float* w, const float* b, bf16* h, int rows,
                           const RowMap& g, cudaStream_t stream) {
  const int per = LN_THREADS / 32 * ln_rows_per_warp(MODE == LN_MERGE ? 4 * g.C : g.C, MODE);
  ln_rows_kernel<MODE, T><<<(rows + per - 1) / per, LN_THREADS, 0, stream>>>(x, w, b, h, rows,
                                                                            g);
  return cudaGetLastError();
}

// host: the window attention, (window group, head) items a block each
inline cudaError_t attention_launch(const bf16* qkv, const float* bias, const float* mask,
                                    bf16* out, int C, int nh, int nW, int n_windows,
                                    cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       AttFwdSmem::SMEM);
  if (e != cudaSuccess) return e;
  const int groups = att_groups(n_windows, nh);
  attention_kernel<<<groups * nh, ATT_THREADS, AttFwdSmem::SMEM, stream>>>(
      qkv, bias, mask, out, C, nW, n_windows, groups, nh);
  return cudaGetLastError();
}

// host: out = A (M, K) . W (K, N) with epilogue EPI, one persistent block
// a SM (or a tile); stages 0: as deep as fits
template <int BN, int EPI>
cudaError_t fwd_gemm_launch(const bf16* A, const bf16* Wt, int K, FwdGemm a, int stages,
                            cudaStream_t stream) {
  using T = FwdTile<BN, fwd_elem(EPI)>;
  CUtensorMap ta, tw;
  cudaError_t e = tmap(&ta, A, a.M, K, FW_BM);
  if (e == cudaSuccess) e = tmap(&tw, Wt, K, a.N, 64);
  if (e != cudaSuccess) return e;
  a.kb = (K + FW_BK - 1) / FW_BK;
  a.wd = -1;
  const int S = stages > 0 ? std::min(stages, T::STAGES) : T::STAGES;
  auto kernel = fwd_gemm<BN, EPI>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = (a.M + FW_BM - 1) / FW_BM * ((a.N + BN - 1) / BN);
  kernel<<<std::min(tiles, sm_count()), FW_THREADS, T::SMEM, stream>>>(ta, tw, a, S);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t fwd_gemm_bn(int bn, const bf16* A, const bf16* Wt, int K, const FwdGemm& a,
                        int stages, cudaStream_t stream) {
  switch (bn) {
    case 64: return fwd_gemm_launch<64, EPI>(A, Wt, K, a, stages, stream);
    case 128: return fwd_gemm_launch<128, EPI>(A, Wt, K, a, stages, stream);
    case 192: return fwd_gemm_launch<192, EPI>(A, Wt, K, a, stages, stream);
    default: return cudaErrorInvalidValue;
  }
}

// host: F_ADAPT_OUT, A (M, K) . W (K, N) and A1 (M, K1) . W1 (K1, N) on one
// tile of FW_BN_F32 columns (two accumulators a thread); a template, so only
// the sources that launch it compile its kernel
template <int BN = FW_BN_F32>
cudaError_t fwd_gemm_two_launch(const bf16* A, const bf16* Wt, int K, const bf16* A1,
                                const bf16* W1, int K1, FwdGemm a, int stages,
                                cudaStream_t stream) {
  using T = FwdTile<BN, fwd_elem(F_ADAPT_OUT)>;
  CUtensorMap ta, tw, ta1, tw1;
  cudaError_t e = tmap(&ta, A, a.M, K, FW_BM);
  if (e == cudaSuccess) e = tmap(&tw, Wt, K, a.N, 64);
  if (e == cudaSuccess) e = tmap(&ta1, A1, a.M, K1, FW_BM);
  if (e == cudaSuccess) e = tmap(&tw1, W1, K1, a.N, 64);
  if (e != cudaSuccess) return e;
  a.kb = (K + FW_BK - 1) / FW_BK;
  a.kb1 = (K1 + FW_BK - 1) / FW_BK;
  a.wd = -1;
  const int S = stages > 0 ? std::min(stages, T::STAGES) : T::STAGES;
  auto kernel = fwd_gemm_two<BN>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = (a.M + FW_BM - 1) / FW_BM * ((a.N + BN - 1) / BN);
  kernel<<<std::min(tiles, sm_count()), FW_THREADS, T::SMEM, stream>>>(ta, tw, ta1, tw1, a, S);
  return cudaGetLastError();
}

// the tile choices a call passes (ops/swin_block.py TILES): the tile width
// of each GEMM and the ring depth (0: as deep as fits)
struct FwdTiles {
  int qkv, proj, fc1, fc2, merge, stages;
};

inline bool bad_tiles(const FwdTiles& t) {
  return bad_bn(t.qkv) || bad_bn(t.proj) || bad_bn(t.fc1) || bad_bn(t.fc2) || bad_bn(t.merge) ||
         t.stages < 0 || t.stages == 1;
}

// the shapes K2 and K11 take: 8x8 windows, head dim 24, C % 32 == 0 and C
// <= 768, hidden % 8 == 0, whole windows
inline bool bad_block(int H, int W, int C, int nh, int win, int hidden) {
  return win * win != WIN_N || nh < 1 || C % nh || C / nh != HD || C % 32 || C > 768 ||
         hidden < 8 || hidden % 8 || H % win || W % win;
}

}  // namespace
