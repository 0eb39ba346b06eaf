// The Swin block backward layer for Hopper (sm_90a), shared by K3
// (swin_block_bwd.cu) and K5 (swin_block_adapt_bwd.cu): a persistent,
// TMA-fed, warp-specialised wgmma GEMM in the operand forms the backward
// needs, the window attention forward and backward on wgmma, the LayerNorm
// and row passes, and one ordered reduction of every split partial. Built on
// the primitives of sm90_gemm.cuh (TMA, mbarrier rings, wgmma, setmaxnreg).
// The forward layer swin_fwd_sm90.cuh (K2, K11, K4) includes this one for
// its row maps, its window attention helpers, the shapes and the workspace
// carver; the attention helpers therefore index
// by the thread of the warpgroup (a 128-thread block here, one of a
// 384-thread block's warpgroups in K11).
//
// GEMM forms (bf16 operands, float32 sums; 128 x BN output tiles, one
// consumer warpgroup per 64 rows, a producer warpgroup issuing TMA boxes
// into a ring of stages):
//   NN    out (M, N) = A (M, K) . W, W (K, N) row-major: the recompute h . W
//         (W is wgmma's MN-major, transposed B, in 64-column boxes)
//   NT    out (M, N) = A (M, K) . W^T, W (N, K) row-major: the activation
//         grad dY . W^T (W is the native K-major B)
//   CAT   two NT pairs summed into one accumulator (K5's dh2: df1 fc1^T +
//         df1m ma1^T)
//   DUAL  an NN and an NT pair over the same rows and depth, two
//         accumulators: fc1's recompute and fc2's activation grad, whose
//         epilogue writes bf16(gelu(f1)) and bf16(dfg gelu'(f1)), so the
//         float32 pre-activation never reaches memory (and the adapters'
//         bottlenecks the same way)
//   TT    out (Ka, N) = A^T . dY over the rows, A (rows, Ka), dY (rows, N):
//         the weight grads; both operands M-major (wgmma's transpose bits for
//         A and B), the rows split over the persistent blocks, each split
//         writing a float32 partial (Ka, N) and the partials summed in a
//         fixed order by the final reduction: no float atomics, so a launch
//         repeated gives the same bits.
// Epilogues (the short-K GEMMs of the early stages are bound by them): each
// consumer warpgroup writes its 64 rows, bias/GELU applied and rounded, into
// padded rows in shared memory, then copies them out 16 bytes a lane, two
// whole rows a warp instruction, each row to its place under the row maps
// of the shifted window partition (window-order row -> token, token ->
// window-order row; a cyclic shift cannot be one TMA box, and one bulk copy
// a row queued on the copy engine, or 16-byte stores from the registers
// after a quad transpose, measured slower). Column sums of an epilogue's
// output (bias grads) are summed per 128-row tile in a fixed order (warps in
// order through shared memory) into partials.
//
// Row passes: one warp per row, 8 columns a lane; column sums of their
// outputs (LayerNorm and bias grads) per block of contiguous rows, warps in
// order, into partials. The window attention: one warpgroup per (window,
// head) in turn, Q, K, V, dO (head dim 24, zero-padded to 32 in shared
// memory only) and their transposes staged in 128-byte-swizzled tiles; S =
// Q K^T and dP = dO V^T as m64n64, dV = P^T dO and dk = dS^T Q as m64n32
// with A transposed (P and dS from shared memory), dq = dS K and O = P V
// as m64n32 with A from the registers.
//
// Every function lives in an anonymous namespace, as in sm90_gemm.cuh.

#pragma once

#include "sm90_gemm.cuh"

#include <algorithm>

namespace {

constexpr float LN_EPS = 1e-5f;
constexpr int WIN_N = 64;  // tokens per 8x8 window
constexpr int HD = 24;     // head dim

// token geometry of one block call
struct RowMap {
  int L, H, W, win, shift, C;
};

union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf(float v) { return bf2f(f2bf(v)); }

// row r in window order (image, window, token in window) -> token index in
// the unshifted layout: the window partition of the map rolled by -shift
__device__ __forceinline__ int window_token(const RowMap& g, int r) {
  const int n = g.win * g.win;
  const int b = r / g.L, rr = r - b * g.L;
  const int wid = rr / n, t = rr - wid * n;
  const int nww = g.W / g.win;
  const int wi = wid / nww, wj = wid - wi * nww;
  const int ti = t / g.win, tj = t - ti * g.win;
  int h = wi * g.win + ti + g.shift;
  if (h >= g.H) h -= g.H;
  int w = wj * g.win + tj + g.shift;
  if (w >= g.W) w -= g.W;
  return b * g.L + h * g.W + w;
}

// the inverse: token t -> its window-order row
__device__ __forceinline__ int token_window(const RowMap& g, int t) {
  const int b = t / g.L, tt = t - b * g.L;
  int h = tt / g.W, w = tt - h * g.W;
  h -= g.shift;
  if (h < 0) h += g.H;
  w -= g.shift;
  if (w < 0) w += g.W;
  const int wi = h / g.win, ti = h - wi * g.win;
  const int wj = w / g.win, tj = w - wj * g.win;
  return b * g.L + (wi * (g.W / g.win) + wj) * g.win * g.win + ti * g.win + tj;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (gelu(x), d/dx gelu(x) = Phi(x) + x phi(x)), exact erf form, one erf
__device__ __forceinline__ float2 gelu_pair(float x) {
  const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
  return make_float2(x * cdf, cdf + x * (expf(-0.5f * x * x) * 0.3989422804014327f));
}

// byte offset of element (r, c) of a tile of rows of 64 bf16 (128 bytes)
// in TMA's 128-byte swizzle (16-byte chunk index XOR row % 8)
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void st_shared_b16(uint32_t addr, bf16 v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(*reinterpret_cast<uint16_t*>(&v)));
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w));
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// ---------------------------------------------------------------------------
// the GEMM

enum BwForm { BW_NN = 0, BW_NT = 1, BW_CAT = 2, BW_DUAL = 3, BW_TT = 4 };
// epilogues: bf16 (bias, GELU, row map, column sums), float32, the dual
// GELU pair, bf16(m0 add + acc) stored through the token -> window map, and
// float32 partials of a split
enum BwEpi { E_BF16 = 0, E_F32 = 1, E_DUAL = 2, E_ADD = 3, E_PART = 4 };
enum { MAP_NONE = 0, MAP_WIN_TO_TOK = 1, MAP_TOK_TO_WIN = 2 };

constexpr int BW_BM = 128;  // two consumer warpgroups of 64 rows
constexpr int BW_BK = 64;   // one 128-byte swizzle row of bf16
constexpr int BW_THREADS = 384;
// registers a thread after setmaxnreg (producer 40, consumers 232), from the
// block's own pool: at most 168 a thread at launch, one block per SM
static_assert(40 * 128 + 232 * 256 <= 168 * BW_THREADS, "setmaxnreg within the block's registers");

struct BwArgs {
  int M, N;        // output rows and columns (TT: Ka rows)
  int kb0, kb1;    // k-blocks of pair 0 and (CAT) pair 1
  int rows;        // TT: rows summed
  int rps;         // TT: rows per split (a multiple of BW_BK)
  int splits;      // TT
  int stages;      // ring stages used (<= BwTile::STAGES)
  const float* bias;    // (N) or null
  int gelu;             // E_BF16: GELU after the bias
  int map;              // MAP_*
  RowMap g;
  bf16* out;            // E_BF16, E_DUAL (gelu(f1), or null), E_ADD
  bf16* out1;           // E_DUAL: bf16(acc1 gelu'(f1))
  float* out_f32;       // E_F32, E_PART (+ split * M * N)
  float* colsum;        // (tiles_m, N) column sums of the rounded out (E_BF16,
                        // E_ADD) or out1 (E_DUAL), or null
  const float* add;     // E_ADD: (tokens, N) float32
  const float* masks;   // E_ADD: (B, 2), m0 = masks[2 b]
};

// shared memory of a form and epilogue: the ring, the per-warp column sums,
// the staged output rows of both consumer warpgroups (64 rows each, padded
// by 16 bytes so the accumulator layout's writes miss each other's banks;
// two outputs for E_DUAL, none for E_PART) and their rows' global offsets,
// the mbarriers
template <int BN, int FORM, int EPI>
struct BwTile {
  static constexpr bool TWO = FORM == BW_DUAL;  // two pairs per stage
  static constexpr int A_BYTES = BW_BM * BW_BK * 2;
  static constexpr int B_BYTES = BN * BW_BK * 2;
  static constexpr int STAGE = (TWO ? 2 : 1) * (A_BYTES + B_BYTES);
  static constexpr int RED_BYTES = 8 * BN * 4;  // per-warp column sums
  static constexpr int OUTS = EPI == E_DUAL ? 2 : EPI == E_PART ? 0 : 1;
  static constexpr int ELEM = EPI == E_F32 ? 4 : 2;
  static constexpr int SROW = BN * ELEM + 16;          // a staged row's stride, bytes
  static constexpr int STG = 2 * OUTS * 64 * SROW + 2 * 64 * 8;  // + the row offsets
  static constexpr int STAGES_FIT = (230400 - RED_BYTES - STG) / STAGE;
  static constexpr int STAGES = STAGES_FIT > 6 ? 6 : STAGES_FIT;
  static constexpr int SMEM = STAGES * STAGE + RED_BYTES + STG + 8 * 2 * STAGES + 1024;
  static_assert(STAGES >= 2 && SMEM <= 232448, "ring of at least 2 stages in 227 KB");
};

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// one k16 step of the forms' wgmma on stage addresses a (A) and b (B)
template <int BN, int FORM, bool PAIR1>
__device__ __forceinline__ void bw_mma(float (&acc)[BN / 2], uint32_t a, uint32_t b, int wg,
                                       int kk, int accumulate) {
  constexpr bool B_MN = FORM == BW_NN || FORM == BW_TT || (FORM == BW_DUAL && !PAIR1);
  if constexpr (FORM == BW_TT) {
    // A^T: the warpgroup's 64 Ka columns are box wg (64 rows of M x 128 B)
    const uint64_t da = desc_sw128_mn(a + wg * 8192, 8192) + 128 * kk;
    const uint64_t db = desc_sw128_mn(b, 8192) + 128 * kk;
    wgmma_ss<BN, 1, 1>(acc, da, db, accumulate);
  } else {
    const uint64_t da = desc_sw128(a + wg * 64 * 128) + 2 * kk;
    if constexpr (B_MN) {
      wgmma_ss<BN, 1>(acc, da, desc_sw128_mn(b, 8192) + 128 * kk, accumulate);
    } else {
      wgmma_ss<BN, 0>(acc, da, desc_sw128(b) + 2 * kk, accumulate);
    }
  }
}

template <int BN, int FORM, int EPI>
__global__ void __launch_bounds__(BW_THREADS, 1)
    bw_gemm(const __grid_constant__ CUtensorMap ta0, const __grid_constant__ CUtensorMap tb0,
            const __grid_constant__ CUtensorMap ta1, const __grid_constant__ CUtensorMap tb1,
            const BwArgs args) {
  using T = BwTile<BN, FORM, EPI>;
  constexpr bool TWO = T::TWO;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t red = base + T::STAGES * T::STAGE;
  const uint32_t stg0 = red + T::RED_BYTES;
  const uint32_t full = stg0 + T::STG, empty = full + 8 * T::STAGES;
  float* red_f = reinterpret_cast<float*>(smem_raw + (red - smem_u32(smem_raw)));
  const int wg = threadIdx.x / 128;
  const int tiles_n = (args.N + BN - 1) / BN;
  const int tiles = (args.M + BW_BM - 1) / BW_BM * tiles_n;
  const int items = FORM == BW_TT ? tiles * args.splits : tiles;
  const int kblocks_all = args.kb0 + (FORM == BW_CAT ? args.kb1 : 0);

  const int S = args.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the item's tile origin and k-block range
  auto item_geom = [&](int it, int& m0, int& n0, int& k0, int& kbs) {
    const int t = FORM == BW_TT ? it % tiles : it;
    m0 = t / tiles_n * BW_BM;
    n0 = t % tiles_n * BN;
    if (FORM == BW_TT) {
      const int split = it / tiles;
      k0 = split * args.rps;
      const int k1 = min(args.rows, k0 + args.rps);
      kbs = (k1 - k0 + BW_BK - 1) / BW_BK;
    } else {
      k0 = 0;
      kbs = kblocks_all;
    }
  };

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int m0, n0, k0, kbs;
        item_geom(it, m0, n0, k0, kbs);
        for (int kb = 0; kb < kbs; ++kb) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, T::STAGE);
          const uint32_t sa = base + s * T::STAGE, sb = sa + T::A_BYTES;
          const uint32_t bar = full + 8 * s;
          if constexpr (FORM == BW_TT) {
            const int kr = k0 + kb * BW_BK;
            tma_load_2d(sa, &ta0, m0, kr, bar);
            tma_load_2d(sa + 8192, &ta0, m0 + 64, kr, bar);
#pragma unroll
            for (int b = 0; b < BN / 64; ++b) tma_load_2d(sb + b * 8192, &tb0, n0 + 64 * b, kr, bar);
          } else {
            const bool second = FORM == BW_CAT && kb >= args.kb0;
            const int kc = (second ? kb - args.kb0 : kb) * BW_BK;
            const CUtensorMap* ma = second ? &ta1 : &ta0;
            const CUtensorMap* mb = second ? &tb1 : &tb0;
            tma_load_2d(sa, ma, kc, m0, bar);
            if (FORM == BW_NN || FORM == BW_DUAL) {
#pragma unroll
              for (int b = 0; b < BN / 64; ++b) tma_load_2d(sb + b * 8192, mb, n0 + 64 * b, kc, bar);
            } else {
              tma_load_2d(sb, mb, kc, n0, bar);
            }
            if constexpr (TWO) {
              const uint32_t sa1 = sb + T::B_BYTES, sb1 = sa1 + T::A_BYTES;
              tma_load_2d(sa1, &ta1, kc, m0, bar);
              tma_load_2d(sb1, &tb1, kc, n0, bar);
            }
          }
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float acc[BN / 2];
    float acc1[TWO ? BN / 2 : 2];
    int s = 0;
    uint32_t ph = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      int m0, n0, k0, kbs;
      item_geom(it, m0, n0, k0, kbs);
      int prev = -1;
      for (int kb = 0; kb < kbs; ++kb) {
        mbar_wait(full + 8 * s, ph);
        const uint32_t sa = base + s * T::STAGE, sb = sa + T::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BW_BK / 16; ++kk) {
          bw_mma<BN, FORM, false>(acc, sa, sb, wg, kk, kb > 0 || kk > 0);
          if constexpr (TWO)
            bw_mma<BN, FORM, true>(acc1, sb + T::B_BYTES, sb + T::B_BYTES + T::A_BYTES, wg, kk,
                                   kb > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (TWO) fence_regs(acc1);
      if (lane == 0 && prev >= 0) mbar_arrive(empty + 8 * prev);
      if (kbs == 0) {  // an empty split: zeros
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      }

      // epilogue: this thread's rows srow[0], srow[1] of the output (-1 past
      // M), columns n0 + 8 j + 2 (lane % 4)
      int srow[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * half;
        srow[half] = r < args.M ? r : -1;
      }
      const bool sums = args.colsum != nullptr;
      float cs[BN / 4];  // this thread's column sums over its two rows
#pragma unroll
      for (int k = 0; k < BN / 4; ++k) cs[k] = 0.f;
      const int tl = threadIdx.x % 128;  // thread of the warpgroup
      if constexpr (EPI != E_PART) {
        // staged: values (rounded for bf16; column sums of the rounded ones)
        // into the warpgroup's padded rows in shared memory, each row's global
        // offset (through the row map) beside them, then the warpgroup copies
        // the rows out, 16 bytes a lane, two whole rows a warp instruction
        const uint32_t my = stg0 + wg * (T::OUTS * 64 * T::SROW);
        long* rowoff = reinterpret_cast<long*>(
            smem_raw + (stg0 + 2 * T::OUTS * 64 * T::SROW - smem_u32(smem_raw))) + wg * 64;
        named_barrier(1 + wg, 128);  // the previous tile's rows have been copied out
        if (tl < 64) {
          const int r = m0 + wg * 64 + tl;
          int o = -1;
          if (r < args.M) {
            o = r;
            if (args.map == MAP_WIN_TO_TOK) o = window_token(args.g, r);
            if (args.map == MAP_TOK_TO_WIN) o = token_window(args.g, r);
          }
          rowoff[tl] = o < 0 ? -1L : ((long)o * args.N + n0) * T::ELEM;
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int cl = 8 * j + 2 * (lane % 4), c = n0 + cl;
          const bool cok = c < args.N;
          float2 bv = make_float2(0.f, 0.f);
          if (EPI != E_ADD && args.bias != nullptr && cok)
            bv = *reinterpret_cast<const float2*>(args.bias + c);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 4 * j + 2 * half, lr = warp * 16 + lane / 4 + 8 * half;
            const bool ok = cok && srow[half] >= 0;
            const uint32_t at = my + lr * T::SROW + cl * T::ELEM;
            float v0 = acc[i] + bv.x, v1 = acc[i + 1] + bv.y;
            if constexpr (EPI == E_F32) {
              asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(v0), "f"(v1));
            } else {
              __nv_bfloat162 pk, sp;
              if constexpr (EPI == E_BF16) {
                if (args.gelu) {
                  v0 = gelu_erf(v0);
                  v1 = gelu_erf(v1);
                }
                pk = sp = __floats2bfloat162_rn(v0, v1);
              } else if constexpr (EPI == E_DUAL) {
                const float2 g0 = gelu_pair(v0), g1 = gelu_pair(v1);
                pk = __floats2bfloat162_rn(g0.x, g1.x);
                sp = __floats2bfloat162_rn(acc1[i] * g0.y, acc1[i + 1] * g1.y);
                st_shared_b32(at + 64 * T::SROW, *reinterpret_cast<uint32_t*>(&sp));
              } else {  // E_ADD: the source row is a token; m0 of its image
                float2 a = make_float2(0.f, 0.f);
                float m = 0.f;
                if (ok) {
                  const int t = srow[half];
                  m = args.masks[2 * (t / args.g.L)];
                  a = *reinterpret_cast<const float2*>(args.add + (long)t * args.N + c);
                }
                pk = sp = __floats2bfloat162_rn(m * a.x + v0, m * a.y + v1);
              }
              st_shared_b32(at, *reinterpret_cast<uint32_t*>(&pk));
              if (ok) {
                cs[2 * j] += __bfloat162float(sp.x);
                cs[2 * j + 1] += __bfloat162float(sp.y);
              }
            }
          }
        }
        named_barrier(1 + wg, 128);
        constexpr int CPR = BN * T::ELEM / 16;  // 16-byte chunks a row
        const int valid = min(BN, args.N - n0) * T::ELEM / 16;
#pragma unroll
        for (int q = 0; q < T::OUTS; ++q) {
          char* dst = EPI == E_F32 ? reinterpret_cast<char*>(args.out_f32)
                                   : reinterpret_cast<char*>(q == 0 ? args.out : args.out1);
          if (dst == nullptr) continue;
#pragma unroll 4
          for (int idx = tl; idx < 64 * CPR; idx += 128) {
            const int lr = idx / CPR, ck = idx % CPR;
            const long off = rowoff[lr];
            if (off < 0 || ck >= valid) continue;
            *reinterpret_cast<uint4*>(dst + off + 16 * ck) =
                ld_shared_v4(my + (q * 64 + lr) * T::SROW + 16 * ck);
          }
        }
      } else {
        // the split's float32 partial: the quad's 4 x 8 bytes are a whole
        // 32-byte sector of a row
        float* dst = args.out_f32 + (long)(it / tiles) * args.M * args.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = n0 + 8 * j + 2 * (lane % 4);
          if (c >= args.N) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (srow[half] < 0) continue;
            const int i = 4 * j + 2 * half;
            *reinterpret_cast<float2*>(dst + (long)srow[half] * args.N + c) =
                make_float2(acc[i], acc[i + 1]);
          }
        }
      }
      if (EPI != E_F32 && EPI != E_PART && sums) {
        // the tile's column sums: lanes of one column (lane % 4) in the warp,
        // then the 8 warps in order through shared memory
#pragma unroll
        for (int k = 0; k < BN / 4; ++k) {
          float v = cs[k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          cs[k] = v;
        }
        const int w8 = wg * 4 + warp;
        if (lane < 4) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<float2*>(red_f + w8 * BN + 8 * j + 2 * lane) =
                make_float2(cs[2 * j], cs[2 * j + 1]);
        }
        named_barrier(3, 256);
        const int tid = threadIdx.x;
        for (int c = tid; c < BN; c += 256) {
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) v += red_f[w * BN + c];
          if (n0 + c < args.N) args.colsum[(long)(m0 / BW_BM) * args.N + n0 + c] = v;
        }
        named_barrier(3, 256);
      }
    }
  }
}

// a row-major (rows, cols) bf16 matrix in boxes of box_rows x box_cols
inline cudaError_t tmap(CUtensorMap* map, const bf16* base, long rows, long cols, int box_rows,
                        int box_cols = 64) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * sizeof(bf16)};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols), static_cast<uint32_t>(box_rows)};
  return make_tmap(map, base, 2, dims, strides, box);
}

// one GEMM operand pair: A (rows, K) or, for TT, (rows, Ka); B as the form
// reads it; K, the pair's depth (TT: unused)
struct BwPair {
  const bf16* A;
  const bf16* B;
  int K;
};

// the TT split of `rows` over the 128 x BN tiles of (Ka, N): the nearest
// whole number of splits a tile to `items` work items, at least 8 k-blocks
// each (one split writes the output directly); a pure function of the shape
inline void tt_split(int rows, int Ka, int N, int bn, int items, int* rps, int* splits) {
  const int tiles = (Ka + BW_BM - 1) / BW_BM * ((N + bn - 1) / bn);
  int want = (items + tiles / 2) / tiles;
  const int most = std::max(1, rows / (8 * BW_BK));
  want = std::max(1, std::min(want, most));
  int r = (rows + want - 1) / want;
  r = (r + BW_BK - 1) / BW_BK * BW_BK;
  *rps = r;
  *splits = (rows + r - 1) / r;
}

template <int BN, int FORM, int EPI>
cudaError_t bw_gemm_launch(const BwPair& p0, const BwPair& p1, BwArgs a, cudaStream_t stream) {
  using T = BwTile<BN, FORM, EPI>;
  CUtensorMap m[4];
  cudaError_t e = cudaSuccess;
  if (FORM == BW_TT) {
    // A (rows, Ka) and dY (rows, N), 64 x 64 boxes
    e = tmap(&m[0], p0.A, a.rows, a.M, 64);
    if (e == cudaSuccess) e = tmap(&m[1], p0.B, a.rows, a.N, 64);
    m[2] = m[0];
    m[3] = m[1];
  } else {
    const BwPair* ps[2] = {&p0, &p1};
    for (int q = 0; q < 2 && e == cudaSuccess; ++q) {
      const BwPair& p = *ps[q];
      if (q == 1 && FORM != BW_CAT && FORM != BW_DUAL) {
        m[2] = m[0];
        m[3] = m[1];
        break;
      }
      e = tmap(&m[2 * q], p.A, a.M, p.K, BW_BM);
      const bool b_mn = FORM == BW_NN || (FORM == BW_DUAL && q == 0);
      if (e == cudaSuccess)
        e = b_mn ? tmap(&m[2 * q + 1], p.B, p.K, a.N, 64) : tmap(&m[2 * q + 1], p.B, a.N, p.K, BN);
    }
    a.kb0 = (p0.K + BW_BK - 1) / BW_BK;
    a.kb1 = FORM == BW_CAT ? (p1.K + BW_BK - 1) / BW_BK : 0;
  }
  if (e != cudaSuccess) return e;
  a.stages = a.stages > 0 ? std::min(a.stages, T::STAGES) : T::STAGES;
  auto kernel = bw_gemm<BN, FORM, EPI>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = (a.M + BW_BM - 1) / BW_BM * ((a.N + BN - 1) / BN);
  const int items = FORM == BW_TT ? tiles * a.splits : tiles;
  const int grid = std::min(items, sm_count());
  kernel<<<grid, BW_THREADS, T::SMEM, stream>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

// the launch with the tile width chosen at run time (64 or 128; the dual
// form's two accumulators at 128 take 128 registers a thread)
template <int FORM, int EPI>
cudaError_t bw_gemm_bn(int bn, const BwPair& p0, const BwPair& p1, const BwArgs& a,
                       cudaStream_t stream) {
  switch (bn) {
    case 64: return bw_gemm_launch<64, FORM, EPI>(p0, p1, a, stream);
    case 128: return bw_gemm_launch<128, FORM, EPI>(p0, p1, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// row passes: one warp per row, lane l holds column groups l, l + 32, l + 64
// of 8 columns (C <= 768); the block's 8 warps take contiguous rows

constexpr int ROW_THREADS = 256;
constexpr int MAX_GROUPS = 3;  // column groups of 8 a lane: C <= 8 * 32 * 3
constexpr int ROW_BLOCKS = 1024;  // blocks of the row passes with column sums

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  Pack8 k;
  k.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = bf2f(k.h[e]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  Pack8 k;
#pragma unroll
  for (int e = 0; e < 8; ++e) k.h[e] = f2bf(v[e]);
  *reinterpret_cast<uint4*>(p) = k.u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// the rows of block `blk` of nblk over M rows
__device__ __forceinline__ void block_rows(long M, int blk, int nblk, long* r0, long* r1) {
  const long per = (M + nblk - 1) / nblk;
  *r0 = min(M, (long)blk * per);
  *r1 = min(M, *r0 + per);
}

// Column sums of the block's rows: each warp's sums (sum[k][q][e] for
// column 8 (lane + 32 q) + e) through shared memory, the 8 warps in order,
// into part[k][blockIdx.x][C]
template <int K, int G>
__device__ __forceinline__ void block_col_sums(float (&sum)[K][G][8], float* red, int C,
                                               float* const (&part)[K]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (part[k] == nullptr) continue;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = 8 * (lane + 32 * q);
      if (c < C) store8(red + warp * C + c, sum[k][q]);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += ROW_THREADS) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += red[w * C + c];
      part[k][(long)blockIdx.x * C + c] = v;
    }
    __syncthreads();
  }
}

// the LayerNorm input v of token t: x[t] (+ m0 (a[t] (+ s tf[t])))
struct YSrc {
  const bf16* x;
  const bf16* a;      // or null
  const float* tf;    // or null
  const float* masks;
  float s;
  int L;
};

__device__ __forceinline__ void load_y(const YSrc& y, long t, int c, int C, float (&v)[8]) {
  load8(y.x + t * C + c, v);
  if (y.a != nullptr) {
    const float m0 = y.masks[2 * (t / y.L)];
    float a[8];
    load8(y.a + t * C + c, a);
    if (y.tf != nullptr) {
      float tv[8];
      load8(y.tf + t * C + c, tv);
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] += y.s * tv[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += m0 * a[e];
  }
}

// LayerNorm forward: over rows r (window order when `window`, else tokens),
// t the row's token: h[r] = bf16(LN(y[t]) w + b), stats[t] = (mean, rstd)
template <int G>
__global__ void __launch_bounds__(ROW_THREADS) ln_fwd_rows(YSrc y, const float* __restrict__ w,
                                                           const float* __restrict__ b,
                                                           bf16* __restrict__ h,
                                                           float2* __restrict__ stats, int rows,
                                                           RowMap g, int window) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int C = g.C;
  const long t = window ? window_token(g, r) : r;
  float v[G][8];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int c = 8 * (lane + 32 * q);
    if (c >= C) continue;
    load_y(y, t, c, C, v[q]);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[q][e];
  }
  const float mu = warp_sum(s) / C;
  float var = 0.f;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    if (8 * (lane + 32 * q) >= C) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = v[q][e] - mu;
      var += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(var) / C + LN_EPS);
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int c = 8 * (lane + 32 * q);
    if (c >= C) continue;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = (v[q][e] - mu) * rs * w[c + e] + b[c + e];
    store8(h + (long)r * C + c, o);
  }
  if (lane == 0) stats[t] = make_float2(mu, rs);
}

// xhat of token t's row (v from y, stats (mean, rstd)), in place
__device__ __forceinline__ void xhat_of(float (&v)[8], float2 st) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = (v[e] - st.x) * st.y;
}

// The drop-path scale of a cotangent, token rows: v = m[image][col] dout;
// out_a = bf16(v), out_b = bf16(s v) (or null); column sums into part[0]
// of out_a's rounded values (sum_rounded) or of v, into part[1] of s v
template <int G>
__global__ void __launch_bounds__(ROW_THREADS) scale_rows(const bf16* __restrict__ dout,
                                                          const float* __restrict__ masks,
                                                          int col, float s, bf16* __restrict__ out_a,
                                                          bf16* __restrict__ out_b, int sum_rounded,
                                                          float* part0, float* part1, long M,
                                                          int L, int C) {
  extern __shared__ float red[];  // 8 C floats
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float sum[2][G][8] = {};
  long r0, r1;
  block_rows(M, blockIdx.x, gridDim.x, &r0, &r1);
  for (long t = r0 + warp; t < r1; t += 8) {
    const float m = masks[2 * (t / L) + col];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = 8 * (lane + 32 * q);
      if (c >= C) continue;
      float v[8], va[8], vb[8];
      load8(dout + t * C + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] *= m;
        va[e] = sum_rounded ? round_bf(v[e]) : v[e];
        vb[e] = s * v[e];
        sum[0][q][e] += va[e];
        sum[1][q][e] += vb[e];
      }
      store8(out_a + t * C + c, v);
      if (out_b != nullptr) store8(out_b + t * C + c, vb);
    }
  }
  float* const parts[2] = {part0, part1};
  block_col_sums<2, G>(sum, red, C, parts);
}

// LayerNorm backward plus the residual at LN2, token rows t:
//   yhat from y[t] and stats[t]; dxh = dh2[t] w
//   dy = dout[t] + rstd (dxh - mean(dxh) - yhat mean(dxh yhat))   (float32)
// dy to dy_out[t]; K3 (adapter s == 0 and g2s null): dA[window row of t] =
// bf16(m0 dy); K5: g2s[t] = bf16(s m0 dy). Column sums into part: 0 dh2,
// 1 dh2 yhat (if part[1]), 2 the rounded dA (K3) or s m0 dy (K5)
template <int G>
__global__ void __launch_bounds__(ROW_THREADS) ln2_bwd_rows(
    const float* __restrict__ dh2, YSrc y, const float2* __restrict__ stats,
    const float* __restrict__ w, const bf16* __restrict__ dout, float* __restrict__ dy_out,
    bf16* __restrict__ dA, bf16* __restrict__ g2s, float* part0, float* part1, float* part2,
    long M, RowMap g) {
  extern __shared__ float red[];  // 8 C floats
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = g.C;
  float sum[3][G][8] = {};
  long r0, r1;
  block_rows(M, blockIdx.x, gridDim.x, &r0, &r1);
  for (long t = r0 + warp; t < r1; t += 8) {
    const float2 st = stats[t];
    const float m0 = y.masks[2 * (t / g.L)];
    float dh[G][8], yh[G][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = 8 * (lane + 32 * q);
      if (c >= C) continue;
      load8(dh2 + t * C + c, dh[q]);
      load_y(y, t, c, C, yh[q]);
      xhat_of(yh[q], st);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dxh = dh[q][e] * w[c + e];
        s1 += dxh;
        s2 += dxh * yh[q][e];
      }
    }
    const float mean1 = warp_sum(s1) / C, mean2 = warp_sum(s2) / C;
    const long wr = g2s == nullptr ? token_window(g, (int)t) : t;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = 8 * (lane + 32 * q);
      if (c >= C) continue;
      float d[8], o[8];
      load8(dout + t * C + c, d);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] += st.y * (dh[q][e] * w[c + e] - mean1 - yh[q][e] * mean2);
        sum[0][q][e] += dh[q][e];
        sum[1][q][e] += dh[q][e] * yh[q][e];
        o[e] = g2s == nullptr ? round_bf(m0 * d[e]) : y.s * (m0 * d[e]);
        sum[2][q][e] += o[e];
      }
      store8(dy_out + t * C + c, d);
      store8(g2s == nullptr ? dA + wr * C + c : g2s + wr * C + c, o);
    }
  }
  float* const parts[3] = {part0, part1, part2};
  block_col_sums<3, G>(sum, red, C, parts);
}

// LayerNorm backward plus the residual at LN1, token rows t: dh[t] (bf16,
// token order), xhat from x[t] and stats[t]; dx[t] = bf16(dy[t] + rstd (dxh
// - mean(dxh) - xhat mean(dxh xhat))). Column sums: 0 dh, 1 dh xhat (if part1)
template <int G>
__global__ void __launch_bounds__(ROW_THREADS) ln1_bwd_rows(
    const bf16* __restrict__ dh_in, const bf16* __restrict__ x, const float2* __restrict__ stats,
    const float* __restrict__ w, const float* __restrict__ dy, bf16* __restrict__ dx,
    float* part0, float* part1, long M, int C) {
  extern __shared__ float red[];  // 8 C floats
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float sum[2][G][8] = {};
  long r0, r1;
  block_rows(M, blockIdx.x, gridDim.x, &r0, &r1);
  for (long t = r0 + warp; t < r1; t += 8) {
    const float2 st = stats[t];
    float dh[G][8], xh[G][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = 8 * (lane + 32 * q);
      if (c >= C) continue;
      load8(dh_in + t * C + c, dh[q]);
      load8(x + t * C + c, xh[q]);
      xhat_of(xh[q], st);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dxh = dh[q][e] * w[c + e];
        s1 += dxh;
        s2 += dxh * xh[q][e];
      }
    }
    const float mean1 = warp_sum(s1) / C, mean2 = warp_sum(s2) / C;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = 8 * (lane + 32 * q);
      if (c >= C) continue;
      float d[8];
      load8(dy + t * C + c, d);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] += st.y * (dh[q][e] * w[c + e] - mean1 - xh[q][e] * mean2);
        sum[0][q][e] += dh[q][e];
        sum[1][q][e] += dh[q][e] * xh[q][e];
      }
      store8(dx + t * C + c, d);
    }
  }
  float* const parts[2] = {part0, part1};
  block_col_sums<2, G>(sum, red, C, parts);
}

// ---------------------------------------------------------------------------
// the ordered reduction: out[i] = sum over s = 0..S-1, in order within each
// of 8 contiguous ranges of s and the ranges in order, of part[s n + i]

constexpr int MAX_JOBS = 24;
struct ReduceJobs {
  const float* part[MAX_JOBS];
  float* out[MAX_JOBS];
  long n[MAX_JOBS];
  int S[MAX_JOBS];
  int count;
};

__device__ __forceinline__ int reduce_ranges(int S) { return S >= 64 ? 8 : 1; }

__global__ void __launch_bounds__(256) reduce_jobs(const __grid_constant__ ReduceJobs jobs) {
  __shared__ float red[8][33];
  const int j = blockIdx.y;
  const long n = jobs.n[j];
  const int S = jobs.S[j];
  const float* p = jobs.part[j];
  if (reduce_ranges(S) == 1) {  // few partials: a thread per output, in order
    const long i = (long)blockIdx.x * 256 + threadIdx.x;
    if (i >= n) return;
    float v = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) v += p[(long)s * n + i];
    jobs.out[j][i] = v;
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long i = (long)blockIdx.x * 32 + lane;
  if ((long)blockIdx.x * 32 >= n) return;
  const int per = (S + 7) / 8;
  const int s0 = min(S, warp * per), s1 = min(S, s0 + per);
  float v = 0.f;
  if (i < n) {
#pragma unroll 8
    for (int s = s0; s < s1; ++s) v += p[(long)s * n + i];
  }
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += red[w][lane];
    jobs.out[j][i] = t;
  }
}

struct Reducer {
  ReduceJobs jobs{};
  long most = 0;
  void add(const float* part, int S, long n, float* out) {
    if (out == nullptr) return;
    if (jobs.count == MAX_JOBS) {
      jobs.count = MAX_JOBS + 1;  // refused at launch
      return;
    }
    jobs.part[jobs.count] = part;
    jobs.out[jobs.count] = out;
    jobs.n[jobs.count] = n;
    jobs.S[jobs.count] = S;
    ++jobs.count;
    most = std::max(most, S >= 64 ? (n + 31) / 32 : (n + 255) / 256);  // blocks
  }
  cudaError_t launch(cudaStream_t stream) {
    if (jobs.count == 0) return cudaSuccess;
    if (jobs.count > MAX_JOBS) return cudaErrorInvalidValue;
    reduce_jobs<<<dim3((unsigned)most, jobs.count), 256, 0, stream>>>(jobs);
    return cudaGetLastError();
  }
};

// ---------------------------------------------------------------------------
// window attention on wgmma: one warpgroup (block of 128 threads) per
// (window group, head), walking its windows. Tiles of 64 rows (or, for the
// transposes, 32 rows of head dim) of 128-byte rows, 128-byte swizzled,
// each 1024-byte aligned; head-dim columns 24..31 and transposed rows 24..31
// stay zero.

constexpr int ATT_THREADS = 128;
constexpr int T64 = 64 * 128, T32 = 32 * 128;

// byte offsets of the tiles from the 1024-aligned base: the forward's Q, K
// and V^T; the backward's Q, K, V, dO, P (then dS), Q^T, K^T, dO^T and the
// block's float32 (64, 64) bias-grad sum
struct AttFwdSmem {
  static constexpr int Q = 0, K = T64, VT = 2 * T64, END = 2 * T64 + T32;
  static constexpr int SMEM = END + 1024;
};
struct AttBwdSmem {
  static constexpr int Q = 0, K = T64, V = 2 * T64, DO = 3 * T64, P = 4 * T64, QT = 5 * T64,
                       KT = QT + T32, DOT = KT + T32, DB = DOT + T32, END = DB + 64 * 64 * 4;
  static constexpr int SMEM = END + 1024;
};

// D (64 x 32) = A . B^T, A 64 x 16 bf16 from registers (mma.sync's A
// fragment: pairs rows l / 4 and + 8, columns 2 (l % 4) and + 8), B 32 x 16
// K-major from shared memory
__device__ __forceinline__ void wgmma_rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// zero the padding of the 64-row tiles (head-dim columns 24..31) and the
// 32-row transposes (rows 24..31), once per block
__device__ __forceinline__ void att_zero_pads(uint32_t base, const int* t64, int n64,
                                              const int* t32, int n32) {
  const int tl = threadIdx.x % ATT_THREADS;
  for (int i = tl; i < n64 * 64; i += ATT_THREADS)
    st_shared_v4(base + t64[i / 64] + sw128(i % 64, 24), make_uint4(0, 0, 0, 0));
  for (int i = tl; i < n32 * 64; i += ATT_THREADS)
    st_shared_v4(base + t32[i / 64] + sw128(24 + (i / 8) % 8, 8 * (i % 8)),
                 make_uint4(0, 0, 0, 0));
}

// One (window, head)'s operands, NM matrices of 64 rows x 24 columns (three
// 16-byte chunks a row): Q, K, V from the (rows, 3C) qkv matrix and, with NM
// = 4, dO from the (rows, C) attention-output grad. A thread holds chunks
// tid, tid + 128, ... in registers: loaded for the next window while the
// current one computes.
template <int NM>
struct AttChunks {
  static constexpr int N = (NM * 192 + ATT_THREADS - 1) / ATT_THREADS;
  uint4 v[N];

  __device__ __forceinline__ void load(const bf16* qkv, const bf16* dattn, long row0, int C,
                                       int h) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = threadIdx.x % ATT_THREADS + ATT_THREADS * k;
      if (i >= NM * 192) continue;
      const int m = i / 192, r = (i % 192) / 3, ch = i % 3;
      const bf16* src = m < 3 ? qkv + (row0 + r) * 3 * C + m * C + h * HD + 8 * ch
                              : dattn + (row0 + r) * C + h * HD + 8 * ch;
      v[k] = *reinterpret_cast<const uint4*>(src);
    }
  }

  // matrix m into tile[m] and its transpose into tt[m] (offsets < 0: none)
  __device__ __forceinline__ void store(uint32_t base, const int (&tile)[NM],
                                        const int (&tt)[NM]) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = threadIdx.x % ATT_THREADS + ATT_THREADS * k;
      if (i >= NM * 192) continue;
      const int m = i / 192, r = (i % 192) / 3, ch = i % 3;
      if (tile[m] >= 0) st_shared_v4(base + tile[m] + sw128(r, 8 * ch), v[k]);
      if (tt[m] >= 0) {
        Pack8 p;
        p.u = v[k];
#pragma unroll
        for (int e = 0; e < 8; ++e) st_shared_b16(base + tt[m] + sw128(8 * ch + e, r), p.h[e]);
      }
    }
  }
};

// the head's relative-position bias plus the window's shift mask in the
// accumulator layout: the scores' initial value
__device__ __forceinline__ void att_bias(const float* __restrict__ bias_h,
                                         const float* __restrict__ mask_w, float (&bm)[32]) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = warp * 16 + lane / 4 + 8 * ((i % 4) / 2), c = 8 * (i / 4) + 2 * (lane % 4);
    float2 b = *reinterpret_cast<const float2*>(bias_h + r * 64 + c);
    if (mask_w != nullptr) {
      const float2 m = *reinterpret_cast<const float2*>(mask_w + r * 64 + c);
      b.x += m.x;
      b.y += m.y;
    }
    bm[i] = b.x;
    bm[i + 1] = b.y;
  }
}

// S = bias (+ mask) + Q K^T for the warpgroup's 64 query rows (wgmma
// accumulating onto the bias), then P = bf16(softmax(S)) in float32,
// max-subtracted, normalized (by one reciprocal a row) then rounded; p holds
// P (rounded, as float) in the accumulator layout. exp2 and the reciprocal
// keep the shift mask's subnormal exponentials off the slow path of IEEE
// division.
__device__ __forceinline__ void att_scores(uint32_t q_tile, uint32_t k_tile, const float (&bm)[32],
                                           float (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = bm[i];
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
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);
  constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p[i] = exp2f(fmaf(p[i], LOG2E, -mx[(i % 4) / 2] * LOG2E));
    sum[(i % 4) / 2] += p[i];
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / quad_sum(sum[h]);
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = round_bf(p[i] * inv[(i % 4) / 2]);
}

// the RS A fragments of a 64 x 64 accumulator-layout matrix (bf16)
__device__ __forceinline__ void att_frags(const float (&v)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * (2 * kk + q / 2) + 2 * (q % 2);
      a[kk][q] = pack_bf16(v[i], v[i + 1]);
    }
}

// a 64 x 64 accumulator-layout matrix, rounded, into a row-major tile
__device__ __forceinline__ void att_store_tile(uint32_t tile, const float (&v)[32]) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = warp * 16 + lane / 4 + 8 * ((i % 4) / 2), c = 8 * (i / 4) + 2 * (lane % 4);
    st_shared_b32(tile + sw128(r, c), pack_bf16(v[i], v[i + 1]));
  }
}

// a 64 x 32 accumulator (head dim, 24 valid) rounded into 24 columns at
// dst (row stride ld); this thread's column sums of the rounded values over
// its two rows added to cs[6]
__device__ __forceinline__ void att_store_head(const float (&v)[16], bf16* dst, long ld,
                                               float* cs) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 12; i += 2) {  // column groups 0..2 (i / 4 < 3)
    const int r = warp * 16 + lane / 4 + 8 * ((i % 4) / 2), c = 8 * (i / 4) + 2 * (lane % 4);
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[i], v[i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dst + r * ld + c) = p;
    cs[2 * (i / 4)] += __bfloat162float(p.x);
    cs[2 * (i / 4) + 1] += __bfloat162float(p.y);
  }
}

// Forward recompute: out[row, h * 24 ..] = bf16(P V), window order
__global__ void __launch_bounds__(ATT_THREADS, 3) attention_fwd_sm90(
    const bf16* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ mask,
    bf16* __restrict__ out, int C, int nW, int n_windows) {
  using L = AttFwdSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int h = blockIdx.y;
  {
    const int t64[2] = {L::Q, L::K}, t32[1] = {L::VT};
    att_zero_pads(base, t64, 2, t32, 1);
  }
  const int tile[3] = {L::Q, L::K, -1}, tt[3] = {-1, -1, L::VT};
  const float* bias_h = bias + (long)h * WIN_N * WIN_N;
  float bm[32];
  int bm_win = -1;
  AttChunks<3> ch;
  if (blockIdx.x < n_windows) ch.load(qkv, nullptr, (long)blockIdx.x * WIN_N, C, h);
  for (int win = blockIdx.x; win < n_windows; win += gridDim.x) {
    const long row0 = (long)win * WIN_N;
    const int mw = mask != nullptr ? win % nW : 0;
    if (mw != bm_win) {
      att_bias(bias_h, mask != nullptr ? mask + (long)mw * WIN_N * WIN_N : nullptr, bm);
      bm_win = mw;
    }
    __syncthreads();  // the previous window's wgmma reads are done
    ch.store(base, tile, tt);
    if (win + gridDim.x < n_windows) ch.load(qkv, nullptr, row0 + (long)gridDim.x * WIN_N, C, h);
    fence_async_shared();
    __syncthreads();
    float p[32];
    att_scores(base + L::Q, base + L::K, bm, p);
    uint32_t pa[4][4];
    att_frags(p, pa);
    float o[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs32(o, pa[kk], desc_sw128(base + L::VT) + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    float cs[6] = {};
    att_store_head(o, out + row0 * C + h * HD, C, cs);
  }
}

// Backward: per window, P recomputed; dV = P^T dO; dP = dO V^T; dS = P (dP -
// rowsum(dP P)) float32 (summed into the block's bias-grad sum in shared
// memory); dq = bf16(dS) K; dk = bf16(dS)^T Q; dq, dk, dV rounded into dqkv
// (window order). The block writes its (64, 64) bias-grad sum to
// dbias_part[blockIdx.x][h] (if not null) and its column sums of the rounded
// dq, dk, dV to dqkvb_part[blockIdx.x][3C] at the head's columns.
__global__ void __launch_bounds__(ATT_THREADS, 2) attention_bwd_sm90(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dattn, const float* __restrict__ bias,
    const float* __restrict__ mask, bf16* __restrict__ dqkv, float* __restrict__ dbias_part,
    float* __restrict__ dqkvb_part, int C, int nh, int nW, int n_windows) {
  using L = AttBwdSmem;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[4][72];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  float* dbias_s = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::DB);
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long ld3 = 3 * C;
  const bool want_bias = dbias_part != nullptr;
  {
    const int t64[4] = {L::Q, L::K, L::V, L::DO}, t32[3] = {L::QT, L::KT, L::DOT};
    att_zero_pads(base, t64, 4, t32, 3);
  }
  const int tile[4] = {L::Q, L::K, L::V, L::DO}, tt[4] = {L::QT, L::KT, -1, L::DOT};
  // this thread's positions of the bias-grad sum (accumulator layout)
  auto db_at = [&](int i) {
    const int r = warp * 16 + lane / 4 + 8 * ((i % 4) / 2), c = 8 * (i / 4) + 2 * (lane % 4);
    return dbias_s + r * 64 + c;
  };
  if (want_bias) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) *reinterpret_cast<float2*>(db_at(i)) = make_float2(0.f, 0.f);
  }
  const float* bias_h = bias + (long)h * WIN_N * WIN_N;
  float bm[32];
  int bm_win = -1;
  float cs[3][6];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int k = 0; k < 6; ++k) cs[m][k] = 0.f;
  AttChunks<4> ch;
  if (blockIdx.x < n_windows) ch.load(qkv, dattn, (long)blockIdx.x * WIN_N, C, h);

  for (int win = blockIdx.x; win < n_windows; win += gridDim.x) {
    const long row0 = (long)win * WIN_N;
    const int mw = mask != nullptr ? win % nW : 0;
    if (mw != bm_win) {
      att_bias(bias_h, mask != nullptr ? mask + (long)mw * WIN_N * WIN_N : nullptr, bm);
      bm_win = mw;
    }
    __syncthreads();  // the previous window's wgmma reads are done
    ch.store(base, tile, tt);
    if (win + gridDim.x < n_windows)
      ch.load(qkv, dattn, row0 + (long)gridDim.x * WIN_N, C, h);
    fence_async_shared();
    __syncthreads();
    float p[32];
    att_scores(base + L::Q, base + L::K, bm, p);
    att_store_tile(base + L::P, p);
    // dP = dO V^T (both K-major over the head dim)
    float dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss<64>(dp, desc_sw128(base + L::DO) + 2 * kk, desc_sw128(base + L::V) + 2 * kk, kk > 0);
    wgmma_commit();
    fence_async_shared();
    named_barrier(1, ATT_THREADS);  // all of P is in shared memory
    // dV = P^T dO: A = P (MN-major, keys by query rows), B = dO^T (K-major)
    float dv[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<32, 0, 1>(dv, desc_sw128_mn(base + L::P, 8192) + 128 * kk,
                         desc_sw128(base + L::DOT) + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);
    fence_regs(dv);
    // dS = P (dP - rowsum(dP P)) in float32; the bias grad sums it unrounded
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) rs[(i % 4) / 2] += dp[i] * p[i];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) rs[hh] = quad_sum(rs[hh]);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = p[i] * (dp[i] - rs[(i % 4) / 2]);
    if (want_bias) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float2* d = reinterpret_cast<float2*>(db_at(i));
        float2 v = *d;
        v.x += dp[i];
        v.y += dp[i + 1];
        *d = v;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = round_bf(dp[i]);
    named_barrier(1, ATT_THREADS);  // every warp's dV has read P: dS goes over it
    att_store_tile(base + L::P, dp);
    att_store_head(dv, dqkv + row0 * ld3 + 2 * C + h * HD, ld3, cs[2]);
    uint32_t da[4][4];
    att_frags(dp, da);
    // dq = dS K: A from the registers, B = K^T (K-major over keys)
    float dq[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs32(dq, da[kk], desc_sw128(base + L::KT) + 2 * kk, kk > 0);
    wgmma_commit();
    fence_async_shared();
    named_barrier(1, ATT_THREADS);  // all of dS is in shared memory
    // dk = dS^T Q: A = dS (MN-major), B = Q^T (K-major over query rows)
    float dk[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<32, 0, 1>(dk, desc_sw128_mn(base + L::P, 8192) + 128 * kk,
                         desc_sw128(base + L::QT) + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dk);
    att_store_head(dq, dqkv + row0 * ld3 + h * HD, ld3, cs[0]);
    att_store_head(dk, dqkv + row0 * ld3 + C + h * HD, ld3, cs[1]);
  }

  if (want_bias) {
    float* out = dbias_part + ((long)blockIdx.x * nh + h) * WIN_N * WIN_N;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = warp * 16 + lane / 4 + 8 * ((i % 4) / 2), c = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<float2*>(out + r * 64 + c) = *reinterpret_cast<const float2*>(db_at(i));
    }
  }
  // column sums of dq, dk, dV: the lanes of a column in the warp, then the
  // warps in order
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float v = cs[m][k];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      cs[m][k] = v;
    }
  if (lane < 4) {
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int k = 0; k < 6; ++k) red[warp][m * 24 + 8 * (k / 2) + 2 * lane + k % 2] = cs[m][k];
  }
  __syncthreads();
  if (threadIdx.x < 72) {
    const int m = threadIdx.x / 24, c = threadIdx.x % 24;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) v += red[w][threadIdx.x];
    dqkvb_part[(long)blockIdx.x * 3 * C + m * C + h * HD + c] = v;
  }
}

// (window groups) blocks per head of the attention kernels: every window
// once, about 512 blocks in all
inline int att_groups(int n_windows, int nh) {
  const int want = std::max(1, 512 / nh);
  return std::min(n_windows, want);
}

inline cudaError_t attention_fwd(const bf16* qkv, const float* bias, const float* mask, bf16* out,
                                 int C, int nh, int nW, int n_windows, cudaStream_t stream) {
  using L = AttFwdSmem;
  cudaError_t e = cudaFuncSetAttribute(attention_fwd_sm90,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  attention_fwd_sm90<<<dim3(att_groups(n_windows, nh), nh), ATT_THREADS, L::SMEM, stream>>>(
      qkv, bias, mask, out, C, nW, n_windows);
  return cudaGetLastError();
}

inline cudaError_t attention_bwd(const bf16* qkv, const bf16* dattn, const float* bias,
                                 const float* mask, bf16* dqkv, float* dbias_part,
                                 float* dqkvb_part, int C, int nh, int nW, int n_windows,
                                 cudaStream_t stream) {
  using L = AttBwdSmem;
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_sm90,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  attention_bwd_sm90<<<dim3(att_groups(n_windows, nh), nh), ATT_THREADS, L::SMEM, stream>>>(
      qkv, dattn, bias, mask, dqkv, dbias_part, dqkvb_part, C, nh, nW, n_windows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// host: the block's shapes, the workspace carver, the tile choices

struct BwdShapes {
  int B, H, W, C, nh, win, shift, hidden, ch;  // ch: padded adapter width, 0 for K3
  long M() const { return (long)B * H * W; }
  int n_windows() const { return B * (H / win) * (W / win); }
  int nW() const { return (H / win) * (W / win); }
};

// the tile choices the wrapper passes (ops TILES): tile widths of the
// recompute (NN), activation-grad (NT, CAT), dual and weight-grad (TT)
// GEMMs, and the work items the TT split aims at
struct BwTiles {
  int bn_nn, bn_nt, bn_dual, bn_tt, tt_items, stages;  // stages 0: as deep as fits
};

inline bool bad_tiles(const BwTiles& t) {
  auto ok = [](int bn) { return bn == 64 || bn == 128; };
  return !ok(t.bn_nn) || !ok(t.bn_nt) || !ok(t.bn_dual) || !ok(t.bn_tt) || t.tt_items < 1 ||
         t.stages < 0 || t.stages == 1;
}

// carves `base` (or, with null, only counts bytes) in 1024-byte steps
struct Carver {
  char* base;
  long off = 0;
  char* take(long n, long elem) {
    char* p = base != nullptr ? base + off : nullptr;
    off += (n * elem + 1023) / 1024 * 1024;
    return p;
  }
  bf16* bf(long n) { return reinterpret_cast<bf16*>(take(n, 2)); }
  float* fl(long n) { return reinterpret_cast<float*>(take(n, 4)); }
};

// a weight grad's partials: (splits, Ka, N) float32, or the output itself
// when one split covers the rows
struct WGrad {
  int rps = 0, splits = 0;
  float* part = nullptr;
  void plan(Carver& c, long rows, int Ka, int N, const BwTiles& t) {
    tt_split((int)rows, Ka, N, t.bn_tt, t.tt_items, &rps, &splits);
    part = splits > 1 ? c.fl((long)splits * Ka * N) : nullptr;
  }
};

// dW (Ka, N) = A^T dY over the rows: the split TT GEMM, its reduction
// queued on r (or written directly with one split)
inline cudaError_t weight_grad(const WGrad& wg, const bf16* A, const bf16* dY, long rows, int Ka,
                               int N, float* out, const BwTiles& t, Reducer& r,
                               cudaStream_t stream) {
  if (out == nullptr) return cudaSuccess;
  BwArgs a{};
  a.M = Ka;
  a.N = N;
  a.rows = (int)rows;
  a.rps = wg.rps;
  a.splits = wg.splits;
  a.stages = t.stages;
  a.out_f32 = wg.splits > 1 ? wg.part : out;
  const cudaError_t e = bw_gemm_bn<BW_TT, E_PART>(t.bn_tt, BwPair{A, dY, 0}, BwPair{}, a, stream);
  if (wg.splits > 1) r.add(wg.part, wg.splits, (long)Ka * N, out);
  return e;
}

// grid of the row passes with column sums: ROW_BLOCKS, or fewer for few
// rows; and their shared memory (8 warps' column sums of C)
inline int row_grid(long M) { return (int)std::min<long>(ROW_BLOCKS, (M + 7) / 8); }
inline size_t row_smem(int C) { return (size_t)8 * C * sizeof(float); }

// a row pass launched with its column groups a lane (1, 2 or 3 for C <= 256,
// 512, 768): ROW_PASS(kernel, grid, smem, stream, args...)
#define ROW_PASS(kernel, grid, smem, stream, C, ...)                                  \
  do {                                                                               \
    if ((C) <= 256)                                                                  \
      kernel<1><<<(grid), ROW_THREADS, (smem), (stream)>>>(__VA_ARGS__);             \
    else if ((C) <= 512)                                                             \
      kernel<2><<<(grid), ROW_THREADS, (smem), (stream)>>>(__VA_ARGS__);             \
    else                                                                             \
      kernel<3><<<(grid), ROW_THREADS, (smem), (stream)>>>(__VA_ARGS__);             \
  } while (0)

}  // namespace
