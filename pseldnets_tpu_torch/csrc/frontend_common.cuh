// Device code shared by kernels K9 (frontend_flat.cu) and K10
// (frontend_dif.cu): the two DFT-as-GEMM forms of the log-mel + FOA
// intensity-vector frontend, as one warp-specialised, TMA-fed split-TF32
// wgmma kernel for sm_90a (the form is a template flag).
//
// Arithmetic: each float32 operand x is split as hi = tf32(x) (rounded to
// nearest, ties away: cvt.rna.tf32.f32) and lo = tf32(x - hi), and each
// product as a_lo b_hi + a_hi b_lo + a_hi b_hi with float32 sums, the small
// products added first ("3xTF32"). One TF32 product misses the 8e-4 dB
// budget (4.8 dB at n_fft 1024, the deepest spectral valley), the split one
// does not. Summed in one accumulator over the whole k, its rms dB error
// from the float64 DFT is 1.5-2x the former float32 kernels' (three
// roundings of the running sum a k step, 2^-22 products): so each k-block
// (32 k, 12 split products a column) is summed from zero in the tensor
// cores and then added to a running sum in registers, which brings it to
// 1.0-1.5x (tests/test_torch_frontend_split.py); two k-blocks a chunk (0.3
// ms less for K9) put the deepest valley of chip_smoke.py's check data
// 1.0e-3 dB from the plain version, one puts it 3.4e-4
// (scripts/torch_frontend_forms_probe.py --accuracy). The tables are split
// on the host from their float64 values (rounded once to the 22 bits the
// pair holds); the waveform rows (DIF: the sum and difference streams,
// formed in float32, of the windowed halves in the WIDE form) on the
// device. The plain versions (ops/frontend_forms.py, split3_matmul) sum in
// the same order of k steps and k-blocks.
//
// GEMM layout: a block takes FR = 32 frames of one clip, 16 a consumer
// warpgroup. A warpgroup's 64 GEMM rows are (frame, channel) pairs ordered
// so that thread (warp w, lane 4 g + t) holds rows g and g + 8 of its warp,
// channels 2 (g % 2) and + 1 of frame 4 w + g / 2: lanes l and l ^ 4 hold
// the four channels of one frame. A comes from registers (wgmma's RS form):
// each thread fetches its two rows' samples a k-block ahead with cp.async
// into its own slots in shared memory (reflect pad and zero tail as index
// arithmetic, stored directly; any hop), reads them back, splits them and
// hands them to wgmma; the k order inside a k-block gives each thread four
// adjacent samples a row for two k steps (one 16-byte copy), and each k
// step still sums eight samples. B, the windowed (cos, -sin) table of one
// column tile, is K-major: rows are columns, split into a hi and a lo tile
// of 128 x 32 float32 per k-block (128-byte swizzle), TMA-loaded by one
// producer thread into a ring of STAGES 32 KB stages (mbarrier full/empty
// pairs). Per k-block a consumer warpgroup issues commit groups of two k
// steps of split products (flat: steps 0-1 and 2-3 of m64n128k8; DIF: steps
// 0-1 of the sum-stream half, of the difference-stream half, then 2-3 of
// each, m64n64k8) and keeps one group in flight; the register fragments of
// a group are held (fence_frag) until it retires. The consumers run at 232
// registers (setmaxnreg; the producer gives its registers up).
//
// What holds it (scripts/torch_frontend_forms_probe.py, PERF.md): the wgmma
// mainloop alone runs at 72-82% of the dense TF32 rate; the consumers'
// own work (the waveform's staging, the split, the running sum, the
// epilogue) adds to it rather than hiding under the other warpgroup's
// wgmma; the tables' L2 reads cost nothing measurable, so neither TMA
// multicast over a pair of CTAs nor a deeper ring helps.
//
// Epilogue of a column tile (no spectrum reaches device memory): the tile's
// columns are ordered so that thread t holds local bins 16 t .. 16 t + 15
// of its two channels (flat: bin k_lo + 64 tile + local; DIF: bin 2s - 1 +
// local, sum-stream bins at odd locals; the narrow form applies the window
// as the 3-tap in registers with one shuffle across each 16-bin edge, the
// WIDE form applied it to the samples).
// Lanes l and l ^ 4 swap their channels, each computes the powers and the
// normalized intensity vector, and the seven values of the tile's 64 local
// bins go through a second split-TF32 wgmma against the tile's mel table
// (64 mels x 64 locals, K-major hi/lo, one more ring stage): rows (frame,
// value), q = 4 s + 2 (g % 2) + h for stripe s (q = 7 is zero). Its
// accumulator is added to the block's mel sums in shared memory (each sum
// owned by one thread: fixed order, no atomics). The block ends with dB,
// the optional ScalarBN affine, the zero tail and one store per output.
//
// Wide mel widths (n_mels > 64, the WIDE form): the block's mel sums (32
// frames x 7 x n_mels, 229 KB at 256 mels) do not fit beside the ring and
// the waveform's staging, so they live in a device-memory scratch of the
// block's own, read and written by the same owners in the same order (a
// sum is still one thread's, tile after tile). A column tile's mels are a
// window from its first touched mel, rounded down to a multiple of 8 so
// that a mel keeps its owner from tile to tile, in one or more groups of
// 64 (``plan``: the window's first mel and the tile's first group; mel
// bands are banded and close in bin order, so a tile touches few: at n_fft
// 1024 and 128 mels the widest tile touches 51). Each group is one more
// ring stage of mel tables and one more mel GEMM. The sums of each mel
// are added in the same order as at 64 mels; at n_mels <= 64 the kernel is
// the narrow form, unchanged. Why device memory: the sums (32 frames x 8
// rows x n_mels float32) take 128 KB at 128 mels and 256 KB at 256, beside
// the 96 KB ring and the waveform's staging (32 KB flat, 64 KB DIF); 16
// frames a block would fit 128 mels but not 256, would drop the second
// consumer warpgroup (whose wgmma hides the first one's own work) and
// double the tables' reads; a sliding window of the mels still open must
// span the widest tile's (145 mels at n_fft 512 and 256 mels: 145 KB).
// K10's WIDE form also applies the window to each frame's halves before
// the butterfly, not as the 3-tap after the DFT (frontend_dif.cu): over 64
// mels the low bands hold one bin, and the 3-tap's float32 cancellation at
// a frame that ends in a sharp onset puts such a band up to 2e-3 dB from
// the float64 DFT, where the windowed samples keep the flat form's error.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90_gemm.cuh"

namespace fe {

// the knobs scripts/torch_frontend_forms_probe.py sweeps, by defining them
// before this header in a copy of the source; FE_PROBE cuts phases (1: the
// waveform loads after the first k-block, 2: the split, 4: the per-tile
// epilogue, 8: the table reads, 16: the running sum, the tile summed in one
// level) and its outputs are wrong
#ifndef FE_CWG
#define FE_CWG 2
#endif
#ifndef FE_STAGES
#define FE_STAGES 3
#endif
#ifndef FE_CLUSTER
#define FE_CLUSTER 1
#endif
#ifndef FE_PROBE
#define FE_PROBE 0
#endif
#ifndef FE_CHUNK
#define FE_CHUNK 1
#endif
#ifndef FE_PRODUCTS
#define FE_PRODUCTS 3
#endif

constexpr int CWG = FE_CWG;              // consumer warpgroups
constexpr int PROBE = FE_PROBE;
constexpr int CHUNK = FE_CHUNK;        // k-blocks summed in the tensor cores before the running sum
constexpr int PRODUCTS = FE_PRODUCTS;  // split products a k step: 3, or 4 with a_lo b_lo
constexpr int FR_WG = 16;                // frames a consumer warpgroup: 64 GEMM rows
constexpr int FR = CWG * FR_WG;          // frames per block
constexpr int CONSUMERS = 128 * CWG;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int COLS = 128;                // spectrum columns per tile: 64 complex values
constexpr int LOCALS = 64;               // local bins per tile: the mel GEMM's k
constexpr int MELS = 64;                 // the mel GEMM's columns: a group of mels
constexpr int BK = 32;                   // k-block: one 128-byte row of float32
constexpr int STAGE = 2 * COLS * BK * 4;  // a k-block's hi and lo tiles, or a tile's mel table
constexpr int STAGES = FE_STAGES;        // ring depth
constexpr int CLUSTER = FE_CLUSTER;      // CTAs sharing each table tile by TMA multicast
constexpr int ACC_LD = 8 * MELS;         // floats a frame of the mel sums (q 0 .. 7)
constexpr int ACC_BYTES = FR * ACC_LD * 4;
// the waveform's staging: per consumer thread and k-block, 16-byte slots
// (part, row, DIF: half), two k-blocks deep
template <bool DIF>
constexpr int SLOTS = DIF ? 8 : 4;
template <bool DIF>
constexpr int A_BYTES = 2 * SLOTS<DIF> * CONSUMERS * 16;
// WIDE: the mel sums in device memory, none in shared memory
template <bool DIF, bool WIDE>
constexpr int SMEM = STAGES * STAGE + (WIDE ? 0 : ACC_BYTES) + A_BYTES<DIF> + 16 * STAGES + 1024;
constexpr float EPS_F32 = 1.1920928955078125e-07f;
static_assert(SMEM<true, false> <= 232448 && SMEM<false, false> <= 232448,
              "the ring, the mel sums and the waveform's staging fit in 227 KB");
static_assert(CLUSTER == 1 || CLUSTER == 2, "one CTA or a pair per table tile");
// registers a thread after setmaxnreg (producer 40, consumers 232), from the
// block's own pool (168 a thread at launch, one block per SM); ptxas
// allocates the consumers' code to 232
static_assert(CWG == 1 || 40 * 128 + 232 * CONSUMERS <= 168 * THREADS,
              "setmaxnreg within the block's registers");

struct FormArgs {
  const float* x;    // (B, 4, N) float32
  const float* aff;  // (2, 7, n_mels) float32 or null (flat only)
  void* out;         // (B, 7, t_out, n_mels) float32 or bf16
  const int* plan;   // (n_tiles + 1, 2): a tile's first mel and first mel group (WIDE)
  float* acc;        // WIDE: (B, blocks, FR, 7, n_mels) float32 scratch, the mel sums
  int N, n_fft, hop, n_tiles, kblocks, n_mels, n_frames, t_out, out_bf16;
  int vec;           // the waveform's rows of a k-block are 16-byte aligned
  int s0;            // DIF: sub-bin of tile 0
  float a0, a1;      // DIF, narrow: the window's 3-tap
  const float* win;  // DIF, WIDE: (2, Kp) the window of each frame's two halves, in sample order
};

// sample i of the center=True padded signal: a reflect pad of `pad` samples
// on both sides, zeros beyond it (the JAX kernels' right tail)
__device__ __forceinline__ float padded_sample(const float* __restrict__ x, int N, int pad,
                                               long i) {
  if (i < 0 || i >= (long)N + 2 * pad) return 0.f;
  long j = i - pad;
  if (j < 0) j = -j;
  else if (j >= N) j = 2L * (N - 1) - j;
  return __ldg(x + j);
}

// a commit group's split A fragments: KK k steps of a[0..3]
template <int KK>
struct Frag {
  uint32_t hi[KK][4], lo[KK][4];
};

// keep a retired group's fragments where wgmma read them until here
template <int KK>
__device__ __forceinline__ void fence_frag(Frag<KK>& f) {
#pragma unroll
  for (int k = 0; k < KK; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f.hi[k][i]), "+r"(f.lo[k][i])::"memory");
}

template <int KK>
__device__ __forceinline__ void split_frag(Frag<KK>& f, int k, float a0, float a1, float a2,
                                           float a3) {
  tf32_split(a0, f.hi[k][0], f.lo[k][0]);
  tf32_split(a1, f.hi[k][1], f.lo[k][1]);
  tf32_split(a2, f.hi[k][2], f.lo[k][2]);
  tf32_split(a3, f.hi[k][3], f.lo[k][3]);
}

// the three split products of one k step into d: small ones first
template <int N>
__device__ __forceinline__ void split3(float (&d)[N / 2], const uint32_t (&hi)[4],
                                       const uint32_t (&lo)[4], uint64_t dhi, uint64_t dlo,
                                       int scale_d) {
  if constexpr (PRODUCTS == 4) {
    wgmma_tf32_rs<N>(d, lo, dlo, scale_d);
    wgmma_tf32_rs<N>(d, lo, dhi, 1);
  } else {
    wgmma_tf32_rs<N>(d, lo, dhi, scale_d);
  }
  wgmma_tf32_rs<N>(d, hi, dlo, 1);
  wgmma_tf32_rs<N>(d, hi, dhi, 1);
}

// a 2-D box multicast to every CTA of the pair, completing on the barrier
// at the same offset in each
__device__ __forceinline__ void tma_load_2d_mc(uint32_t dst, const CUtensorMap* map, int c0,
                                               int c1, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_cta(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// the consumer warp's release of a ring stage: to every CTA reading it
__device__ __forceinline__ void release_stage(uint32_t bar) {
  if constexpr (CLUSTER == 1) {
    mbar_arrive(bar);
  } else {
#pragma unroll
    for (uint32_t c = 0; c < CLUSTER; ++c) mbar_arrive_cta(bar, c);
  }
}

// (re, im) of one local bin of the thread's two channels
struct Bin2 {
  float re[2], im[2];
};

// the intensity vector of one bin, normalized: IV_d = Re(conj(W) P_d) /
// (|IV|_2 + eps), as ops/features.py computes it; returns the thread's two
// stripe-1 values (d = c0, c0 + 1; d = 3 is the zero row q = 7)
__device__ __forceinline__ void iv_values(const Bin2& own, const Bin2& oth, bool even,
                                          float& v0, float& v1) {
  // channels 0..3 from the thread's pair and its partner's
  const float r0 = even ? own.re[0] : oth.re[0], i0 = even ? own.im[0] : oth.im[0];
  const float r1 = even ? own.re[1] : oth.re[1], i1 = even ? own.im[1] : oth.im[1];
  const float r2 = even ? oth.re[0] : own.re[0], i2 = even ? oth.im[0] : own.im[0];
  const float r3 = even ? oth.re[1] : own.re[1], i3 = even ? oth.im[1] : own.im[1];
  const float iv0 = r1 * r0 + i1 * i0, iv1 = r2 * r0 + i2 * i0, iv2 = r3 * r0 + i3 * i0;
  const float inv = 1.f / (sqrtf(iv0 * iv0 + iv1 * iv1 + iv2 * iv2) + EPS_F32);
  v0 = (even ? iv0 : iv2) * inv;
  v1 = even ? iv1 * inv : 0.f;
}

template <bool DIF, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
    logmel_iv_forms_kernel(const __grid_constant__ CUtensorMap tm_tab,
                           const __grid_constant__ CUtensorMap tm_fb, const FormArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  float* macc = reinterpret_cast<float*>(smem_raw + (base - raw0) + STAGES * STAGE);
  // WIDE: the block's mel sums (FR, 7, n_mels) in its scratch
  float* const gacc =
      WIDE ? p.acc + ((long)blockIdx.y * gridDim.x + blockIdx.x) * FR * 7 * p.n_mels : nullptr;
  const uint32_t astage = base + STAGES * STAGE + (WIDE ? 0 : ACC_BYTES);
  const uint32_t full = astage + A_BYTES<DIF>, empty = full + 8 * STAGES;
  const int b = blockIdx.y, f0 = blockIdx.x * FR;
  // a pair runs the ring together: both work if its first CTA has frames
  const bool work = (int)(blockIdx.x / CLUSTER * CLUSTER) * FR < p.n_frames;
  const int KB = p.kblocks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CWG * CLUSTER);  // every consumer warp of the pair
    }
    fence_barrier_init();
  }
  if constexpr (CLUSTER > 1) cluster_sync();
  else __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CWG) {
    // producer: per column tile its k-blocks (hi and lo tiles), then its mel table
    if constexpr (CWG == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS && work) {
      [[maybe_unused]] const uint32_t rank = CLUSTER > 1 ? cluster_rank() : 0;
      int s = 0;
      uint32_t ph = 0;
      auto next = [&]() {
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      };
      for (int t = 0; t < p.n_tiles; ++t) {
        for (int kb = 0; kb < KB; ++kb) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          if constexpr (PROBE & 8) {
            mbar_arrive(full + 8 * s);
          } else if constexpr (CLUSTER == 1) {
            mbar_expect_tx(full + 8 * s, STAGE);
            tma_load_2d(base + s * STAGE, &tm_tab, kb * BK, t * 2 * COLS, full + 8 * s);
          } else {  // each CTA loads one of hi and lo for both
            mbar_expect_tx(full + 8 * s, STAGE);
            tma_load_2d_mc(base + s * STAGE + rank * (STAGE / 2), &tm_tab, kb * BK,
                           t * 2 * COLS + rank * COLS, full + 8 * s, 3);
          }
          next();
        }
        // the tile's mel groups (one at n_mels <= 64)
        const int g0 = WIDE ? __ldg(p.plan + 2 * t + 1) : t;
        const int ng = WIDE ? __ldg(p.plan + 2 * t + 3) - g0 : 1;
        for (int gi = g0; gi < g0 + ng; ++gi) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          if constexpr (PROBE & 8) {
            mbar_arrive(full + 8 * s);
          } else if constexpr (CLUSTER == 1) {
            mbar_expect_tx(full + 8 * s, STAGE);
            tma_load_2d(base + s * STAGE, &tm_fb, 0, gi * 2 * MELS, full + 8 * s);
            tma_load_2d(base + s * STAGE + STAGE / 2, &tm_fb, BK, gi * 2 * MELS, full + 8 * s);
          } else {  // each CTA loads one k-half for both
            mbar_expect_tx(full + 8 * s, STAGE);
            tma_load_2d_mc(base + s * STAGE + rank * (STAGE / 2), &tm_fb, rank * BK,
                           gi * 2 * MELS, full + 8 * s, 3);
          }
          next();
        }
      }
    }
  } else {
    if constexpr (CWG == 2) setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const bool even = (g & 1) == 0;
    const int c0 = 2 * (g & 1);                     // channels c0 (row g), c0 + 1 (row g + 8)
    const int fl = FR_WG * wg + 4 * warp + g / 2;  // the thread's frame in the block
    const int F = f0 + fl;
    const bool avalid = F < p.n_frames;
    const int hf = p.n_fft / 2;
    const float* xc0 = p.x + ((long)b * 4 + c0) * p.N;
    const float* xc1 = xc0 + p.N;
    // the thread's own mel sums start at zero: mels m = 2 t + e (mod 8),
    // rows q = c0, c0 + 1, 4 + c0, 5 + c0 (q < 7)
    if constexpr (WIDE) {
      for (int m = 2 * t; m < p.n_mels; m += 8)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = 4 * (i >> 2) + c0 + ((i >> 1) & 1), mm = m + (i & 1);
          if (q < 7 && mm < p.n_mels) gacc[(fl * 7 + q) * p.n_mels + mm] = 0.f;
        }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int q = 4 * (i / 32) + c0 + ((i & 3) >> 1),
                  m = 8 * ((i % 32) >> 2) + 2 * t + (i & 1);
        if (q < 7) macc[fl * ACC_LD + q * MELS + m] = 0.f;
      }
    }

    if (work) {
      // the thread's samples of its two rows in k-block kb: k steps 2 j and
      // 2 j + 1 take samples 32 kb + 16 j + 4 t + {0, 1} (A columns t, t + 4
      // of step 2 j) and + {2, 3} (of step 2 j + 1), one 16-byte vector:
      // raw[.][h][4 j + i]; the tables hold the same k order (k_order in
      // ops/frontend_forms.py). DIF: the sum (u) and difference (v) streams
      // of the frame's two halves. The vectors are fetched a k-block ahead
      // with cp.async into the thread's slots in shared memory (wgmma.fence
      // would wait for loads into registers), or, at the reflect pad and the
      // zero tail, loaded and stored.
      constexpr int RAWS = DIF ? 2 : 1;
      float raw[RAWS][2][8];
      auto slot = [&](int buf, int sl) {
        return astage + ((buf * SLOTS<DIF> + sl) * CONSUMERS + threadIdx.x) * 16;
      };
      auto fetch = [&](int kb, int buf) {
        const long ip = (long)F * p.hop + kb * BK;  // the k-block's first index into the padded signal
        const int len = DIF ? hf : p.n_fft;
        const long lo0 = ip - hf;                   // its first sample's index into x
        const bool fast = avalid && lo0 >= 0 && ip + (DIF ? BK : BK - hf) <= p.N &&
                          kb * BK + BK <= len;
#pragma unroll
        for (int sl = 0; sl < SLOTS<DIF>; ++sl) {
          const int part = sl & 1, h = (sl >> 1) & 1, hh = sl >> 2;  // hh: DIF's second half
          const float* xc = h ? xc1 : xc0;
          const int o = 16 * part + 4 * t;  // the vector's offset in the k-block
          const uint32_t dst = slot(buf, sl);
          if (fast && p.vec) {
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                         "l"(xc + lo0 + hh * hf + o) : "memory");
          } else if (fast) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4 * i),
                           "l"(xc + lo0 + hh * hf + o + i) : "memory");
          } else {
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = avalid && kb * BK + o + i < len
                         ? padded_sample(xc, p.N, hf, ip + o + i + hh * hf) : 0.f;
            asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "f"(v[0]),
                         "f"(v[1]), "f"(v[2]), "f"(v[3]) : "memory");
          }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
      auto take = [&](int buf, int kb) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        // DIF, WIDE: the window of the thread's samples, w[n] and w[n + N/2]
        // of the vector at offset 16 part + 4 t of the k-block
        [[maybe_unused]] float4 wv[2][2];
        if constexpr (DIF && WIDE) {
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              wv[part][hh] = __ldg(reinterpret_cast<const float4*>(
                  p.win + hh * KB * BK + kb * BK + 16 * part + 4 * t));
        }
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
          const int part = sl & 1, h = sl >> 1;
          float a[4], z[4];
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(a[0]), "=f"(a[1]), "=f"(a[2]), "=f"(a[3]) : "r"(slot(buf, sl)));
          if constexpr (DIF) {
            asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                         : "=f"(z[0]), "=f"(z[1]), "=f"(z[2]), "=f"(z[3])
                         : "r"(slot(buf, sl + 4)));
            if constexpr (WIDE) {
              const float wl[4] = {wv[part][0].x, wv[part][0].y, wv[part][0].z, wv[part][0].w};
              const float wh[4] = {wv[part][1].x, wv[part][1].y, wv[part][1].z, wv[part][1].w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                // the windowed halves, rounded before their sum and difference
                // (no contraction: the plain version rounds both products)
                a[i] = __fmul_rn(a[i], wl[i]);
                z[i] = __fmul_rn(z[i], wh[i]);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              raw[0][h][4 * part + i] = a[i] + z[i];
              raw[DIF ? 1 : 0][h][4 * part + i] = a[i] - z[i];
            }
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) raw[0][h][4 * part + i] = a[i];
          }
        }
      };
      // NG commit groups a k-block, two k steps each: flat, group G takes k
      // steps 2G, 2G + 1; DIF, group G takes k steps 2 (G / 2), + 1 of stream
      // G % 2 (the sum stream into the first 64 columns, the difference
      // stream into the last 64)
      constexpr int NG = DIF ? 4 : 2;
      auto make = [&](Frag<2>& f, int G) {
        const int r = DIF ? (G & 1) : 0, kk0 = DIF ? 2 * (G >> 1) : 2 * G;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int kk = kk0 + k;
          const float a[4] = {raw[r][0][2 * kk], raw[r][1][2 * kk], raw[r][0][2 * kk + 1],
                              raw[r][1][2 * kk + 1]};
          if constexpr (PROBE & 2) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              f.hi[k][i] = __float_as_uint(a[i]);
              f.lo[k][i] = 0u;
            }
          } else {
            split_frag(f, k, a[0], a[1], a[2], a[3]);
          }
        }
      };
      // acc: the k-block's sums in the tensor cores (flat: m64n128; DIF: [0,
      // 32) the sum-stream half, [32, 64) the difference-stream half); run:
      // the tile's running sums, acc added once a chunk of CHUNK k-blocks
      float acc[64], run[64];
      float(&runU)[32] = *reinterpret_cast<float(*)[32]>(run);
      float(&runV)[32] = *reinterpret_cast<float(*)[32]>(run + 32);
      Frag<2> fr[2];
      int s = 0, prev = 0;
      uint32_t ph = 0;
      auto next = [&]() {
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      };
      fetch(0, 0);
      int kc = 0;  // k-blocks taken so far: their staging buffer alternates
      for (int tile = 0; tile < p.n_tiles; ++tile) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        for (int kb = 0; kb < KB; ++kb, ++kc) {
          take(kc & 1, kb);
          // the next k-block's samples (the next tile reads the same rows
          // from k-block 0)
          if ((kb + 1 < KB || tile + 1 < p.n_tiles) && !(PROBE & 1))
            fetch(kb + 1 < KB ? kb + 1 : 0, (kc + 1) & 1);
          uint64_t dh = 0;
          // the k-block continues the accumulator's sum (the second of a
          // pair); FE_PROBE 16 sums the whole tile there (one level)
          const int cont = (PROBE & 16) ? kb > 0 : kb % CHUNK != 0;
#pragma unroll
          for (int G = 0; G < NG; ++G) {
            Frag<2>& f = fr[G & 1];
            make(f, G);
            if (G == 0) {
              mbar_wait(full + 8 * s, ph);
              dh = desc_sw128(base + s * STAGE);
            }
            const uint64_t dl = dh + (STAGE / 2 >> 4);  // the lo tile: 16 KB on
            wgmma_fence();
            if constexpr (DIF) {
              // the difference stream's columns: table rows 64 .. 127, 8 KB on
              const int kk0 = 2 * (G >> 1), off = (G & 1) ? 512 : 0;
              float(&d)[32] = *reinterpret_cast<float(*)[32]>(acc + ((G & 1) ? 32 : 0));
#pragma unroll
              for (int k = 0; k < 2; ++k)
                split3<64>(d, f.hi[k], f.lo[k], dh + off + 2 * (kk0 + k), dl + off + 2 * (kk0 + k),
                           cont | (kk0 + k));
            } else {
#pragma unroll
              for (int k = 0; k < 2; ++k)
                split3<128>(acc, f.hi[k], f.lo[k], dh + 2 * (2 * G + k), dl + 2 * (2 * G + k),
                            cont | (2 * G + k));
            }
            wgmma_commit();
            wgmma_wait<1>();  // the group before has retired
            fence_frag(fr[(G & 1) ^ 1]);
            // a chunk's later k-block, first group: the k-block before has
            // retired, its stage is free
            if (G == 0 && cont && lane == 0) release_stage(empty + 8 * prev);
          }
          prev = s;
          next();
          if (((PROBE & 16) ? 0 : kb % CHUNK == CHUNK - 1) || kb == KB - 1) {  // into the running sum
            wgmma_wait<0>();
            fence_frag(fr[(NG - 1) & 1]);
            fence_regs(acc);
            if (lane == 0) release_stage(empty + 8 * prev);
#pragma unroll
            for (int i = 0; i < 64; ++i) run[i] = kb < CHUNK ? acc[i] : run[i] + acc[i];
          }
        }

        // epilogue: the tile's mel tables are the next stages, a group of
        // 64 mels each; stripe 0 (the powers of the thread's own channels),
        // then stripe 1 (the intensity vector, after swapping channels with
        // lane ^ 4)
        // DIF: the narrow form applies the window here, as the 3-tap with
        // one shuffle across each 16-bin edge (the WIDE form applied it to
        // the samples); the neighbours across the thread's 16-bin edges
        [[maybe_unused]] float ue[2][2], ve[2][2];
        [[maybe_unused]] int bin0 = 0;
        if constexpr (DIF && !WIDE) {
          bin0 = 2 * (p.s0 + 31 * tile) - 1 + 16 * t;  // the bin of the thread's local 16 t
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              ue[h][c] = __shfl_up_sync(0xffffffffu, runU[28 + 2 * h + c], 1, 4);
              ve[h][c] = __shfl_down_sync(0xffffffffu, runV[2 * h + c], 1, 4);
            }
        }
        // (re, im) of locals 16 t + 2 kk2 + e of the thread's channels
        auto own_bins = [&](Bin2 (&own)[2], int kk2) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if constexpr (DIF) {
                // e = 0: difference-stream value j = kk2, neighbours U_{j-1}, U_j;
                // e = 1: sum-stream value j, neighbours V_j, V_{j+1}
                const int j = kk2;
                const float xr = e == 0 ? runV[4 * j + 2 * h] : runU[4 * j + 2 * h];
                const float xi = e == 0 ? runV[4 * j + 2 * h + 1] : runU[4 * j + 2 * h + 1];
                if constexpr (WIDE) {
                  own[e].re[h] = xr;
                  own[e].im[h] = xi;
                } else {
                  float lr, li, rr, ri;
                  if (e == 0) {
                    lr = j > 0 ? runU[4 * (j - 1) + 2 * h] : ue[h][0];
                    li = j > 0 ? runU[4 * (j - 1) + 2 * h + 1] : ue[h][1];
                    rr = runU[4 * j + 2 * h];
                    ri = runU[4 * j + 2 * h + 1];
                  } else {
                    lr = runV[4 * j + 2 * h];
                    li = runV[4 * j + 2 * h + 1];
                    rr = j < 7 ? runV[4 * (j + 1) + 2 * h] : ve[h][0];
                    ri = j < 7 ? runV[4 * (j + 1) + 2 * h + 1] : ve[h][1];
                  }
                  const int bin = bin0 + 2 * kk2 + e;
                  if (bin == 0) {  // X[-1] = conj(X[1])
                    lr = rr;
                    li = -ri;
                  }
                  if (bin == hf) {  // X[N/2+1] = conj(X[N/2-1])
                    rr = lr;
                    ri = -li;
                  }
                  own[e].re[h] = p.a0 * xr + p.a1 * (lr + rr);
                  own[e].im[h] = p.a0 * xi + p.a1 * (li + ri);
                }
              } else {
                const int j = 2 * kk2 + e;
                own[e].re[h] = run[4 * j + 2 * h];
                own[e].im[h] = run[4 * j + 2 * h + 1];
              }
            }
        };
        // WIDE: the tile's window of mels (its first, rounded down to a
        // multiple of 8) and its groups
        const int mel0 = WIDE ? __ldg(p.plan + 2 * tile) : 0;
        const int ng = WIDE ? __ldg(p.plan + 2 * tile + 3) - __ldg(p.plan + 2 * tile + 1) : 1;
#pragma unroll 1
        for (int gj = 0; gj < ng; ++gj) {
          mbar_wait(full + 8 * s, ph);
          const uint64_t fh0 = desc_sw128(base + s * STAGE);
          if constexpr (PROBE & 4) {  // the sums stay live: stored only on a value no run gives
            float sink = 0.f;
#pragma unroll
            for (int i = 0; i < 64; ++i) sink += run[i];
            if (sink == 1.2345e-30f) macc[fl * ACC_LD] = sink;
          }
          Frag<2> mf[2];
#pragma unroll
          for (int st = 0; st < ((PROBE & 4) ? 0 : 2); ++st) {
            float mel[32];  // rows q = 4 st + c0 + h: the tile's mel sums
#pragma unroll
            for (int i = 0; i < 32; ++i) mel[i] = 0.f;
            // a commit group a pair of k steps kk2 (locals 16 t + 2 kk2 + e)
#pragma unroll
            for (int kq = 0; kq < 4; ++kq) {
              Frag<2>& f = mf[kq & 1];
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const int kk2 = 2 * kq + k;
                Bin2 own[2];
                own_bins(own, kk2);
                float v[2][2];  // [e][h]
                if (st == 0) {
#pragma unroll
                  for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                      v[e][h] = own[e].re[h] * own[e].re[h] + own[e].im[h] * own[e].im[h];
                } else {
                  Bin2 oth[2];
#pragma unroll
                  for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                      oth[e].re[h] = __shfl_xor_sync(0xffffffffu, own[e].re[h], 4);
                      oth[e].im[h] = __shfl_xor_sync(0xffffffffu, own[e].im[h], 4);
                    }
#pragma unroll
                  for (int e = 0; e < 2; ++e) iv_values(own[e], oth[e], even, v[e][0], v[e][1]);
                }
                split_frag(f, k, v[0][0], v[0][1], v[1][0], v[1][1]);
              }
              // locals 16 (c % 4) + 2 kk2 + c / 4 sit at k 8 kk2 + c of the
              // mel table: k-half kk2 / 4 (16 KB on), 32 bytes a step; lo 8 KB on
              wgmma_fence();
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const int kk2 = 2 * kq + k;
                const uint64_t fh = fh0 + (kk2 / 4) * (STAGE / 2 >> 4) + 2 * (kk2 % 4);
                split3<64>(mel, f.hi[k], f.lo[k], fh, fh + 512, kk2);
              }
              wgmma_commit();
              wgmma_wait<1>();
              fence_frag(mf[(kq & 1) ^ 1]);
            }
            wgmma_wait<0>();
            fence_frag(mf[1]);
            fence_regs(mel);
            // the tile's mel sums into the block's, each sum by its one owner
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int q = 4 * st + c0 + ((i & 3) >> 1), m = 8 * (i >> 2) + 2 * t + (i & 1);
              if constexpr (WIDE) {
                const int mm = mel0 + MELS * gj + m;
                if (q < 7 && mm < p.n_mels) gacc[(fl * 7 + q) * p.n_mels + mm] += mel[i];
              } else {
                if (q < 7) macc[fl * ACC_LD + q * MELS + m] += mel[i];
              }
            }
          }
          if (lane == 0) release_stage(empty + 8 * s);
          next();
        }
      }
    }
    if constexpr (WIDE) __threadfence_block();  // the scratch's sums, for the other consumers
    named_barrier(1, CONSUMERS);
    // the block's outputs: dB on the powers, the affine, zeros from n_frames
    // on, frames up to t_out, float32 or bf16
    for (int idx = threadIdx.x; idx < 7 * FR * p.n_mels; idx += CONSUMERS) {
      const int m = idx % p.n_mels, rest = idx / p.n_mels;
      const int flo = rest % FR, q = rest / FR, f = f0 + flo;
      if (f >= p.t_out) continue;
      float v = 0.f;
      if (f < p.n_frames) {
        v = WIDE ? gacc[(flo * 7 + q) * p.n_mels + m] : macc[flo * ACC_LD + q * MELS + m];
        if (q < 4) v = 10.f * log10f(fmaxf(v, 1e-10f));
        if (p.aff != nullptr)
          v = v * __ldg(p.aff + q * p.n_mels + m) + __ldg(p.aff + (7 + q) * p.n_mels + m);
      }
      const long o = (((long)b * 7 + q) * p.t_out + f) * p.n_mels + m;
      if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
      else static_cast<float*>(p.out)[o] = v;
    }
  }
  if constexpr (CLUSTER > 1) cluster_sync();  // no CTA leaves while its pair may signal it
}

// Host: the tensor maps (encoded on every launch: they hold raw addresses)
// and the launch. tab (n_tiles, 2, 128, Kp) float32: per tile the hi and
// lo tables, rows the tile's columns, k in the permuted order; fb
// (n_groups, 2, 64, 64) float32: per mel group the hi and lo mel tables,
// rows the group's mels, k its tile's local bins in the permuted order;
// plan (n_tiles + 1, 2) int32: per tile its first mel and first group (a
// tile t takes groups plan[t][1] .. plan[t + 1][1] - 1; at n_mels <= 64
// group t, mels from 0); acc: WIDE's scratch.
template <bool DIF, bool WIDE>
inline int launch_form(const float* tab, const float* fb, const FormArgs& a, int B, int Kp,
                       int n_groups, cudaStream_t stream) {
  CUtensorMap tm_tab, tm_fb;
  const uint64_t tdims[2] = {static_cast<uint64_t>(Kp), static_cast<uint64_t>(a.n_tiles) * 2 * COLS};
  const uint64_t tstr[1] = {static_cast<uint64_t>(Kp) * 4};
  const uint32_t tbox[2] = {BK, 2 * COLS / CLUSTER};
  const uint64_t fdims[2] = {LOCALS, static_cast<uint64_t>(n_groups) * 2 * MELS};
  const uint64_t fstr[1] = {LOCALS * 4};
  const uint32_t fbox[2] = {BK, 2 * MELS};
  cudaError_t e = make_tmap(&tm_tab, tab, 2, tdims, tstr, tbox, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e == cudaSuccess)
    e = make_tmap(&tm_fb, fb, 2, fdims, fstr, fbox, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(logmel_iv_forms_kernel<DIF, WIDE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<DIF, WIDE>);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (a.t_out + FR - 1) / FR;
  const dim3 grid((blocks + CLUSTER - 1) / CLUSTER * CLUSTER, B);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM<DIF, WIDE>;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, logmel_iv_forms_kernel<DIF, WIDE>, tm_tab, tm_fb, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the narrow form at n_mels <= 64, the WIDE one above (its scratch given)
template <bool DIF>
inline int launch_forms(const float* tab, const float* fb, const FormArgs& a, int B, int Kp,
                        int n_groups, cudaStream_t stream) {
  const bool wide = a.n_mels > MELS;
  if (B < 1 || B > 65535 || a.N <= a.n_fft / 2 || a.hop < 1 || Kp % BK != 0 || a.n_tiles < 1 ||
      a.n_mels < 1 || a.t_out < a.n_frames || a.n_frames < 1 || a.plan == nullptr ||
      n_groups < a.n_tiles || (!wide && n_groups != a.n_tiles) || (wide && a.acc == nullptr) ||
      (long)a.n_tiles * 2 * COLS > (1L << 31) - 1 || (long)n_groups * 2 * MELS > (1L << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return wide ? launch_form<DIF, true>(tab, fb, a, B, Kp, n_groups, stream)
              : launch_form<DIF, false>(tab, fb, a, B, Kp, n_groups, stream);
}

}  // namespace fe
