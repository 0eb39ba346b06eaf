// Kernel K8: the HTSAT patch embed, eval.
//
// Replaces the JAX package's ops/pallas/patch_embed.py::patch_embed_tokens
// (_kernel, pallas_call at :119) at F = 64, 128 and 256 mel bins (HTSAT's
// spec_size 256 at freq_ratio 4, 2 and 1): normalized features (B, C, T, F) -> the
// stage-0 tokens (B, L, E), L = fr * (F / 4) * (T_img / fr / 4): HTSAT's
// reshape_wav2img (image row g F + f, column t'' for frame t = g (T_img /
// fr) + t''), the 4 x 4 stride-4 VALID conv with compute-dtype operands
// and float32 accumulation, the bias and the LayerNorm (eps 1e-5) in
// float32 over the E channels, and one rounding to the compute dtype, in
// the token order row-major (g, fp, tp) that kernel K2 reads. Frames from T
// to T_img are zeros (the reshape_wav2img pad), read as such.
//
// What bounds it on the H100: memory. At the serving shape (32, 7, 1024,
// 64) bf16 -> (32, 4096, 96) bf16 it reads 29.4 MB and writes 25.2 MB
// (0.016 ms at 3.35 TB/s) for 2.8 GFLOP: a GEMM of M = 131072 tokens, K =
// 7 * 16 = 112, N = 96, whose products on the CUDA cores' float32 FMA
// alone would take 0.042 ms.
//
// Design (bf16, the served form): a tile is the 128 tokens of one (b, g)
// and TPB = 8 / H time patches: all FP = 16 H frequency patches of 32 / H
// frames (H = F / 64: 8 time patches of 32 frames at F = 64), whose raw
// input is H 4-D TMA boxes x[b, 0:7, t0:t0 + 32 / H, 64 h:64 h + 64], one
// a 64-bin half (28 KB in all, 128-byte swizzle over 128-byte rows; frames
// past T arrive as TMA's zeros, the wav2img pad).
// Persistent blocks (two an SM, 256 threads: two warpgroups of 64 GEMM
// rows) walk the tiles t = blockIdx.x, + gridDim.x, ... (grid min(tiles,
// CTAS_PER_SM x the SM count), set in launch_wgmma); one thread keeps the
// next tiles' boxes in flight in a 2-stage mbarrier ring. The (112, 96)
// weights are loaded once a block, as bf16, into seven k16 slices in
// wgmma's K-major B layout (32-byte swizzle). The products run on the
// tensor cores: seven wgmma.m64n96k16 with A from registers, one a
// channel, A's fragments gathered straight from the raw tile: within a
// channel k = kw 4 + kh (ops/patch_embed.py lays the weights out so), so a
// fragment's pair (k, k + 1) is two adjacent mel bins of one frame, one
// 4-byte shared load. GEMM row m of a tile is token (fp, tp) with bits m0
// -> tp0, m1 -> fp0, m2 -> fp2, m3 -> fp1, m4 -> fp3, then m5, m6 -> tp1,
// tp2 (F = 64), fp4, tp1 (128) or fp4, fp5 (256), which puts a fragment
// load's 32 lanes on 32 banks of the swizzled tile (each half's box holds
// a frame's 64 bins in one 128-byte row, row % 8 the frame's low bits).
// GEMM column n is channel e = 24 (n / 2 % 4) + 2 (n / 8) + n % 2, so each
// thread holds 24 consecutive channels of its two rows. The epilogue runs
// in registers: bias, the two-pass LayerNorm (mean, then the centred
// variance) reduced over the 4 lanes of a row with shuffles, one rounding,
// three 16-byte stores a row into a staging tile in (fp, tp) order
// (conflict-free: rows 2i and 2i + 1 differ in tp0), and one TMA store of
// the tile as FP runs of TPB tokens.
//
// The float32 form (not on the served path) runs the products as float32
// FMA on the CUDA cores: each block gathers its tile's C x 4 x 4 patches
// into shared memory, keeps the weights there in float32, and a thread
// owns 4 tokens x 12 channels.

#include <algorithm>

#include "sm90_gemm.cuh"

namespace {

constexpr int E = 96;     // embed width (HTSAT's published 96)
constexpr int TOK = 128;  // tokens a tile: 16 H frequency patches x 8 / H time patches
constexpr float LN_EPS = 1e-5f;

// ---------------------------------------------------------------------------
// bf16: TMA-fed wgmma

constexpr int NC = 7;                     // channels: K = 16 NC = 112
constexpr int THREADS = 256;              // two warpgroups
constexpr int CTAS_PER_SM = 2;
constexpr int STAGES = 2;
constexpr int ROW_BYTES = 128;                    // one frame's 64 bf16 bins of a half
constexpr int STAGE_BYTES = NC * 32 * ROW_BYTES;  // a tile's H boxes: 32 rows a channel
constexpr int SLICE_BYTES = E * 32;       // one channel's k16 weight slice
constexpr int W_BYTES = NC * SLICE_BYTES;
constexpr int OUT_BYTES = TOK * E * 2;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + W_BYTES + OUT_BYTES + 3 * E * 4 + 8 * STAGES +
                           1024;

// GEMM row m of a tile -> its token's frequency patch and time patch, for
// H 64-bin halves (F = 64 H)
template <int H>
__device__ __forceinline__ int row_fp(int m) {
  const int low = ((m >> 1) & 1) | ((m >> 3) & 1) << 1 | ((m >> 2) & 1) << 2 | ((m >> 4) & 1) << 3;
  return low | (H >= 2 ? ((m >> 5) & 1) << 4 : 0) | (H == 4 ? ((m >> 6) & 1) << 5 : 0);
}
template <int H>
__device__ __forceinline__ int row_tp(int m) {
  return (m & 1) | (H == 1 ? ((m >> 5) & 1) << 1 | ((m >> 6) & 1) << 2
                           : H == 2 ? ((m >> 6) & 1) << 1 : 0);
}
// channel e -> its GEMM column n (the inverse of e = 24 (n / 2 % 4) + 2 (n / 8) + n % 2)
__device__ __forceinline__ int gemm_col(int e) {
  const int q = e / 24, j = e % 24 / 2;
  return 8 * j + 2 * q + (e & 1);
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float4 lds128f(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// D (64 x 96 float32) = A . B^T (+ D when scale_d), A 64 x 16 bf16 from
// registers (mma.sync's A fragment: rows l / 4 and + 8 of the warp's 16,
// columns 2 (l % 4) and + 8), B 96 x 16 from shared memory K-major
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int H>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
    patch_embed_wgmma(const __grid_constant__ CUtensorMap tma_x,
                      const __grid_constant__ CUtensorMap tma_out, const bf16* __restrict__ w,
                      const float* __restrict__ bias, const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b, int tiles, int fr, int tg) {
  constexpr int FP = 16 * H, TPB = 8 / H;               // a tile's patches
  constexpr int CH_BYTES = 4 * TPB * ROW_BYTES;         // one channel's frames of a half
  constexpr int HALF_BYTES = NC * CH_BYTES;             // one half's box
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sX = base, sW = sX + STAGES * STAGE_BYTES, sOut = sW + W_BYTES;
  const uint32_t sPar = sOut + OUT_BYTES, full = sPar + 3 * E * 4;
  const int tid = threadIdx.x, tblk = tg / 4 / TPB;
  const CUtensorMap* mx = &tma_x;

  // tile t: clip b, wav2img group g, first time patch tp0
  auto tile_at = [&](int t, int& b, int& g, int& tp0) {
    b = t / (fr * tblk);
    const int rest = t % (fr * tblk);
    g = rest / tblk;
    tp0 = rest % tblk * TPB;
  };
  auto load = [&](int t, int s) {
    int b, g, tp0;
    tile_at(t, b, g, tp0);
    mbar_expect_tx(full + 8 * s, STAGE_BYTES);
#pragma unroll
    for (int h = 0; h < H; ++h)
      tma_load_4d(sX + s * STAGE_BYTES + h * HALF_BYTES, mx, 64 * h, g * tg + 4 * tp0, 0, b,
                  full + 8 * s);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + 8 * s, 1);
    fence_barrier_init();
    for (int s = 0; s < STAGES; ++s)
      if (blockIdx.x + s * gridDim.x < tiles) load(blockIdx.x + s * gridDim.x, s);
  }
  // the weights once a block: row k of w (K-major in (c, kw, kh)) to slice
  // k / 16, row n = gemm_col(e), column k % 16, with the 32-byte swizzle
  // (byte bit 4 ^= bit 7)
  for (int i = tid; i < NC * 16 * (E / 8); i += THREADS) {
    const int k = i / (E / 8), e0 = i % (E / 8) * 8;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + k * E + e0));
    const unsigned short* h = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uint32_t off = gemm_col(e0 + u) * 32 + k % 16 * 2;
      off ^= (off >> 7 & 1) << 4;
      asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(sW + k / 16 * SLICE_BYTES + off),
                   "h"(h[u]));
    }
  }
  for (int i = tid; i < 3 * E; i += THREADS) {
    const float v = i < E ? bias[i] : i < 2 * E ? ln_w[i - E] : ln_b[i - 2 * E];
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(sPar + 4 * i), "f"(v));
  }
  fence_async_shared();  // the weights, written here, are read by wgmma
  __syncthreads();

  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32, q = lane % 4;
  // a fragment's four loads in a channel's swizzled frame rows of its half:
  // rows r and r + 8 (j % 2) at kw = q / 2 and + 2 (j / 2), bins kh = 2 (q
  // % 2), + 1 (bin f: half f / 64, position f % 64 in the row)
  uint32_t off[4];
  int tok[2];  // the two rows' tokens fp * TPB + tp in the tile
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = 64 * wg + 16 * warp + lane / 4 + 8 * (j % 2);
    const int t = 4 * row_tp<H>(m) + q / 2 + 2 * (j / 2), f = 4 * row_fp<H>(m) + 2 * (q % 2);
    const int fl = f % 64;
    off[j] = f / 64 * HALF_BYTES + t * ROW_BYTES + ((fl / 8) ^ (t % 8)) * 16 + fl % 8 * 2;
    if (j < 2) tok[j] = row_fp<H>(m) * TPB + row_tp<H>(m);
  }
  float acc[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) acc[i] = 0.f;

  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int s = it % STAGES;
    const uint32_t stage = sX + s * STAGE_BYTES;
    mbar_wait(full + 8 * s, it / STAGES & 1);
    uint32_t a[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[c][j] = lds32(stage + c * CH_BYTES + off[j]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c) wgmma_rs_n96(acc, a[c], desc_sw32(sW + c * SLICE_BYTES), c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) bulk_wait_read();  // the previous tile's store has read the staging tile
    __syncthreads();                 // and every thread has read stage s
    if (tid == 0 && t + STAGES * gridDim.x < tiles) load(t + STAGES * gridDim.x, s);

    // epilogue: row h's 24 channels 24 q + 2 j + i sit in acc[4 j + 2 h + i]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[24];
      float sum = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < 6; ++j4) {
        const float4 bv = lds128f(sPar + 4 * (24 * q + 4 * j4));
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = 4 * j4 + u;  // channel 24 q + c
          v[c] = acc[4 * (c / 2) + 2 * h + c % 2] + bb[u];
          sum += v[c];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float mean = sum * (1.f / E);
      float var = 0.f;
#pragma unroll
      for (int c = 0; c < 24; ++c) {
        const float d = v[c] - mean;
        var += d * d;
      }
      var += __shfl_xor_sync(0xffffffffu, var, 1);
      var += __shfl_xor_sync(0xffffffffu, var, 2);
      const float rstd = rsqrtf(var * (1.f / E) + LN_EPS);
      uint32_t packed[12];
#pragma unroll
      for (int j4 = 0; j4 < 6; ++j4) {
        const float4 gv = lds128f(sPar + 4 * (E + 24 * q + 4 * j4));
        const float4 be = lds128f(sPar + 4 * (2 * E + 24 * q + 4 * j4));
        const int c = 4 * j4;
        packed[2 * j4] = pack_bf16((v[c] - mean) * rstd * gv.x + be.x,
                                   (v[c + 1] - mean) * rstd * gv.y + be.y);
        packed[2 * j4 + 1] = pack_bf16((v[c + 2] - mean) * rstd * gv.z + be.z,
                                       (v[c + 3] - mean) * rstd * gv.w + be.w);
      }
      const uint32_t dst = sOut + tok[h] * (E * 2) + 48 * q;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + 16 * k),
                     "r"(packed[4 * k]), "r"(packed[4 * k + 1]), "r"(packed[4 * k + 2]),
                     "r"(packed[4 * k + 3]));
    }
    fence_async_shared();
    __syncthreads();
    if (tid == 0) {
      int b, g, tp0;
      tile_at(t, b, g, tp0);
      tma_store_4d(&tma_out, sOut, 0, tp0, g * FP, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

// the kernel's shared-memory limit, set once a device and form (sm_count(),
// from sm90_gemm.cuh, is looked up once): the wrapper's host cost a call is
// of the kernel's order
constexpr int MAX_DEVICES = 64;
bool smem_limit_set[MAX_DEVICES][3];

template <int H>
cudaError_t set_smem_limit() {
  constexpr int form = H == 1 ? 0 : H == 2 ? 1 : 2;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_limit_set[dev][form]) {
    e = cudaFuncSetAttribute(patch_embed_wgmma<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return e;
    smem_limit_set[dev][form] = true;
  }
  return cudaSuccess;
}

template <int H>
cudaError_t launch_wgmma(const bf16* x, const bf16* w, const float* bias, const float* ln_w,
                         const float* ln_b, bf16* out, int B, int C, int T_in, int T_img, int fr,
                         cudaStream_t stream) {
  constexpr int F = 64 * H, FP = 16 * H, TPB = 8 / H;
  const int tg = T_img / fr, tp_n = tg / 4;
  cudaError_t e = set_smem_limit<H>();
  if (e != cudaSuccess) return e;
  CUtensorMap tx, to;
  // x (B, C, T_in, F) as (F, T_in, C, B) in boxes of one tile's half (64, 4 TPB, C, 1)
  const uint64_t xd[4] = {F, (uint64_t)T_in, (uint64_t)C, (uint64_t)B};
  const uint64_t xs[3] = {F * 2, (uint64_t)T_in * F * 2, (uint64_t)C * T_in * F * 2};
  const uint32_t xb[4] = {64, 4 * TPB, (uint32_t)C, 1};
  e = make_tmap(&tx, x, 4, xd, xs, xb);
  // out (B, fr FP tp_n, 96) as (96, tp_n, fr FP, B) in boxes of one tile's (96, TPB, FP, 1)
  const uint64_t od[4] = {E, (uint64_t)tp_n, (uint64_t)fr * FP, (uint64_t)B};
  const uint64_t os[3] = {E * 2, (uint64_t)tp_n * E * 2, (uint64_t)fr * FP * tp_n * E * 2};
  const uint32_t ob[4] = {E, TPB, FP, 1};
  if (e == cudaSuccess) e = make_tmap(&to, out, 4, od, os, ob, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  const int tiles = B * fr * (tp_n / TPB), grid = std::min(tiles, CTAS_PER_SM * sm_count());
  patch_embed_wgmma<H><<<grid, THREADS, SMEM_BYTES, stream>>>(tx, to, w, bias, ln_w, ln_b,
                                                              tiles, fr, tg);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMA

constexpr int F32_THREADS = 256;  // 32 token groups of 4 x 8 channel groups

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__global__ void __launch_bounds__(F32_THREADS, 2) patch_embed_f32(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, float* __restrict__ out,
    int C, int T_in, int T_img, int fr, int F) {
  extern __shared__ float4 smem4[];
  const int K = C * 16;
  float* ps = reinterpret_cast<float*>(smem4);  // [K][TOK] patch values
  float* ws = ps + K * TOK;                     // [K][E] weights
  const int tid = threadIdx.x;
  const int FP = F / 4, TPB = TOK / FP;          // a tile's patches: 16 x 8 at F = 64
  const int tg = T_img / fr, tp_n = tg / 4;
  const int tblk = tp_n / TPB;
  const int b = blockIdx.x / (fr * tblk), rest = blockIdx.x % (fr * tblk);
  const int g = rest / tblk, tp0 = (rest % tblk) * TPB;

  for (int i = tid; i < K * E; i += F32_THREADS) ws[i] = __ldg(w + i);
  // patch gather: (c, frame r of the block's 4 TPB, frequency f) -> k = (c 4
  // + r % 4) 4 + f % 4 (the conv's (c, kw, kh)), token f / 4 * TPB + r / 4
  const int t0 = g * tg + tp0 * 4;
  for (int i = tid; i < C * TPB * 4 * F; i += F32_THREADS) {
    const int f = i % F, r = i / F % (TPB * 4), c = i / (TPB * 4 * F);
    const int t = t0 + r;
    const float v = t < T_in ? x[(((long)b * C + c) * T_in + t) * F + f] : 0.f;
    ps[((c * 4 + (r & 3)) * 4 + (f & 3)) * TOK + (f >> 2) * TPB + (r >> 2)] = v;
  }
  __syncthreads();

  // thread: tokens 4 tgi .. 4 tgi + 3 of the tile's (fp, tp) order,
  // channels j 32 + cg 4 + i for j < 3, i < 4
  const int cg = tid & 7, tgi = tid >> 3;
  float acc[4][12];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 12; ++e) acc[a][e] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float4 p = reinterpret_cast<const float4*>(ps + k * TOK)[tgi];
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float4 wv = reinterpret_cast<const float4*>(ws + k * E + j * 32)[cg];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][j * 4 + 0] += pv[a] * wv.x;
        acc[a][j * 4 + 1] += pv[a] * wv.y;
        acc[a][j * 4 + 2] += pv[a] * wv.z;
        acc[a][j * 4 + 3] += pv[a] * wv.w;
      }
    }
  }

  float bs[12];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) bs[j * 4 + i] = __ldg(bias + j * 32 + cg * 4 + i);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int fp = (4 * tgi + a) / TPB, tp = (4 * tgi + a) % TPB;
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 12; ++e) {
      acc[a][e] += bs[e];
      s += acc[a][e];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    const float mean = s * (1.f / E);
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < 12; ++e) {
      const float d = acc[a][e] - mean;
      q += d * d;
    }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    q += __shfl_xor_sync(0xffffffffu, q, 4);
    const float rstd = rsqrtf(q * (1.f / E) + LN_EPS);
    const long tok = ((long)g * FP + fp) * tp_n + tp0 + tp;
    float* o = out + ((long)b * fr * FP * tp_n + tok) * E;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = j * 32 + cg * 4 + i;
        y[i] = (acc[a][j * 4 + i] - mean) * rstd * __ldg(ln_w + e) + __ldg(ln_b + e);
      }
      store4(o + j * 32 + cg * 4, y[0], y[1], y[2], y[3]);
    }
  }
}

cudaError_t launch_f32(const float* x, const float* w, const float* bias, const float* ln_w,
                       const float* ln_b, float* out, int B, int C, int T_in, int T_img, int fr,
                       int F, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)C * 16 * (TOK + E);
  cudaError_t e = cudaFuncSetAttribute(patch_embed_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int blocks = B * fr * (T_img / fr / 4 / (TOK / (F / 4)));
  patch_embed_f32<<<blocks, F32_THREADS, smem, stream>>>(x, w, bias, ln_w, ln_b, out, C, T_in,
                                                         T_img, fr, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, C, T_in, F) and w (C * 16, 96) in the compute dtype (bf16 if
// is_bf16, else float32), w[(c 4 + kw) 4 + kh][e] the conv kernel; bias,
// ln_w, ln_b (96,) f32; out (B, fr F / 4 T_img / fr / 4, 96) in the
// compute dtype. F = 64, 128 or 256; T_in <= T_img; T_img / fr a multiple
// of a tile's frames (2048 / F); bf16: C = 7, x and out 16-byte aligned.
extern "C" int patch_embed_tokens(const void* x, const void* w, const float* bias,
                                  const float* ln_w, const float* ln_b, void* out, int B, int C,
                                  int T_in, int T_img, int fr, int F, int is_bf16,
                                  cudaStream_t stream) {
  if (B < 1 || fr < 1 || T_img % fr || (F != 64 && F != 128 && F != 256) ||
      (T_img / fr) % (2048 / F) || T_in < 1 || T_in > T_img || C < 1 || (is_bf16 && C != NC))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    const bf16 *xb = static_cast<const bf16*>(x), *wb = static_cast<const bf16*>(w);
    bf16* ob = static_cast<bf16*>(out);
    const cudaError_t e =
        F == 64    ? launch_wgmma<1>(xb, wb, bias, ln_w, ln_b, ob, B, C, T_in, T_img, fr, stream)
        : F == 128 ? launch_wgmma<2>(xb, wb, bias, ln_w, ln_b, ob, B, C, T_in, T_img, fr, stream)
                   : launch_wgmma<4>(xb, wb, bias, ln_w, ln_b, ob, B, C, T_in, T_img, fr, stream);
    return static_cast<int>(e);
  }
  return static_cast<int>(launch_f32(static_cast<const float*>(x), static_cast<const float*>(w),
                                     bias, ln_w, ln_b, static_cast<float*>(out), B, C, T_in,
                                     T_img, fr, F, stream));
}
