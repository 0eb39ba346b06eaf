// Kernel K1: fused log-mel + FOA intensity-vector frontend, eval.
//
// Replaces the JAX package's ops/pallas/frontend.py::fused_logmel_iv, radix-2
// DIT path (_call_radix2 -> _kernel_r2). (B, 4, N) float32 waveform ->
// (B, 7, t_out, n_mels): channels 0-3 are 10*log10(max(mel(|X_c|^2), 1e-10)),
// channels 4-6 mel(IV / (|IV|_2 + eps_f32)) with IV_d = Re(conj(W) P_d) per
// (frame, bin); frames of a center=True reflect-padded signal, n_frames =
// 1 + N / hop. Folds: the per-(channel, mel) affine (eval ScalarBN), frames >=
// n_frames set to 0 after it, and a bf16 or float32 store.
//
// What bounds it on the H100: the float32 pipe, by the function's count.
// It needs a real FFT of n_fft per (frame, channel) (2.5 n log2 n = 26
// kFLOP), then power, the IV and the mel projection on the non-zero
// filterbank weights: about 4.3 GFLOP and 152 MB per batch of 32 ten-second
// clips, 0.064 ms of float32 FMA against 0.046 ms of memory. The accuracy
// budget (8e-4 dB log-mel, 7e-5 IV against float32) rules out TF32 and bf16
// products, and a float32 FFT is the more accurate route than a direct DFT
// (its rounding grows with log2 n). What holds this kernel instead
// (scripts/torch_k1_probes.py, PERF.md): the SM's shared-memory and L1
// datapath and latency at 12 warps an SM; a frame moves about 60 KB through
// shared memory (two transposes, the stash, the value rows the gathers read)
// against about 5k float32 instructions a lane.
//
// Design: one warp per frame, WARPS frames per block (the host's TILES). The
// block first stages its real frames' span of the waveform in shared memory
// with 16-byte cp.async copies, one group per signal (signal 1's lands while
// signal 0 computes), so each sample leaves L2 once per block rather than
// once per frame (frames of 1024 overlap by 784); the edge blocks stage by
// index arithmetic (reflect pad, zero tail). The four channels go as two
// complex signals (W + iX, Y + iZ) through one 1024-point FFT each,
// four-step as 32 x 32: each lane reads its 32 samples of a column from the
// span and windows them, runs a 32-point radix-2 DIF FFT in registers (the
// -i twiddles as swaps), multiplies by W_1024^(k1 n2) (products of 10 table
// rows a lane), transposes through shared memory (rows padded to 33) and
// runs the second 32-point FFT, so lane L ends with bins L + 32 j. The
// packed spectra are unpacked in registers: bin n_fft - k of lane L lies in
// lane (32 - L) % 32, one shuffle per bin. The first signal's W, X go to a
// per-lane stash; the second's Y, Z meet them there and give the seven
// per-bin values (powers to one region, the IV held in registers until the
// stash is read, then written over it). The mel projection is a gather in
// fixed band groups: lane (m', q) of group g sums band 4 g + m' of value row
// q over the group's common bin window against the filterbank's own column
// (zeros outside the band), in two interleaved sums added at the end; a
// fixed order, so two launches give equal bits. Its tables are copied into
// shared memory once per block, and each band's window starts at a bin =
// m' mod 4, so the 28 lanes read 28 banks. The sums go to a per-warp staging
// row, copied out as contiguous rows of n_mels with dB and the affine.
// The phases are marked "K1 phase: ..." for scripts/torch_k1_probes.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int R = 32;          // n_fft = R * R, four-step
constexpr int NFFT = R * R;
constexpr int HALF = NFFT / 2;
constexpr int NJ = R / 2;      // bins L + 32 j, j < NJ, below n_fft / 2
constexpr int LDS = R + 1;     // padded row of the transpose
constexpr int VLD = HALF + 4;  // row of the per-bin values, bins 0 .. n_fft / 2
constexpr int GROUP = 4;       // mel bands per gather group (7 rows x 4 = 28 lanes)
constexpr int MAX_WARPS = 4;  // 3 blocks of 4 an SM: shared memory and 168 registers
// shared memory: the block's mel tables (weights, starts, group info), then
// the A regions of its warps, then their B regions, each region R x LDS
// float2. First the block's waveform span for signal 0 (channels 0, 1) fills
// the A regions and the span for signal 1 (channels 2, 3) the B regions.
// Then per warp A holds signal 0's transpose, then the stash of W, X (16 x
// 32 float4 and bin n_fft / 2), then value rows 4-6 from float 16 on (their
// banks clear of rows 0-3) and the staged outputs after them; B holds
// signal 1's transpose, then value rows 0-3.
constexpr int REGION = R * LDS * 8;
constexpr int STASH = (NJ * R + 1) * 16;
constexpr int ROW4 = 16;
constexpr int OUT0 = ROW4 + 3 * VLD;  // staged outputs (7, n_mels), floats into A
constexpr float EPS_F32 = 1.1920928955078125e-07f;
static_assert(4 * VLD * 4 <= REGION && STASH <= REGION, "value rows and stash");
// a block's span of two channels, hop < n_fft, fits its warps' regions (so
// it does for fewer warps: 8 ((w - 1) (n_fft - 1) + n_fft) <= w REGION)
static_assert(2 * ((MAX_WARPS - 1) * (NFFT - 1) + NFFT) * 4 <= MAX_WARPS * REGION, "span");

// W_32^j = exp(-2 pi i j / 32), j < 16
__constant__ float2 W32[R / 2] = {
    {1.000000000e+00f, 0.000000000e+00f},  {9.807852804e-01f, -1.950903220e-01f},
    {9.238795325e-01f, -3.826834324e-01f}, {8.314696123e-01f, -5.555702330e-01f},
    {7.071067812e-01f, -7.071067812e-01f}, {5.555702330e-01f, -8.314696123e-01f},
    {3.826834324e-01f, -9.238795325e-01f}, {1.950903220e-01f, -9.807852804e-01f},
    {0.000000000e+00f, -1.000000000e+00f}, {-1.950903220e-01f, -9.807852804e-01f},
    {-3.826834324e-01f, -9.238795325e-01f}, {-5.555702330e-01f, -8.314696123e-01f},
    {-7.071067812e-01f, -7.071067812e-01f}, {-8.314696123e-01f, -5.555702330e-01f},
    {-9.238795325e-01f, -3.826834324e-01f}, {-9.807852804e-01f, -1.950903220e-01f}};

__host__ __device__ constexpr int rev5(int r) {
  return ((r & 1) << 4) | ((r & 2) << 2) | (r & 4) | ((r & 8) >> 2) | ((r & 16) >> 4);
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ constexpr size_t region_bytes(int n_mels) {
  return align16((size_t)OUT0 * 4 + (size_t)7 * n_mels * 4 > REGION
                     ? (size_t)OUT0 * 4 + (size_t)7 * n_mels * 4 : REGION);
}

// the mel tables' bytes: n_w weights, 4 starts and one (offset, width) pair
// per group
__host__ __device__ constexpr size_t table_bytes(int n_w, int n_groups) {
  return align16((size_t)n_w * 4) + align16((size_t)n_groups * (GROUP + 2) * 4);
}

__host__ __device__ constexpr size_t block_bytes(int warps, int n_mels, int n_w, int n_groups) {
  return table_bytes(n_w, n_groups) + 2 * (size_t)warps * region_bytes(n_mels);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// one radix-2 DIF stage of span 2 * half; a template so that every index is
// a constant and a[] stays in registers. W_32^8 = -i is a swap.
template <int S>
__device__ __forceinline__ void dif_stage(float2 (&a)[R]) {
  constexpr int half = (R / 2) >> S;
#pragma unroll
  for (int g = 0; g < R; g += 2 * half) {
#pragma unroll
    for (int p = 0; p < half; ++p) {
      const float2 u = a[g + p], v = a[g + p + half];
      a[g + p] = make_float2(u.x + v.x, u.y + v.y);
      const float2 d = make_float2(u.x - v.x, u.y - v.y);
      const int e = p << S;
      a[g + p + half] = e == 0 ? d : e == 8 ? make_float2(d.y, -d.x) : cmul(d, W32[e]);
    }
  }
}

// 32-point radix-2 DIF FFT in registers: natural order in, a[r] = X[rev5(r)] out
__device__ __forceinline__ void fft32(float2 (&a)[R]) {
  dif_stage<0>(a);
  dif_stage<1>(a);
  dif_stage<2>(a);
  dif_stage<3>(a);
  dif_stage<4>(a);
}

// sample i of the center=True padded signal: a reflect pad of n_fft / 2,
// zeros past N + n_fft
__device__ __forceinline__ float padded_sample(const float* __restrict__ x, int N, long i) {
  if (i >= (long)N + NFFT) return 0.f;
  long j = i - HALF;
  if (j < 0) j = -j;
  else if (j >= N) j = 2L * (N - 1) - j;
  return __ldg(x + j);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// the two channel spectra of a packed signal at bin k, from A = Z[k] and
// B = Z[n_fft - k]: (A + conj B) / 2 and -i (A - conj B) / 2
__device__ __forceinline__ float4 unpack(float2 A, float2 B) {
  return make_float4(0.5f * (A.x + B.x), 0.5f * (A.y - B.y), 0.5f * (A.y + B.y),
                     0.5f * (B.x - A.x));
}

__global__ void __launch_bounds__(MAX_WARPS * 32, 3) logmel_iv_kernel(
    const float* __restrict__ x, const float* __restrict__ win,
    const float2* __restrict__ tw, const float* __restrict__ gwts,
    const int* __restrict__ gstart, const int2* __restrict__ ginfo,
    const float* __restrict__ aff, void* out, int N, int hop, int n_mels, int n_frames,
    int t_out, int out_bf16, int n_w, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y, warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * warps, frame = f0 + warp;
  // the mel tables, copied once per block: the gathers read them every step
  float* w_s = reinterpret_cast<float*>(smem);
  int* start_s = reinterpret_cast<int*>(smem + align16((size_t)n_w * 4));
  int2* info_s = reinterpret_cast<int2*>(start_s + n_groups * GROUP);
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) w_s[i] = __ldg(gwts + i);
  for (int i = threadIdx.x; i < n_groups * GROUP; i += blockDim.x) start_s[i] = __ldg(gstart + i);
  for (int i = threadIdx.x; i < n_groups; i += blockDim.x) info_s[i] = __ldg(ginfo + i);
  const size_t rb = region_bytes(n_mels);
  unsigned char* a_space = smem + table_bytes(n_w, n_groups);
  unsigned char* b_space = a_space + warps * rb;
  float2* TA = reinterpret_cast<float2*>(a_space + warp * rb);
  float2* TB = reinterpret_cast<float2*>(b_space + warp * rb);
  float4* stash = reinterpret_cast<float4*>(TA);
  float* v_lo = reinterpret_cast<float*>(TB);                         // value rows 0-3
  float* v_hi = reinterpret_cast<float*>(TA) + ROW4 - 4 * VLD;        // rows 4-6
  float* o_s = reinterpret_cast<float*>(TA) + OUT0;                   // (7, n_mels)

  // the block's span of the padded signal, per channel: sample f0 * hop + i,
  // i < span, of its real frames; signal st's two channels into the A (st 0)
  // or B (st 1) regions. Inside the waveform as 16-byte copies where the
  // rows allow, at the edges by index arithmetic (reflect pad, zero tail)
  const int nf = min(warps, n_frames - f0);  // the block's real frames
  const int span = nf > 0 ? (nf - 1) * hop + NFFT : 0;
  const long j0 = (long)f0 * hop - HALF;
  const float* xb = x + (long)b * 4 * N;
  if (nf > 0) {
    const bool inside = j0 >= 0 && j0 + span <= N;
    for (int c = 0; c < 4; ++c) {
      float* dst = reinterpret_cast<float*>(c < 2 ? a_space : b_space) + (c & 1) * span;
      const float* src = xb + (long)c * N;
      if (inside && (span & 3) == 0 && (reinterpret_cast<size_t>(src + j0) & 15) == 0) {
        for (int i = 4 * threadIdx.x; i < span; i += 4 * blockDim.x) cp_async16(dst + i, src + j0 + i);
      } else {
        for (int i = threadIdx.x; i < span; i += blockDim.x)
          dst[i] = padded_sample(src, N, (long)f0 * hop + i);
      }
      if (c & 1) asm volatile("cp.async.commit_group;" ::: "memory");  // one group a signal
    }
    // signal 0's span is needed now; signal 1's arrives while signal 0 computes
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  }
  __syncthreads();

  const bool active = frame < n_frames;
  float iv[NJ + 1][3];  // normalized IV of bins lane + 32 j (j = NJ: lane 0, n_fft / 2)
  // K1 phase: load
#pragma unroll 1
  for (int st = 0; st < 2; ++st) {
    if (st == 1) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();  // signal 1's span has landed
    }
    float2 a[R];  // windowed samples n = 32 n1 + lane at a[n1]
    if (active) {
      const float* sr = reinterpret_cast<const float*>(st == 0 ? a_space : b_space) +
                        (frame - f0) * hop;
      const float* si = sr + span;
#pragma unroll
      for (int n1 = 0; n1 < R; ++n1) {
        const int n = n1 * R + lane;
        const float w = __ldg(win + n);
        a[n1] = make_float2(w * sr[n], w * si[n]);
      }
    }
    __syncthreads();  // the span is read: its regions take the transposes
    if (!active) continue;
    float2* T = st == 0 ? TA : TB;
    // K1 phase: fft1
    fft32(a);  // a[r] = Y[k1 = rev5(r)] of column n2 = lane
    // K1 phase: fft2
    // W^(k1 lane) for k1 = 8 h + l: rows l and 8 h of the table, their
    // product where both are non-zero (10 loads a lane, not 31)
    float2 tl[8], th[4];
#pragma unroll
    for (int l = 1; l < 8; ++l) tl[l] = __ldg(tw + l * R + lane);
#pragma unroll
    for (int h = 1; h < 4; ++h) th[h] = __ldg(tw + 8 * h * R + lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k1 = rev5(r), l = k1 & 7, h = k1 >> 3;
      T[k1 * LDS + lane] = k1 == 0 ? a[r]
                           : cmul(a[r], h == 0 ? tl[l] : l == 0 ? th[h] : cmul(th[h], tl[l]));
    }
    __syncwarp();
#pragma unroll
    for (int n2 = 0; n2 < R; ++n2) a[n2] = T[lane * LDS + n2];  // row k1 = lane
    __syncwarp();
    fft32(a);  // a[r] = Z[lane + 32 rev5(r)]
    // K1 phase: unpack
    // bin k = lane + 32 j pairs with n_fft - k = p + 32 j', p = (32 - lane) % 32:
    // j' = 31 - j, or (32 - j) % 32 on lane 0 (whose partner is itself)
    const int partner = (R - lane) & (R - 1);
#pragma unroll
    for (int j = 0; j <= NJ; ++j) {
      float4 c;  // (re, im) of the packed signal's two channels at bin lane + 32 j
      if (j < NJ) {
        const float2 send = lane == 0 ? a[rev5((R - j) & (R - 1))] : a[rev5(R - 1 - j)];
        const float2 B = make_float2(__shfl_sync(0xffffffffu, send.x, partner),
                                     __shfl_sync(0xffffffffu, send.y, partner));
        c = unpack(a[rev5(j)], B);
      } else {
        if (lane != 0) break;
        c = unpack(a[rev5(NJ)], a[rev5(NJ)]);  // bin n_fft / 2: real
      }
      if (st == 0) {
        stash[j * R + lane] = c;  // W, X
        continue;
      }
      const float4 wx = stash[j * R + lane];
      const float re[4] = {wx.x, wx.z, c.x, c.z}, im[4] = {wx.y, wx.w, c.y, c.w};
      float s = 0.f, d[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        d[e] = re[e + 1] * re[0] + im[e + 1] * im[0];
        s += d[e] * d[e];
      }
      const float rn = 1.f / (sqrtf(s) + EPS_F32);
      const int k = lane + R * j;
#pragma unroll
      for (int q = 0; q < 4; ++q) v_lo[q * VLD + k] = re[q] * re[q] + im[q] * im[q];
#pragma unroll
      for (int e = 0; e < 3; ++e) iv[j][e] = d[e] * rn;
    }
  }
  if (active) {
    // K1 phase: values
    __syncwarp();  // every lane has read its stash: rows 4-6 go over it
#pragma unroll
    for (int j = 0; j <= NJ; ++j) {
      if (j == NJ && lane != 0) break;
#pragma unroll
      for (int e = 0; e < 3; ++e) v_hi[(4 + e) * VLD + lane + R * j] = iv[j][e];
    }
    __syncwarp();

    // K1 phase: mel
    const int q = lane & 7, mp = lane >> 3;  // row q (7: idle), band 4 g + mp
    const float* vrow = q < 4 ? v_lo + q * VLD : v_hi + min(q, 6) * VLD;
    for (int g = 0; g < n_groups; ++g) {
      const int2 info = info_s[g];  // offset of the group's weights, window width
      const float* vv = vrow + start_s[g * GROUP + mp];
      const float2* wv = reinterpret_cast<const float2*>(w_s + info.x + mp * info.y);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
      for (int i = 0; i < info.y; i += 2) {  // widths and offsets are even
        const float2 w = wv[i >> 1];
        s0 = fmaf(vv[i], w.x, s0);
        s1 = fmaf(vv[i + 1], w.y, s1);
      }
      float s = s0 + s1;
      const int m = g * GROUP + mp;
      if (q < 7 && m < n_mels) o_s[q * n_mels + m] = s;
    }
    __syncwarp();
  }
  if (frame >= t_out) return;

  // K1 phase: store
  // row q of the frame: n_mels contiguous outputs, dB (rows 0-3: every lane
  // busy, the row known at compile time) and the affine applied here (its
  // loads all issued at once, not one wait per mel group), a pair per lane
  // where n_mels is even; zeros from n_frames on
  const bool zero = frame >= n_frames;
  const bool pairs = (n_mels & 1) == 0;
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    const long row = ((long)(b * 7 + q) * t_out + frame) * n_mels;
    const float* src = o_s + q * n_mels;
    const float* inv = aff + q * n_mels;
    const float* sh = aff + (7 + q) * n_mels;
    for (int m = pairs ? 2 * lane : lane; m < n_mels; m += pairs ? 64 : 32) {
      float lo = 0.f, hi = 0.f;
      if (!zero) {
        lo = src[m];
        if (pairs) hi = src[m + 1];
        if (q < 4) {
          lo = 10.f * log10f(fmaxf(lo, 1e-10f));
          hi = 10.f * log10f(fmaxf(hi, 1e-10f));
        }
        if (aff != nullptr) {
          lo = lo * __ldg(inv + m) + __ldg(sh + m);
          if (pairs) hi = hi * __ldg(inv + m + 1) + __ldg(sh + m + 1);
        }
      }
      if (pairs && out_bf16) {
        reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + row)[m >> 1] =
            __floats2bfloat162_rn(lo, hi);
      } else if (pairs) {
        reinterpret_cast<float2*>(static_cast<float*>(out) + row)[m >> 1] = make_float2(lo, hi);
      } else if (out_bf16) {
        static_cast<__nv_bfloat16*>(out)[row + m] = __float2bfloat16_rn(lo);
      } else {
        static_cast<float*>(out)[row + m] = lo;
      }
    }
  }
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, 4, N) f32; win (n_fft,) f32 analysis window; tw (n_fft, 2) f32
// twiddles W_n_fft^(k1 n2) at row 32 k1 + n2; the mel gather groups
// (ops/frontend.py::mel_groups): gwts (n_w,) f32 each group's (4, width)
// filterbank columns over its window, gstart (n_groups * 4,) i32 each band's
// first bin, ginfo (n_groups, 2) i32 the offset of the group's weights and
// its width, both even; aff (2, 7, n_mels) f32 or null; out (B, 7, t_out,
// n_mels) f32 or bf16. n_fft must be 1024; warps (frames per block) 1 .. 4.
extern "C" int logmel_iv_frontend(const float* x, const float* win, const float* tw,
                                  const float* gwts, const int* gstart, const int* ginfo,
                                  const float* aff, void* out, int B, int N, int n_fft,
                                  int hop, int n_mels, int n_frames, int t_out,
                                  int out_bf16, int n_w, int n_groups, int warps,
                                  cudaStream_t stream) {
  if (n_fft != NFFT || N <= HALF || hop <= 0 || hop >= NFFT || warps < 1 || warps > MAX_WARPS ||
      n_groups * GROUP < n_mels || t_out < n_frames || n_w % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = block_bytes(warps, n_mels, n_w, n_groups);
  cudaError_t e = cudaFuncSetAttribute(logmel_iv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((t_out + warps - 1) / warps, B);
  logmel_iv_kernel<<<grid, warps * 32, smem, stream>>>(
      x, win, reinterpret_cast<const float2*>(tw), gwts, gstart,
      reinterpret_cast<const int2*>(ginfo), aff, out, N, hop, n_mels, n_frames, t_out,
      out_bf16, n_w, n_groups);
  return static_cast<int>(cudaGetLastError());
}
