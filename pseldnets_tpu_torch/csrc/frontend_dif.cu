// Kernel K10: the radix-2 decimation-in-frequency (DIF) form of the fused
// log-mel + FOA intensity-vector frontend, eval.
//
// Replaces the JAX package's ops/pallas/frontend.py::fused_logmel_iv, DIF
// variant (_call_dif -> _kernel_dif, pallas_call at :847; variant="dif",
// even n_fft and hop, hann or hamming window): (B, 4, N) float32 waveform ->
// (B, 7, n_frames, n_mels) float32, the features of ops/features.py.
//
// What bounds it: like K9, its own operations. Each frame's two halves
// combine into the sum and difference streams y+-[n] = p[n] +- p[n + N/2]
// (p the reflect-padded frame); an N/2-point DFT of the sum stream gives the
// even bins, one of the pre-twiddled difference stream the odd bins: half
// the flat form's GEMM work, 0.15 TFLOP per batch of 32 ten-second clips at
// n_fft 1024, on float32 FMA (TF32 products miss the 8e-4 dB budget).
//
// Design: the streams are formed on the fly from the waveform while the A
// tiles are staged (no row tensor in device memory, unlike _call_dif's
// stack at :806-808); the JAX kernel's hop/2 row split answers Mosaic's
// aligned loads and does not constrain this one. The window cannot be
// folded into the tables (the butterfly needs the unwindowed samples), so
// it is applied exactly in frequency: a periodic cosine window is the
// 3-tap X_w[k] = a0 X[k] + a1 (X[k-1] + X[k+1]), (0.5, -0.25) for hann and
// (0.54, -0.23) for hamming, with X[-1] = conj(X[1]) and X[N/2+1] =
// conj(X[N/2-1]). A column tile holds 32 even bins (sum stream, the first
// 64 columns) and 32 odd bins (difference stream, the last 64): the
// unwindowed spectrum over 64 consecutive bins 2s-1 .. 2s+62, from which
// the 3-tap gives the 62 windowed bins 2s .. 2s+61; the next tile starts 62
// bins on (s += 31). The unwindowed tile goes through shared memory for
// the 3-tap, then the epilogue is K9's (frontend_common.cuh).

#include "frontend_common.cuh"

namespace {

using namespace fe;

constexpr int TB = COLS / 2;  // complex values per tile: bins 2s-1 .. 2s+62
constexpr int WB = TB - 2;    // windowed bins per tile

__global__ void __launch_bounds__(THREADS, 1) logmel_iv_dif_kernel(
    const float* __restrict__ x, const float4* __restrict__ tab,
    const int2* __restrict__ band_m, const float2* __restrict__ band_w, void* out, int N,
    int n_fft, int hop, int Kp, int n_tiles, int s0, int n_mels, int n_frames, float a0,
    float a1) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // [2][2 streams][BK][ROWS]
  float* bs = as + 4 * BK * ROWS;               // [2][BK][COLS]
  float* spec = bs + 2 * BK * COLS;             // [FR * 4][TB] float2; later [FR * 7][VLD]
  float* acc = spec + FR * 4 * TB * 2;          // [FR * 7][n_mels + 1]
  float2* sp = reinterpret_cast<float2*>(spec);
  float* val = spec;
  const int tid = threadIdx.x, b = blockIdx.y, f0 = blockIdx.x * FR;
  const int accld = n_mels + 1, hf = n_fft / 2;
  for (int i = tid; i < FR * 7 * accld; i += THREADS) acc[i] = 0.f;

  if (f0 < n_frames) {
    // A staging: row tid % 128 (frame, channel), 8 consecutive n < N/2
    // from (tid / 128) * 8, both streams from the same two samples
    const int arow = tid & (ROWS - 1), akh = (tid >> 7) * 8;
    const int af = f0 + (arow >> 2);
    const bool avalid = af < n_frames;
    const float* xc = x + ((long)b * 4 + (arow & 3)) * N;
    float ru[8], rv[8];
    auto load_a = [&](int n0) {
      const int n = n0 + akh;
      const long i0 = (long)af * hop + n;
      if (avalid && i0 - hf >= 0 && i0 + 8 <= N && n + 8 <= hf) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float lo = xc[i0 - hf + e], hi = xc[i0 + e];
          ru[e] = lo + hi;
          rv[e] = lo - hi;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool in = avalid && n + e < hf;
          const float lo = in ? padded_sample(xc, N, hf, i0 + e) : 0.f;
          const float hi = in ? padded_sample(xc, N, hf, i0 + e + hf) : 0.f;
          ru[e] = lo + hi;
          rv[e] = lo - hi;
        }
      }
    };
    auto store_a = [&](float* a) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a[(akh + e) * ROWS + arow] = ru[e];
        a[(BK + akh + e) * ROWS + arow] = rv[e];
      }
    };
    BStage rb;

    const int g = tid & 7, fr = tid >> 3;
    const int ksteps = Kp / BK, nsteps = n_tiles * ksteps;
    float c[4][16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) c[r][j] = 0.f;

    load_a(0);
    rb.load(tab, 0, 0, tid);
    store_a(as);
    rb.store(bs, tid);
    __syncthreads();
    for (int s = 0; s < nsteps; ++s) {
      const int buf = s & 1;
      const bool more = s + 1 < nsteps;
      if (more) {
        const int t1 = (s + 1) / ksteps, n1 = ((s + 1) % ksteps) * BK;
        load_a(n1);
        rb.load(tab, (long)t1 * Kp, n1, tid);
      }
      const float* a = as + buf * 2 * BK * ROWS;
      const float* bb = bs + buf * BK * COLS;
      float p[4][16];  // this k step's partial sums (see frontend_common.cuh)
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 uv = reinterpret_cast<const float4*>(a + kk * ROWS)[fr];
        const float4 dv = reinterpret_cast<const float4*>(a + (BK + kk) * ROWS)[fr];
        const float au[4] = {uv.x, uv.y, uv.z, uv.w};
        const float ad[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) {
          // chunks g, g + 8: sum-stream columns; g + 16, g + 24: difference
          const float4 bv = reinterpret_cast<const float4*>(bb + kk * COLS)[g + 8 * ci];
          const float bl[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float ar = ci < 2 ? au[r] : ad[r];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[r][ci * 4 + e] = kk == 0 ? ar * bl[e] : fmaf(ar, bl[e], p[r][ci * 4 + e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 16; ++j) c[r][j] += p[r][j];
      if (more) {
        store_a(as + (buf ^ 1) * 2 * BK * ROWS);
        rb.store(bs + (buf ^ 1) * BK * COLS, tid);
      }
      __syncthreads();
      if ((s + 1) % ksteps == 0) {  // the tile's unwindowed spectrum is complete
        const int t = s / ksteps;
        const int base = 2 * (s0 + 31 * t) - 1;  // bin of local index 0
        // sum-stream column i is bin 2s + 2i (local 2i + 1); difference-
        // stream column i is bin 2s - 1 + 2i (local 2i)
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * (g + 8 * (ci & 1)) + h;
            const int l = ci < 2 ? 2 * i + 1 : 2 * i;
#pragma unroll
            for (int r = 0; r < 4; ++r)
              sp[(fr * 4 + r) * TB + l] = make_float2(c[r][ci * 4 + 2 * h],
                                                      c[r][ci * 4 + 2 * h + 1]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 16; ++j) c[r][j] = 0.f;
        __syncthreads();
        // the 3-tap window and the per-bin values of local bins 1 .. WB
        constexpr int ITEMS = (FR * WB + THREADS - 1) / THREADS;
        float v[ITEMS][7];
#pragma unroll
        for (int it = 0; it < ITEMS; ++it) {
          const int w = tid + THREADS * it;
          if (w >= FR * WB) continue;
          const int wf = w / WB, l = 1 + w % WB, bin = base + l;
          float re[4], im[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2* row = sp + (wf * 4 + r) * TB;
            const float2 xk = row[l];
            float2 lm = row[l - 1], rp = row[l + 1];
            if (bin == 0) lm = make_float2(rp.x, -rp.y);   // X[-1] = conj(X[1])
            if (bin == hf) rp = make_float2(lm.x, -lm.y);  // X[N/2+1] = conj(X[N/2-1])
            re[r] = a0 * xk.x + a1 * (lm.x + rp.x);
            im[r] = a0 * xk.y + a1 * (lm.y + rp.y);
          }
          bin_values(v[it], re, im);
        }
        __syncthreads();  // the values go over the spectrum
#pragma unroll
        for (int it = 0; it < ITEMS; ++it) {
          const int w = tid + THREADS * it;
          if (w >= FR * WB) continue;
          const int wf = w / WB, l = 1 + w % WB;
#pragma unroll
          for (int q = 0; q < 7; ++q) val[(wf * 7 + q) * VLD + l] = v[it][q];
        }
        __syncthreads();
        mel_accumulate(val, acc, accld, band_m + t * TB, band_w + t * TB, 1, 1 + WB);
        __syncthreads();
      }
    }
  }
  __syncthreads();
  store_outputs(acc, accld, nullptr, out, b, f0, n_mels, n_frames, n_frames, 0);
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, 4, N) f32; tab (n_tiles, Kp, 128) f32: per tile t (s = s0 + 31 t)
// columns 2i, 2i+1 the (cos, -sin) of bin 2s + 2i over n < N/2, columns
// 64 + 2i, 65 + 2i those of bin 2s - 1 + 2i (the pre-twiddled odd bins),
// zero where the bin lies outside 0 .. N/2 and on rows N/2 .. Kp; band_m
// (n_tiles, 64) int2 and band_w (n_tiles, 64) float2: the bands windowed
// local bin l (bin 2s - 1 + l, l = 1 .. 62) feeds and their weights; (a0,
// a1) the window's 3-tap; out (B, 7, n_frames, n_mels) f32.
extern "C" int logmel_iv_dif(const float* x, const float* tab, const int* band_m,
                             const float* band_w, float* out, int B, int N, int n_fft, int hop,
                             int Kp, int n_tiles, int s0, int n_mels, int n_frames, float a0,
                             float a1, cudaStream_t stream) {
  if (N <= n_fft / 2 || n_fft % 2 || hop < 1 || Kp % BK != 0 || Kp < n_fft / 2 || n_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((size_t)4 * BK * ROWS + 2 * BK * COLS +
                                       (size_t)FR * 4 * TB * 2 + (size_t)FR * 7 * (n_mels + 1));
  cudaError_t e = cudaFuncSetAttribute(logmel_iv_dif_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_frames + FR - 1) / FR, B);
  logmel_iv_dif_kernel<<<grid, THREADS, smem, stream>>>(
      x, reinterpret_cast<const float4*>(tab), reinterpret_cast<const int2*>(band_m),
      reinterpret_cast<const float2*>(band_w), out, N, n_fft, hop, Kp, n_tiles, s0, n_mels,
      n_frames, a0, a1);
  return static_cast<int>(cudaGetLastError());
}
