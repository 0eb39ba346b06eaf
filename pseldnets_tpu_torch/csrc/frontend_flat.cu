// Kernel K9: the flat (direct DFT) form of the fused log-mel + FOA
// intensity-vector frontend, eval.
//
// Replaces the JAX package's ops/pallas/frontend.py::fused_logmel_iv, flat
// path (_kernel, pallas_call at :556): (B, 4, N) float32 waveform -> (B, 7,
// t_out, n_mels), the features of ops/features.py for any n_fft and any
// hop < n_fft (center=True reflect pad of n_fft / 2, n_frames = 1 + N / hop,
// periodic window). It takes the shapes kernel K1's 32 x 32 FFT does not:
// an odd hop or n_fft, radix2=False, and the even n_fft other than 1024, for
// which it also carries K1's folds (ScalarBN affine, bf16 store, zero tail
// to t_out).
//
// What bounds it: the function needs little (an FFT's operations and the
// waveform and features once: chip_smoke.py::k1_work), but this form runs
// the DFT as a GEMM, 2 n_fft FLOPs per (frame, channel, bin): 0.27 TFLOP
// per batch of 32 ten-second clips at n_fft 1024, on float32 FMA (67
// TFLOP/s: TF32 products miss the 8e-4 dB budget), so it is bound by its
// own operations, about 60x the function's bound.
//
// Design: the Pallas kernel's hop-row decomposition (sum over j of
// rows[i + j] @ D_j) exists because Mosaic rejects unaligned hop-strided
// loads; here the A operand is read straight from the waveform, one row per
// (frame, channel) at stride hop, the reflect pad as index arithmetic. The
// B operand is the windowed (cos, -sin) table, built once per (n_fft,
// window) on the host, only for the bins from the first to the last one
// with a non-zero mel weight (the others add nothing to any output), in
// tiles of 64 bins. A block takes 32 frames of one clip and walks the
// tiles; each tile's spectrum becomes the seven per-bin values and is
// scattered into the mel sums in shared memory (frontend_common.cuh), so
// no spectrum reaches device memory.

#include "frontend_common.cuh"

namespace {

using namespace fe;

__global__ void __launch_bounds__(THREADS, 1) logmel_iv_flat_kernel(
    const float* __restrict__ x, const float4* __restrict__ tab,
    const int2* __restrict__ band_m, const float2* __restrict__ band_w,
    const float* __restrict__ aff, void* out, int N, int n_fft, int hop, int Kp, int n_tiles,
    int n_mels, int n_frames, int t_out, int out_bf16) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // [2][BK][ROWS]
  float* bs = as + 2 * BK * ROWS;               // [2][BK][COLS]
  float* val = bs + 2 * BK * COLS;              // [FR * 7][VLD]
  float* acc = val + FR * 7 * VLD;              // [FR * 7][n_mels + 1]
  const int tid = threadIdx.x, b = blockIdx.y, f0 = blockIdx.x * FR;
  const int accld = n_mels + 1, pad = n_fft / 2;
  for (int i = tid; i < FR * 7 * accld; i += THREADS) acc[i] = 0.f;

  if (f0 < n_frames) {
    // A staging: row tid % 128 (frame, channel), 8 consecutive k from (tid / 128) * 8
    const int arow = tid & (ROWS - 1), akh = (tid >> 7) * 8;
    const int af = f0 + (arow >> 2);
    const bool avalid = af < n_frames;
    const float* xc = x + ((long)b * 4 + (arow & 3)) * N;
    float ra[8];
    auto load_a = [&](int n0) {
      const int n = n0 + akh;
      const long i0 = (long)af * hop + n;
      if (avalid && i0 - pad >= 0 && i0 + 8 - pad <= N && n + 8 <= n_fft) {
#pragma unroll
        for (int e = 0; e < 8; ++e) ra[e] = xc[i0 - pad + e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ra[e] = avalid && n + e < n_fft ? padded_sample(xc, N, pad, i0 + e) : 0.f;
      }
    };
    auto store_a = [&](float* a) {
#pragma unroll
      for (int e = 0; e < 8; ++e) a[(akh + e) * ROWS + arow] = ra[e];
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
      const float* a = as + buf * BK * ROWS;
      const float* bb = bs + buf * BK * COLS;
      float p[4][16];  // this k step's partial sums (see frontend_common.cuh)
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 av = reinterpret_cast<const float4*>(a + kk * ROWS)[fr];
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) {
          const float4 bv = reinterpret_cast<const float4*>(bb + kk * COLS)[g + 8 * ci];
          const float bl[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[r][ci * 4 + e] = kk == 0 ? ar[r] * bl[e] : fmaf(ar[r], bl[e], p[r][ci * 4 + e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 16; ++j) c[r][j] += p[r][j];
      if (more) {
        store_a(as + (buf ^ 1) * BK * ROWS);
        rb.store(bs + (buf ^ 1) * BK * COLS, tid);
      }
      __syncthreads();
      if ((s + 1) % ksteps == 0) {  // the tile's spectrum is complete
        const int t = s / ksteps;
        // chunk g + 8 ci holds local bins 2 (g + 8 ci) + {0, 1}, (re, im) each
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float re[4] = {c[0][ci * 4 + 2 * h], c[1][ci * 4 + 2 * h],
                                 c[2][ci * 4 + 2 * h], c[3][ci * 4 + 2 * h]};
            const float im[4] = {c[0][ci * 4 + 2 * h + 1], c[1][ci * 4 + 2 * h + 1],
                                 c[2][ci * 4 + 2 * h + 1], c[3][ci * 4 + 2 * h + 1]};
            float v[7];
            bin_values(v, re, im);
            const int j = 2 * (g + 8 * ci) + h;
#pragma unroll
            for (int q = 0; q < 7; ++q) val[(fr * 7 + q) * VLD + j] = v[q];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 16; ++j) c[r][j] = 0.f;
        __syncthreads();
        mel_accumulate(val, acc, accld, band_m + t * (COLS / 2), band_w + t * (COLS / 2), 0,
                       COLS / 2);
        __syncthreads();
      }
    }
  }
  __syncthreads();
  store_outputs(acc, accld, aff, out, b, f0, n_mels, n_frames, t_out, out_bf16);
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, 4, N) f32; tab (n_tiles, Kp, 128) f32: per tile of 64 bins the
// windowed cos (even columns) and -sin (odd columns) over n < n_fft, zero
// rows from n_fft to Kp (a multiple of 16); band_m (n_tiles, 64) int2 and
// band_w (n_tiles, 64) float2: the two bands each bin feeds and their
// weights (weight 0 where it feeds fewer); aff (2, 7, n_mels) f32 or null;
// out (B, 7, t_out, n_mels) f32 or bf16.
extern "C" int logmel_iv_flat(const float* x, const float* tab, const int* band_m,
                              const float* band_w, const float* aff, void* out, int B, int N,
                              int n_fft, int hop, int Kp, int n_tiles, int n_mels, int n_frames,
                              int t_out, int out_bf16, cudaStream_t stream) {
  if (N <= n_fft / 2 || hop < 1 || Kp % BK != 0 || Kp < n_fft || n_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((size_t)2 * BK * ROWS + 2 * BK * COLS + FR * 7 * VLD +
                                       (size_t)FR * 7 * (n_mels + 1));
  cudaError_t e = cudaFuncSetAttribute(logmel_iv_flat_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((t_out + FR - 1) / FR, B);
  logmel_iv_flat_kernel<<<grid, THREADS, smem, stream>>>(
      x, reinterpret_cast<const float4*>(tab), reinterpret_cast<const int2*>(band_m),
      reinterpret_cast<const float2*>(band_w), aff, out, N, n_fft, hop, Kp, n_tiles, n_mels,
      n_frames, t_out, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
