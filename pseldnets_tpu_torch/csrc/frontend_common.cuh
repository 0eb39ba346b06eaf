// Device code shared by kernels K9 (frontend_flat.cu) and K10
// (frontend_dif.cu): the two DFT-as-GEMM forms of the log-mel + FOA
// intensity-vector frontend. Both compute, for a block of FR frames of one
// clip and its four channels, the spectrum in column tiles of COLS real
// columns with float32 FMA (the 8e-4 dB / 7e-5 IV budget rules out TF32 and
// bf16 products), turn each tile's bins into the seven per-bin values
// (four powers, the normalized intensity vector) in shared memory, and
// scatter them into the block's mel sums: every bin feeds at most two
// bands, so each (frame, value) row adds each bin twice, in bin order, and
// no atomics are needed. The block ends with dB, the optional ScalarBN
// affine, the zero tail and one store per output.
//
// GEMM layout: rows are frame * 4 + channel (so a thread's four rows are
// the four channels of one frame and its A fragment is one float4), columns
// are (re, im) pairs of bins. Thread (frame = tid / 8, g = tid % 8) owns
// the float4 column chunks g, g + 8, g + 16 and g + 24 of the tile: for a
// fixed chunk the eight g's read 128 consecutive bytes of shared memory, so
// the B fragment loads are free of bank conflicts and the A loads are
// broadcasts. A and B stage through registers into a double buffer (the
// next k step is loaded from device memory while this one computes).
//
// Accumulation: each k step's BK products go into a partial sum that is then
// added to the running one (acc += sum of 16 FMAs), so the running sum is
// rounded once per 16 products instead of once per product. In the numpy
// emulation of both orders (scripts/torch_frontend_accumulation.py, n_fft
// 512, hop 100, 20 s of noise) this takes the rms log-mel error from
// float64 from 2.1e-6 to 8.7e-7 dB (flat) and 1.9e-6 to 1.3e-6 dB (DIF);
// the largest error, at the deepest spectral valley, stays a matter of
// chance in either order (flat 6.6e-4 / 5.9e-4 dB, DIF 5.8e-4 / 1.2e-3 dB).
// The plain versions (ops/frontend_forms.py) sum in the same two levels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace fe {

constexpr int FR = 32;           // frames per block
constexpr int ROWS = 4 * FR;     // GEMM rows: frame * 4 + channel
constexpr int COLS = 128;        // GEMM columns per tile: 64 complex values
constexpr int BK = 16;           // k step
constexpr int THREADS = 256;
constexpr int VLD = COLS / 2 + 1;  // padded row of the per-bin value tile
constexpr float EPS_F32 = 1.1920928955078125e-07f;

// sample i of the center=True padded signal: a reflect pad of `pad` samples
// on both sides, zeros beyond it (the JAX kernels' right tail)
__device__ __forceinline__ float padded_sample(const float* __restrict__ x, int N, int pad,
                                               long i) {
  if (i < 0 || i >= (long)N + 2 * pad) return 0.f;
  long j = i - pad;
  if (j < 0) j = -j;
  else if (j >= N) j = 2L * (N - 1) - j;
  return x[j];
}

// powers of the 4 channels and the normalized intensity vector of one bin:
// IV_d = Re(conj(W) P_d) / (|IV|_2 + eps), as ops/features.py computes it
__device__ __forceinline__ void bin_values(float v[7], const float re[4], const float im[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = re[c] * re[c] + im[c] * im[c];
  float iv[3];
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    iv[d] = re[d + 1] * re[0] + im[d + 1] * im[0];
    s += iv[d] * iv[d];
  }
  const float nrm = sqrtf(s) + EPS_F32;
#pragma unroll
  for (int d = 0; d < 3; ++d) v[4 + d] = iv[d] / nrm;
}

// B tile staging: 2 float4 per thread of the (BK, COLS) tile at k step n0
struct BStage {
  float4 r[2];
  __device__ __forceinline__ void load(const float4* __restrict__ tab, long tile_row0, int n0,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + THREADS * i;
      r[i] = __ldg(tab + (tile_row0 + n0 + (q >> 5)) * (COLS / 4) + (q & 31));
    }
  }
  __device__ __forceinline__ void store(float* bs, int tid) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + THREADS * i;
      reinterpret_cast<float4*>(bs + (q >> 5) * COLS)[q & 31] = r[i];
    }
  }
};

// acc[row][m] += the tile's values of local bins [j0, j1) weighted into
// their (at most two) bands; one thread per (frame, value) row, bins in
// order, so the sums are the same on every run
__device__ __forceinline__ void mel_accumulate(const float* val, float* acc, int accld,
                                               const int2* __restrict__ band_m,
                                               const float2* __restrict__ band_w, int j0,
                                               int j1) {
  const int row = threadIdx.x;
  if (row >= FR * 7) return;
  const float* vr = val + row * VLD;
  float* ar = acc + row * accld;
  for (int j = j0; j < j1; ++j) {
    const int2 m = __ldg(band_m + j);
    const float2 w = __ldg(band_w + j);
    const float v = vr[j];
    ar[m.x] += v * w.x;
    ar[m.y] += v * w.y;
  }
}

// the block's outputs: dB on the powers, the affine, zeros from n_frames on,
// frames up to t_out, float32 or bf16
__device__ __forceinline__ void store_outputs(const float* acc, int accld,
                                              const float* __restrict__ aff, void* out, int b,
                                              int f0, int n_mels, int n_frames, int t_out,
                                              int out_bf16) {
  for (int idx = threadIdx.x; idx < 7 * FR * n_mels; idx += THREADS) {
    const int m = idx % n_mels, rest = idx / n_mels;
    const int fl = rest % FR, q = rest / FR, f = f0 + fl;
    if (f >= t_out) continue;
    float s = 0.f;
    if (f < n_frames) {
      s = acc[(fl * 7 + q) * accld + m];
      if (q < 4) s = 10.f * log10f(fmaxf(s, 1e-10f));
      if (aff != nullptr) s = s * __ldg(aff + q * n_mels + m) + __ldg(aff + (7 + q) * n_mels + m);
    }
    const long o = (((long)b * 7 + q) * t_out + f) * n_mels + m;
    if (out_bf16) static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(s);
    else static_cast<float*>(out)[o] = s;
  }
}

}  // namespace fe
