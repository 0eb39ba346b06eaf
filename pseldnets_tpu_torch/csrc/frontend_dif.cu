// Kernel K10: the radix-2 decimation-in-frequency (DIF) form of the fused
// log-mel + FOA intensity-vector frontend, eval.
//
// Replaces the JAX package's ops/pallas/frontend.py::fused_logmel_iv, DIF
// variant (_call_dif -> _kernel_dif, pallas_call at :847; variant="dif",
// even n_fft and hop, hann or hamming window): (B, 4, N) float32 waveform ->
// (B, 7, n_frames, n_mels) float32, the features of ops/features.py.
//
// What bounds it: like K9, its own operations and its L2 reads. Each
// frame's two halves combine into the sum and difference streams y+-[n] =
// p[n] +- p[n + N/2] (p the reflect-padded frame; over 64 mels its halves
// windowed first); an N/2-point DFT of the
// sum stream gives the even bins, one of the pre-twiddled difference stream
// the odd bins: half the flat form's GEMM work, 0.15 TFLOP per batch of 32
// ten-second clips at n_fft 1024, three times over in split TF32 (0.92 ms at
// 495 TFLOP/s dense), with 4.8 GB of table and 4.7 GB of waveform rows read
// from L2 a call.
//
// Design (frontend_common.cuh): the streams are formed in float32 on the
// fly from the waveform, split into tf32 hi and lo and handed to wgmma from
// registers (no row tensor in device memory, unlike _call_dif's stack at
// :806-808); the JAX kernel's hop/2 row split answers Mosaic's aligned loads
// and does not constrain this one. The window cannot be folded into the
// tables (the butterfly adds samples that take different window values).
// At n_mels <= 64 (the narrow form) it is applied exactly in frequency, as
// the JAX kernel does: a periodic cosine window is the 3-tap X_w[k] = a0
// X[k] + a1 (X[k-1] + X[k+1]), (0.5, -0.25) for hann and (0.54, -0.23) for
// hamming, with X[-1] = conj(X[1]) and X[N/2+1] = conj(X[N/2-1]). Over 64
// mels (the WIDE form) each frame's two halves are multiplied by their
// halves of the window as the streams are formed, y+-[n] = w[n] p[n] +-
// w[n + N/2] p[n + N/2]: in float32 the 3-tap cancels the unwindowed
// leakage of a frame that ends in a sharp onset, whose rounding puts a
// one-bin band (there are many over 64 mels) up to 2e-3 dB from the
// float64 DFT; the windowed samples keep the flat form's error. A column
// tile holds 32 even bins (sum stream, the first 64 columns, one m64n64k8
// chain) and 32 odd bins (difference stream, the last 64, another): the
// spectrum over 64 consecutive bins 2s-1 .. 2s+62, from which the narrow
// form's 3-tap gives the 62 windowed bins 2s .. 2s+61 in registers (the
// WIDE form takes the same 62); the next tile starts 62 bins on (s += 31).
// The epilogue is K9's.

#include "frontend_common.cuh"

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, 4, N) f32; tab (n_tiles, 2, 128, Kp) f32: per tile t (s = s0 + 31 t)
// the hi and lo parts, rows the columns: row 8 j + 2 u + c (c = 0 cos, 1 -sin)
// of bin 2s + 2 i, i = 8 u + j, over the n < N/2 samples of the sum stream,
// row 64 + 8 j + 2 u + c of bin 2s - 1 + 2 i for the difference stream,
// zero where the bin lies outside 0 .. N/2 and for k from N/2 to Kp; fb (n_groups, 2, 64, 64)
// f32: the hi and lo mel tables of each group of 64 mels over local bin l
// of its tile (bin 2s - 1 + l, l = 1 .. 62; 0 and 63 feed none), k in the
// kernel's order; plan (n_tiles + 1, 2) i32: a tile's first mel and first
// group; (a0, a1) the window's 3-tap (n_mels <= 64); win (2, Kp) f32: w[n]
// and w[n + N/2] for n < N/2, zero to Kp (n_mels > 64); acc (B, blocks,
// 32, 7, n_mels) f32 scratch where n_mels > 64, else null; out (B, 7,
// n_frames, n_mels) f32.
extern "C" int logmel_iv_dif(const float* x, const float* tab, const float* fb, const int* plan,
                             const float* win, float* acc, float* out, int B, int N, int n_fft,
                             int hop, int Kp, int n_tiles, int n_groups, int s0, int n_mels,
                             int n_frames, float a0, float a1, cudaStream_t stream) {
  if (n_fft % 2 || Kp < n_fft / 2 || (n_mels > fe::MELS && win == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  fe::FormArgs a = {};
  a.x = x;
  a.aff = nullptr;
  a.out = out;
  a.plan = plan;
  a.acc = acc;
  a.N = N;
  a.n_fft = n_fft;
  a.hop = hop;
  a.n_tiles = n_tiles;
  a.kblocks = Kp / fe::BK;
  a.vec = hop % 4 == 0 && (n_fft / 2) % 4 == 0 && N % 4 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.n_mels = n_mels;
  a.n_frames = n_frames;
  a.t_out = n_frames;
  a.out_bf16 = 0;
  a.s0 = s0;
  a.a0 = a0;
  a.a1 = a1;
  a.win = win;
  return fe::launch_forms<true>(tab, fb, a, B, Kp, n_groups, stream);
}
