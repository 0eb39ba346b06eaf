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
// per batch of 32 ten-second clips at n_fft 1024, three times over in split
// TF32 (0.81 TFLOP at 495 TFLOP/s dense: 1.63 ms), and it reads each column
// tile's hi and lo tables once per block of 32 frames from L2 (8.4 GB a
// call) besides the waveform rows once per tile (4.2 GB): the tensor cores
// and L2 bound it together.
//
// Design (frontend_common.cuh): the Pallas kernel's hop-row decomposition
// (sum over j of rows[i + j] @ D_j) exists because Mosaic rejects unaligned
// hop-strided loads; here the A operand is read straight from the waveform
// into wgmma's register fragments, one row per (frame, channel) at stride
// hop, the reflect pad as index arithmetic. The B operand is the windowed
// (cos, -sin) table, built once per (n_fft, window) on the host in float64
// and split into tf32 hi and lo, only for the bins from the first to the
// last one with a non-zero mel weight (the others add nothing to any
// output), in tiles of 64 bins. A block takes 32 frames of one clip and
// walks the tiles; each tile's spectrum becomes the seven per-bin values
// and goes through the tile's mel table on the tensor cores, so no spectrum
// reaches device memory.

#include "frontend_common.cuh"

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, 4, N) f32; tab (n_tiles, 2, 128, Kp) f32: per tile of 64 bins from
// the first weighted one the hi and lo parts of the windowed cos and -sin,
// rows the columns (column 8 j + 2 t + c: local bin 16 t + j, c = 0 cos,
// 1 -sin), k zero from n_fft to Kp (a multiple of 32); fb (n_groups, 2, 64, 64) f32: the hi
// and lo mel tables of each group of 64 mels, rows the mels (zero from
// n_mels on), k its tile's local bins in the kernel's order; plan
// (n_tiles + 1, 2) i32: a tile's first mel and first group; aff (2, 7,
// n_mels) f32 or null; acc (B, blocks, 32, 7, n_mels) f32 scratch where
// n_mels > 64, else null; out (B, 7, t_out, n_mels) f32 or bf16.
extern "C" int logmel_iv_flat(const float* x, const float* tab, const float* fb,
                              const int* plan, const float* aff, float* acc, void* out, int B,
                              int N, int n_fft, int hop, int Kp, int n_tiles, int n_groups,
                              int n_mels, int n_frames, int t_out, int out_bf16,
                              cudaStream_t stream) {
  if (Kp < n_fft) return static_cast<int>(cudaErrorInvalidValue);
  fe::FormArgs a = {};
  a.x = x;
  a.aff = aff;
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
  a.t_out = t_out;
  a.out_bf16 = out_bf16;
  return fe::launch_forms<false>(tab, fb, a, B, Kp, n_groups, stream);
}
