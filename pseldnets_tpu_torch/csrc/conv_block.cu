// Kernel K7: the fused 3x3 conv + bias + ReLU of the CNN trunk's ConvBlock.
//
// Replaces the JAX package's ops/pallas/conv_block.py::conv3x3_bias_relu
// (_kernel_single, _kernel_double, _kernel_relu_conv). NHWC bf16
// activations, the eval BatchNorm folded into the weights, SAME padding,
// stride 1:
//   single:    out = relu(conv3x3(x, w1) + b1)
//   pair:      mid = relu(conv3x3(x, w1) + b1), rounded to bf16;
//              out = relu(conv3x3(mid, w2) + b2)
//   relu_conv: out = relu(conv3x3(relu(x + b1), w2) + b2), relu(x + b1)
//              rounded to bf16
// Outside the image every conv input is zero: the mid's SAME halo is zero,
// not relu(b1 + edge taps) (_zero_mid_halo), and so is relu(x + b1)'s.
// bf16 operands, float32 accumulation, the float32 bias added before the one
// rounding to bf16: the Pallas kernel's numeric contract.
//
// What bounds it on the H100: 2 M 9 Cin Cout FLOPs per conv (M = B T F
// output positions) against one bf16 read of the input, the weights and one
// bf16 write of the output. At the CNN12 trunk's shapes the six ConvBlocks do
// 2.21 TFLOP per batch of 32 against ~2 GB: the bound is the tensor-core rate
// (2.23 ms at 989 TFLOP/s).
//
// Design (correct and simple first): each conv is an implicit GEMM, M
// output positions x Cout, K = 9 Cin, with Cin a multiple of 16 (the wrapper
// pads the stem's 7 channels with zeros, in x and in the weights). The
// weights are the contiguous HWIO tensor read as a (9 Cin, Cout) matrix, row
// (3 dt + df) Cin + c. A block computes a 128 x 128 output tile with 4
// warps of 64 x 64 (16 WMMA tiles each, two MMAs per fragment load), or,
// where Cout <= 64, a 128 x 64 tile with 8 warps of 32 x 32: per
// K step of BK (32, or 16 when Cin % 32 != 0) channels of one tap (dt, df),
// cp.async gathers the A tile straight from NHWC (16 bytes, 8 channels, per
// copy; positions whose tap falls outside the image are zero-filled by the
// copy) and the B tile from the weight matrix, 3-4 stages deep. Each warp
// runs bf16 WMMA 16x16x16 tiles with float32 accumulators; the epilogue
// stages them in shared memory, adds the float32 bias, applies ReLU and
// writes bf16 with 16-byte stores. relu_conv transforms each thread's own
// copied pieces in shared memory before the block syncs. The pair is two
// launches on the caller's stream with the bf16 mid in device memory: the
// same arithmetic as _kernel_double. Keeping the mid on chip with a
// recomputed halo, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;  // output positions per block

// One tile shape: BK input channels of one tap per K step, BN output
// channels, warps of WM x WN outputs, STAGES cp.async stages.
template <int BK_, int BN_, int WM_, int WN_, int STAGES_>
struct Cfg {
  static constexpr int BK = BK_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int FM = WM / 16, FN = WN / 16;  // WMMA tiles per warp
  static constexpr int LDA = BK + 8;  // bf16 row stride of an activation tile
  static constexpr int LDB = BN + 8;  // bf16 row stride of a weight tile
  static constexpr int LDC = BN + 4;  // float32 row stride of the staged output
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
  static constexpr int PIECES = BK / 8;  // 16-byte pieces per A row
  static constexpr int A_ITERS = BM * PIECES / THREADS;
  static constexpr int B_PIECES = BK * (BN / 8);
  static constexpr int B_ITERS = (B_PIECES + THREADS - 1) / THREADS;
  static constexpr size_t PIPE_BYTES = (size_t)STAGES * STAGE_ELEMS * sizeof(bf16);
  static constexpr size_t C_BYTES = (size_t)BM * LDC * sizeof(float);
  static constexpr size_t SMEM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
  static_assert(A_ITERS >= 1 && BM * PIECES % THREADS == 0, "A tile split");
  static_assert((A_ELEMS * sizeof(bf16)) % 128 == 0 && (STAGE_ELEMS * sizeof(bf16)) % 128 == 0,
                "WMMA tiles need 32-byte alignment");
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
};

// the stem's first conv (Cin = 16), and every conv with Cout <= 64
using SmallBK16 = Cfg<16, 64, 32, 32, 3>;
using Small = Cfg<32, 64, 32, 32, 3>;
// every other conv: the fastest of the shapes that scripts/torch_k7_tiles.py
// times at the trunk's (B = 32; PERF.md): BK 64 took 6-10% longer, 8 warps
// of 64 x 32 took 26% longer
using Big = Cfg<32, 128, 64, 64, 4>;

union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One conv of the block: out = relu(conv3x3(A, w) + bias), A = x, or
// relu(x + bin) rounded to bf16 when RELU_IN. x (M, Cin) NHWC positions, w
// (9 Cin, Cout), out (M, Cout).
template <class C, bool RELU_IN>
__global__ void __launch_bounds__(C::THREADS) conv3x3_igemm(
    const bf16* __restrict__ x, const float* __restrict__ bin, const bf16* __restrict__ w,
    const float* __restrict__ bias, bf16* __restrict__ out, int M, int T, int F, int Cin,
    int Cout) {
  constexpr int BK = C::BK, BN = C::BN, LDA = C::LDA, LDB = C::LDB, LDC = C::LDC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* pipe = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int steps_per_tap = Cin / BK;
  const int KT = 9 * steps_per_tap;

  // this thread's A pieces: row (output position) and 8-channel piece, the
  // same in every K step; its position's (t, f) for the image-edge test
  int a_row[C::A_ITERS], a_piece[C::A_ITERS], a_t[C::A_ITERS], a_f[C::A_ITERS];
  bool a_in[C::A_ITERS];
#pragma unroll
  for (int i = 0; i < C::A_ITERS; ++i) {
    const int c = tid + i * C::THREADS;
    a_row[i] = c / C::PIECES;
    a_piece[i] = c % C::PIECES;
    const int m = m0 + a_row[i];
    a_in[i] = m < M;
    a_f[i] = m % F;
    a_t[i] = (m / F) % T;
  }

  // whether A piece i of K step ks reads inside the image
  auto a_valid = [&](int i, int ks, int& dt, int& df) {
    const int tap = ks / steps_per_tap;
    dt = tap / 3 - 1;
    df = tap % 3 - 1;
    const int t = a_t[i] + dt, f = a_f[i] + df;
    return a_in[i] && t >= 0 && t < T && f >= 0 && f < F;
  };

  auto load_stage = [&](int stage, int ks) {
    bf16* As = pipe + stage * C::STAGE_ELEMS;
    bf16* Bs = As + C::A_ELEMS;
    const int c0 = (ks % steps_per_tap) * BK;
#pragma unroll
    for (int i = 0; i < C::A_ITERS; ++i) {
      int dt, df;
      const bool ok = a_valid(i, ks, dt, df);
      const bf16* src =
          ok ? x + ((long)(m0 + a_row[i]) + (long)dt * F + df) * Cin + c0 + a_piece[i] * 8 : x;
      cp_async16(As + a_row[i] * LDA + a_piece[i] * 8, src, ok);
    }
#pragma unroll
    for (int i = 0; i < C::B_ITERS; ++i) {
      const int c = tid + i * C::THREADS;
      if (C::B_PIECES % C::THREADS && c >= C::B_PIECES) break;
      const int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const bool ok = n0 + col < Cout;
      const bf16* src = ok ? w + (long)(ks * BK + row) * Cout + n0 + col : w;
      cp_async16(Bs + row * LDB + col, src, ok);
    }
  };

  // relu(x + bin) over this thread's own pieces of a landed stage; pieces
  // outside the image stay zero
  auto relu_in = [&](int stage, int ks) {
    bf16* As = pipe + stage * C::STAGE_ELEMS;
    const int c0 = (ks % steps_per_tap) * BK;
#pragma unroll
    for (int i = 0; i < C::A_ITERS; ++i) {
      int dt, df;
      if (!a_valid(i, ks, dt, df)) continue;
      Pack8* p = reinterpret_cast<Pack8*>(As + a_row[i] * LDA + a_piece[i] * 8);
      Pack8 v = *p;
      const float* bb = bin + c0 + a_piece[i] * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v.h[e] = __float2bfloat16_rn(fmaxf(__bfloat162float(v.h[e]) + bb[e], 0.f));
      *p = v;
    }
  };

  const int wm = (warp % C::WARPS_M) * C::WM, wn = (warp / C::WARPS_M) * C::WN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::FM][C::FN];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < KT; ++ks) {
    cp_async_wait<C::STAGES - 2>();  // this thread's copies of step ks have landed
    if (RELU_IN) relu_in(ks % C::STAGES, ks);
    __syncthreads();  // everyone's copies landed; the stage refilled below is consumed
    if (ks + C::STAGES - 1 < KT) load_stage((ks + C::STAGES - 1) % C::STAGES, ks + C::STAGES - 1);
    cp_async_commit();
    const bf16* As = pipe + (ks % C::STAGES) * C::STAGE_ELEMS;
    const bf16* Bs = As + C::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[C::FN];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory becomes the output tile

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * (BN / 8); idx += C::THREADS) {
    const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= Cout) continue;
    Pack8 pk;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      pk.h[e] = __float2bfloat16_rn(fmaxf(Cs[r * LDC + c + e] + bias[n + e], 0.f));
    *reinterpret_cast<uint4*>(out + (long)m * Cout + n) = pk.u;
  }
}

template <class C, bool RELU_IN>
cudaError_t launch(const bf16* x, const float* bin, const bf16* w, const float* bias, bf16* out,
                   int M, int T, int F, int Cin, int Cout, cudaStream_t stream) {
  auto kernel = conv3x3_igemm<C, RELU_IN>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((M + BM - 1) / BM, (Cout + C::BN - 1) / C::BN);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(x, bin, w, bias, out, M, T, F, Cin, Cout);
  return cudaGetLastError();
}

template <bool RELU_IN>
cudaError_t conv(const bf16* x, const float* bin, const bf16* w, const float* bias, bf16* out,
                 int M, int T, int F, int Cin, int Cout, cudaStream_t stream) {
  if (Cin % 32) return launch<SmallBK16, RELU_IN>(x, bin, w, bias, out, M, T, F, Cin, Cout, stream);
  if (Cout <= 64) return launch<Small, RELU_IN>(x, bin, w, bias, out, M, T, F, Cin, Cout, stream);
  return launch<Big, RELU_IN>(x, bin, w, bias, out, M, T, F, Cin, Cout, stream);
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One ConvBlock call. mode 0 (single): out = relu(conv(x, w1) + b1), Cout =
// cout. mode 1 (pair): mid (M, cmid) = relu(conv(x, w1) + b1), out =
// relu(conv(mid, w2) + b2). mode 2 (relu_conv): out = relu(conv(relu(x + b1),
// w2) + b2), cmid = cin. x (B, T, F, cin) bf16; weights contiguous HWIO bf16
// ((9 Cin, Cout) matrices); biases float32. Needs cin (and the pair's cmid) %
// 16 == 0 and every Cout % 8 == 0.
extern "C" int conv_block_forward(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                                  const float* b2, bf16* mid, bf16* out, int mode, int B, int T,
                                  int F, int cin, int cmid, int cout, cudaStream_t stream) {
  if (B < 1 || T < 1 || F < 1 || cin % 16 || cout % 8 || mode < 0 || mode > 2 ||
      (mode == 1 && (cmid % 16 || !mid)) || (mode != 2 && !w1) || (mode != 0 && (!w2 || !b2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long Ml = (long)B * T * F;
  if (Ml * (cin > cout ? cin : cout) >= (1L << 31) || (mode == 1 && Ml * cmid >= (1L << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = static_cast<int>(Ml);
  cudaError_t e;
  if (mode == 0) {
    e = conv<false>(x, nullptr, w1, b1, out, M, T, F, cin, cout, stream);
  } else if (mode == 1) {
    e = conv<false>(x, nullptr, w1, b1, mid, M, T, F, cin, cmid, stream);
    if (e == cudaSuccess) e = conv<false>(mid, nullptr, w2, b2, out, M, T, F, cmid, cout, stream);
  } else {
    e = conv<true>(x, b1, w2, b2, out, M, T, F, cin, cout, stream);
  }
  return static_cast<int>(e);
}
