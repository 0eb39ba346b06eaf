// Code of the adapter block kernel K4 (swin_block_adapt.cu, forward) beside
// swin_common.cuh: the float32 residual + LayerNorm that builds y and h2, the
// adapter shapes, the workspace carver, the shape check and a GEMM-parameter
// helper. Everything is in an anonymous namespace, as in swin_common.cuh.

#pragma once

#include "swin_common.cuh"

namespace {

constexpr int ROW_THREADS = 256;  // 8 rows (warps) per block in the row kernels

// y = x + m0 * (a + s * t) in float32 over token rows (one warp per row);
// y_out[t] = y (or null), h_out[t] = bf16(LN(y) * w + b), and, when not
// null, xhat_out[t] = LN(y) and rstd_out[t] = 1 / sigma
__global__ void __launch_bounds__(ROW_THREADS) adapt_residual_ln_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ a, const float* __restrict__ t,
    const float* __restrict__ masks, float s, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ y_out, bf16* __restrict__ h_out,
    float* __restrict__ xhat_out, float* __restrict__ rstd_out, int rows, int L, int C) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float m0 = masks[2 * (r / L)];
  const long row = (long)r * C;
  auto load = [&](int k) -> float {
    const float branch = bf2f(a[row + k]) + s * t[row + k];
    return bf2f(x[row + k]) + m0 * branch;
  };
  float sum = 0.f;
  for (int k = lane; k < C; k += 32) sum += load(k);
  const float mu = warp_sum(sum) / C;
  float var = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float d = load(k) - mu;
    var += d * d;
  }
  const float rs = rsqrtf(warp_sum(var) / C + LN_EPS);
  for (int k = lane; k < C; k += 32) {
    const float v = load(k);
    const float xh = (v - mu) * rs;
    if (y_out != nullptr) y_out[row + k] = v;
    if (xhat_out != nullptr) xhat_out[row + k] = xh;
    h_out[row + k] = f2bf(xh * w[k] + b[k]);
  }
  if (lane == 0 && rstd_out != nullptr) rstd_out[r] = rs;
}

// ---- host side -----------------------------------------------------------

struct Shapes {
  int B, H, W, C, nh, win, shift, hidden;
  long M() const { return (long)B * H * W; }
  int n_windows() const { return B * (H / win) * (W / win); }
};

struct AdaptShapes : Shapes {
  int ch;  // adapter width, padded to a multiple of 32
};

// carves `base` (or, with null, only counts bytes) in 256-byte steps
struct Carver {
  char* base;
  long off = 0;
  char* take(long n, long elem) {
    char* p = base != nullptr ? base + off : nullptr;
    off += (n * elem + 255) / 256 * 256;
    return p;
  }
  bf16* bf(long n) { return reinterpret_cast<bf16*>(take(n, 2)); }
  float* fl(long n) { return reinterpret_cast<float*>(take(n, 4)); }
};

bool bad_shapes(const AdaptShapes& s) {
  return s.C / s.nh != HD || s.C % s.nh || s.win * s.win != WIN_N || s.C % 32 || s.hidden % 32 ||
         s.ch % 32 || s.ch <= 0 || s.H % s.win || s.W % s.win;
}

// GemmParams of C = A @ B on M rows: A (M, K) bf16, B the (K, N) matrix Bm
// or, launched with BT, the transpose of the (N, K) matrix Bm; the caller
// sets the rest
GemmParams plain_gemm(const RowMap& g, const bf16* A, int K, const bf16* Bm, int N, long M) {
  GemmParams p{};
  p.g = g;
  p.A = A; p.lda = K; p.Bm = Bm; p.M = static_cast<int>(M); p.N = N; p.K = K;
  return p;
}

// blocks of the one-warp-per-row kernels over M rows
long row_blocks(long M) { return (M + 7) / 8; }

}  // namespace
