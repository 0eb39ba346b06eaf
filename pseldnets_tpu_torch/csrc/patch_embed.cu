// Kernel K8: the HTSAT patch embed, eval.
//
// Replaces the JAX package's ops/pallas/patch_embed.py::patch_embed_tokens
// (_kernel, pallas_call at :119): normalized features (B, C, T, F) -> the
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
// (0.016 ms at 3.35 TB/s) for 2.8 GFLOP (K = 7 * 16 = 112 per token).
//
// Design: the Pallas kernel's block-diagonal (C sw, F, Fp Ep) weight fold
// and its lane padding of E to 128 answer Mosaic's lane rules; here each
// block gathers the 7 x 4 x 4 patches of 128 tokens (all 16 frequency
// patches of 8 time patches of one group g: 32 contiguous frames of each
// channel) into shared memory with the wav2img index map, keeps the
// (112, 96) weights there in float32, and runs the products on float32
// FMA: a thread owns 4 tokens x 12 channels, so each k step is one float4
// of patch values and three float4 of weights for 48 FMAs. The LayerNorm's
// two passes reduce over the 8 threads of a token with shuffles, and each
// thread stores its 4 x 12 outputs once. The weights are prepared once per
// model and dtype (ops/patch_embed.py), not on every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int E = 96;          // embed width (HTSAT's published 96)
constexpr int FP = 16;         // frequency patches: F = 64
constexpr int TPB = 8;         // time patches per block
constexpr int TOK = FP * TPB;  // tokens per block
constexpr int THREADS = 256;   // 32 token groups of 4 x 8 channel groups
constexpr float LN_EPS = 1e-5f;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) patch_embed_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, T* __restrict__ out,
    int C, int T_in, int T_img, int fr) {
  extern __shared__ float4 smem4[];
  const int K = C * 16;
  float* ps = reinterpret_cast<float*>(smem4);  // [K][TOK] patch values
  float* ws = ps + K * TOK;                     // [K][E] weights
  const int tid = threadIdx.x;
  const int tg = T_img / fr, tp_n = tg / 4;
  const int tblk = tp_n / TPB;
  const int b = blockIdx.x / (fr * tblk), rest = blockIdx.x % (fr * tblk);
  const int g = rest / tblk, tp0 = (rest % tblk) * TPB;

  for (int i = tid; i < K * E; i += THREADS) ws[i] = to_f(__ldg(w + i));
  // patch gather: (c, frame r of the block's 32, frequency f) -> k = (c 4 +
  // f % 4) 4 + r % 4 (the conv's (c, kh, kw)), token f / 4 * TPB + r / 4
  const int t0 = g * tg + tp0 * 4;
  for (int i = tid; i < C * TPB * 4 * 64; i += THREADS) {
    const int f = i & 63, r = (i >> 6) & (TPB * 4 - 1), c = i / (TPB * 4 * 64);
    const int t = t0 + r;
    const float v = t < T_in ? to_f(x[(((long)b * C + c) * T_in + t) * 64 + f]) : 0.f;
    ps[((c * 4 + (f & 3)) * 4 + (r & 3)) * TOK + (f >> 2) * TPB + (r >> 2)] = v;
  }
  __syncthreads();

  // thread: tokens 4 tgi .. 4 tgi + 3 (one frequency patch, 4 time
  // patches), channels j 32 + cg 4 + i for j < 3, i < 4
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
  const int fp = tgi / (TPB / 4), tq = (tgi % (TPB / 4)) * 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
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
    const long tok = ((long)g * FP + fp) * tp_n + tp0 + tq + a;
    T* o = out + ((long)b * fr * FP * tp_n + tok) * E;
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

template <typename T>
int launch(const void* x, const void* w, const float* bias, const float* ln_w,
           const float* ln_b, void* out, int B, int C, int T_in, int T_img, int fr,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)C * 16 * (TOK + E);
  cudaError_t e = cudaFuncSetAttribute(patch_embed_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = B * fr * (T_img / fr / 4 / TPB);
  patch_embed_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, ln_w, ln_b,
      static_cast<T*>(out), C, T_in, T_img, fr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, C, T_in, 64) and w (C * 16, 96) in the compute dtype (bf16 if
// is_bf16, else float32), w[(c 4 + kh) 4 + kw][e] the conv kernel; bias,
// ln_w, ln_b (96,) f32; out (B, fr 16 T_img / fr / 4, 96) in the compute
// dtype. T_in <= T_img; T_img / fr a multiple of 4 * 8.
extern "C" int patch_embed_tokens(const void* x, const void* w, const float* bias,
                                  const float* ln_w, const float* ln_b, void* out, int B, int C,
                                  int T_in, int T_img, int fr, int is_bf16,
                                  cudaStream_t stream) {
  if (fr < 1 || T_img % fr || (T_img / fr) % (4 * TPB) || T_in > T_img || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, bias, ln_w, ln_b, out, B, C, T_in, T_img, fr,
                                         stream)
                 : launch<float>(x, w, bias, ln_w, ln_b, out, B, C, T_in, T_img, fr, stream);
}
