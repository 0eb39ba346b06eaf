// Kernel K6: the pre-LN ViT block of PaSST, eval form, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/pallas/vit_block.py::vit_block_fused
// (_vit_kernel, attn_impl="exact"). x (B, N, C) bf16 -> (B, N, C) bf16,
// rounded where the Pallas kernel rounds (vit_block.py:43-115):
//   h = bf16(LN1(x))                 LN in float32, two-pass moments, eps
//   qkv = bf16(h Wqkv^T + b)
//   per head S = (q / 8) K^T in float32, P = bf16(softmax(S)) (normalized,
//   then rounded), O = bf16(P V)
//   y = bf16(x + bf16(O Wproj^T + b))
//   f = bf16(gelu_erf(bf16(LN2(y)) W1^T + b1))
//   out = bf16(y + bf16(f W2^T + b2))
// Weights are nn.Linear's (out, in) bf16 matrices; biases and norms float32.
// The q-scale 1/8 (head dim 64) is a power of two, so scaling the float32
// scores is the same arithmetic as scaling q in bf16 before the product.
//
// What bounds it on the H100: per image 2 N C (3C + C + 2 hidden) GEMM FLOPs
// and 4 N^2 C attention FLOPs (9.64 GFLOP at N = 602, C = 768, hidden 3072)
// against ~14 MB of weights and 2 N C bf16 activations per image: far above
// the bf16 balance point, so the bound is the tensor-core rate, which only
// wgmma reaches.
//
// Design. One image's activations do not fit an SM's shared memory, so the
// block is seven launches from one C entry point, on the caller's stream,
// with h, qkv, the heads, y and the hidden activations through device
// memory (scratch from the caller):
//  * vit_layernorm (x2): one warp per row writes h = bf16(LN(x)), so every
//    GEMM's A is a plain TMA load;
//  * sm90_gemm (x4, sm90_gemm.cuh): the persistent TMA + mbarrier + wgmma
//    GEMM with its epilogue stored by TMA (qkv: bias; proj, fc2: bias +
//    residual; fc1: bias + GELU);
//  * vit_attention: one block per (image, head, 128 query rows), two per
//    SM, each a TMA producer warpgroup and two consumer warpgroups of 64
//    rows. qkv is read through 3-D tensor maps (3C, N, B), so a key tile
//    never crosses into the next image and rows at or past N arrive as
//    zeros. Pass 1 runs S = Q K^T (wgmma, 64 keys a tile) with a running
//    float32 row max and sum; pass 2 recomputes S, forms p = bf16(exp(S /
//    8 - m) / l) for keys < N and exactly 0 past N, and accumulates O += P V
//    with P from the registers (wgmma's RS form, V transposed). The
//    recompute costs half the attention FLOPs again, but keeps the Pallas
//    rounding points (normalized P rounded) without the N x N scores in
//    shared memory, so N has no upper limit. The single-pass flash form
//    would round the unnormalized P. 64-key tiles leave registers for two
//    blocks per SM, whose four consumer warpgroups hide each other's
//    MMA -> softmax -> MMA chains; 128-key tiles at one block per SM
//    measured slower (scripts/torch_k6_tiles.py, att_kt128).

#include "sm90_gemm.cuh"

namespace {

constexpr int HD = 64;    // head dim
constexpr int QT = 128;   // query rows per attention block
constexpr int KT = 64;    // keys per K or V tile: 64 (two blocks per SM) or 128 (one)
constexpr int ATT_BLOCKS = KT == 64 ? 2 : 1;
constexpr int Q_BYTES = QT * HD * 2, KV_BYTES = KT * HD * 2;  // rows of 128 bytes
constexpr int ATT_STAGES = 4;  // K/V ring
constexpr int ATT_SMEM = Q_BYTES + ATT_STAGES * KV_BYTES + 8 * (1 + 2 * ATT_STAGES) + 1024;
constexpr int ATT_THREADS = 384;
// registers a thread after setmaxnreg, from the block's own pool (65536 /
// ATT_BLOCKS, at most 168 or 80 a thread at launch): producer, consumers
constexpr int ATT_PRODUCER_REGS = ATT_BLOCKS == 1 ? 40 : 24;
constexpr int ATT_CONSUMER_REGS = ATT_BLOCKS == 1 ? 232 : 104;
static_assert(ATT_PRODUCER_REGS * 128 + ATT_CONSUMER_REGS * 256 <=
                  (65536 / ATT_BLOCKS / ATT_THREADS) / 8 * 8 * ATT_THREADS,
              "setmaxnreg within the block's registers");

// tiles of the four GEMMs, the fastest in scripts/torch_k6_tiles.py at B=32,
// N=602 on the H100: qkv 128 x 192 shared by the two consumer warpgroups;
// proj, fc1 and fc2 128 x 128 per warpgroup, ping-pong (their epilogues,
// with the residual or GELU, cost more)
constexpr int BN_QKV = 192, BN_PROJ = 128, BN_FC1 = 128, BN_FC2 = 128;
constexpr bool PP_QKV = false, PP_PROJ = true, PP_FC1 = true, PP_FC2 = true;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// h = bf16(LN(x)), one warp per row of C (C % 8 == 0) bf16, moments two-pass
// in float32; the loops are unrolled so that a lane's loads are in flight
// together (the row's second and third reads hit L1)
__global__ void __launch_bounds__(256) vit_layernorm(const bf16* __restrict__ x,
                                                     const float* __restrict__ w,
                                                     const float* __restrict__ b,
                                                     bf16* __restrict__ h, int rows, int C,
                                                     float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<long>(row) * C);
  uint4* hr = reinterpret_cast<uint4*>(h + static_cast<long>(row) * C);
  const int nv = C / 8;
  float s = 0.f;
#pragma unroll 4
  for (int v = lane; v < nv; v += 32) {
    Pack8 p;
    p.u = xr[v];
#pragma unroll
    for (int e = 0; e < 8; ++e) s += __bfloat162float(p.h[e]);
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll 4
  for (int v = lane; v < nv; v += 32) {
    Pack8 p;
    p.u = xr[v];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = __bfloat162float(p.h[e]) - mu;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll 4
  for (int v = lane; v < nv; v += 32) {
    Pack8 p, o;
    p.u = xr[v];
    const float4 wa = w4[2 * v], wb = w4[2 * v + 1], ba = b4[2 * v], bb = b4[2 * v + 1];
    const float ws[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const float bs[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o.h[e] = __float2bfloat16_rn((__bfloat162float(p.h[e]) - mu) * rstd * ws[e] + bs[e]);
    hr[v] = o.u;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// grid (ceil(N / QT), heads, B); qkv through 3-D maps (3C, N, B), boxes
// (64, QT, 1) for Q and (64, KT, 1) for K and V; out (B N, C)
__global__ void __launch_bounds__(ATT_THREADS, ATT_BLOCKS)
    vit_attention(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_kv, bf16* __restrict__ out, int N, int C) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sKV = base + Q_BYTES;
  const uint32_t q_full = sKV + ATT_STAGES * KV_BYTES;
  const uint32_t full = q_full + 8, empty = full + 8 * ATT_STAGES;
  const int q0 = blockIdx.x * QT, head = blockIdx.y, img = blockIdx.z;
  const int nkt = (N + KT - 1) / KT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ATT_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: Q once, then K_0 .. K_n-1 (pass 1), then K_j, V_j in turn
    setmaxnreg_dec<ATT_PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load_3d(sQ, &tm_q, head * HD, q0, img, q_full);
      int s = 0;
      uint32_t ph = 0;
      for (int i = 0; i < 3 * nkt; ++i) {
        const int j = i < nkt ? i : (i - nkt) / 2;
        const int col = (i < nkt || (i - nkt) % 2 == 0 ? C : 2 * C) + head * HD;
        mbar_wait(empty + 8 * s, ph ^ 1);
        mbar_expect_tx(full + 8 * s, KV_BYTES);
        tma_load_3d(sKV + s * KV_BYTES, &tm_kv, col, j * KT, img, full + 8 * s);
        if (++s == ATT_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup wg takes query rows q0 + 64 wg .. + 63
    setmaxnreg_inc<ATT_CONSUMER_REGS>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const float c = 0.125f * 1.4426950408889634f;  // the q-scale, in log2 units
    float sacc[KT / 2], oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    int s = 0;
    uint32_t ph = 0;
    const uint64_t dq = desc_sw128(sQ + wg * 64 * 128);
    mbar_wait(q_full, 0);

    // S = Q K_j^T for the tile in stage s (raw scores), then free the stage
    auto scores = [&]() {
      mbar_wait(full + 8 * s, ph);
      const uint64_t dk = desc_sw128(sKV + s * KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss<KT>(sacc, dq + 2 * kk, dk + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++s == ATT_STAGES) {
        s = 0;
        ph ^= 1;
      }
    };

    // pass 1: running row max m and sum l (rows lane / 4 and + 8 of the
    // warp's 16; this thread's columns summed, the quad's at the end)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j = 0; j < nkt; ++j) {
      scores();
      const int key0 = j * KT + 2 * (lane % 4);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        if (key0 + 8 * (i / 4) + i % 2 >= N) sacc[i] = -INFINITY;
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sacc[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        l[r] *= exp2f((m[r] - mx[r]) * c);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int r = (i % 4) / 2;
        l[r] += exp2f(fmaf(sacc[i], c, -m[r] * c));
      }
    }
    float inv[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv[r] = 1.f / quad_sum(l[r]);
      mc[r] = m[r] * c;
    }

    // pass 2: P = bf16(exp(S / 8 - m) / l) in registers, O += P V_j
    for (int j = 0; j < nkt; ++j) {
      scores();
      const int key0 = j * KT + 2 * (lane % 4);
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // register pair q of k-step kk: columns 16 kk + 8 (q / 2), row q % 2
          const int i = 4 * (2 * kk + q / 2) + 2 * (q % 2);
          const int r = q % 2, key = key0 + 16 * kk + 8 * (q / 2);
          const float p0 = key < N ? exp2f(fmaf(sacc[i], c, -mc[r])) * inv[r] : 0.f;
          const float p1 = key + 1 < N ? exp2f(fmaf(sacc[i + 1], c, -mc[r])) * inv[r] : 0.f;
          pa[kk][q] = pack_bf16(p0, p1);
        }
      }
      mbar_wait(full + 8 * s, ph);
      const uint64_t dv = desc_sw128(sKV + s * KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_rs_tb<HD>(oacc, pa[kk], dv + 128 * kk, j > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++s == ATT_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }

    // O rounded to bf16 into the head's 64 columns
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= N) continue;
      bf16* o = out + (static_cast<long>(img) * N + row) * C + head * HD + 2 * (lane % 4);
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * jj) =
            __floats2bfloat162_rn(oacc[4 * jj + 2 * half], oacc[4 * jj + 2 * half + 1]);
    }
  }
}

cudaError_t launch_attention(const bf16* qkv, bf16* out, int B, int N, int C, int nh,
                             cudaStream_t stream) {
  CUtensorMap tq, tkv;
  const uint64_t dims[3] = {3ull * C, static_cast<uint64_t>(N), static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {3ull * C * sizeof(bf16), 3ull * C * N * sizeof(bf16)};
  const uint32_t box_q[3] = {HD, QT, 1}, box_kv[3] = {HD, KT, 1};
  cudaError_t e = make_tmap(&tq, qkv, 3, dims, strides, box_q);
  if (e == cudaSuccess) e = make_tmap(&tkv, qkv, 3, dims, strides, box_kv);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(vit_attention, cudaFuncAttributeMaxDynamicSharedMemorySize, ATT_SMEM);
  if (e != cudaSuccess) return e;
  vit_attention<<<dim3((N + QT - 1) / QT, nh, B), ATT_THREADS, ATT_SMEM, stream>>>(tq, tkv, out, N,
                                                                                  C);
  return cudaGetLastError();
}

cudaError_t launch_layernorm(const bf16* x, const float* w, const float* b, bf16* h, int rows,
                             int C, float eps, cudaStream_t stream) {
  vit_layernorm<<<(rows + 7) / 8, 256, 0, stream>>>(x, w, b, h, rows, C, eps);
  return cudaGetLastError();
}

struct BlockArgs {
  const bf16* x;
  const float *ln1_w, *ln1_b;
  const bf16* qkv_w;
  const float* qkv_b;
  const bf16* proj_w;
  const float *proj_b, *ln2_w, *ln2_b;
  const bf16* fc1_w;
  const float* fc1_b;
  const bf16* fc2_w;
  const float* fc2_b;
  bf16 *h, *qkv, *attn, *y, *hid, *out;
  int B, N, C, nh, hidden;
  float eps;
};

// the limits of this design: head dim 64; 16-byte rows for TMA (C and
// hidden multiples of 8); the attention grid's B <= 65535; int32 rows
bool block_shape_ok(int B, int N, int C, int nh, int hidden) {
  return C == nh * HD && hidden > 0 && hidden % 8 == 0 && N >= 1 && B >= 1 && B <= 65535 &&
         static_cast<long>(B) * N < (1L << 31);
}

// the seven launches; ev (8 events) recorded before each and after the last
// when given
cudaError_t run_block(const BlockArgs& a, cudaStream_t stream, cudaEvent_t* ev) {
  const int M = a.B * a.N, C = a.C;
  cudaError_t e = cudaSuccess;
  int phase = 0;
  auto mark = [&]() {
    if (ev != nullptr && e == cudaSuccess) e = cudaEventRecord(ev[phase++], stream);
  };
  mark();
  if (e == cudaSuccess) e = launch_layernorm(a.x, a.ln1_w, a.ln1_b, a.h, M, C, a.eps, stream);
  mark();
  if (e == cudaSuccess)
    e = sm90_gemm<BN_QKV, EPI_BIAS, PP_QKV>(
        a.h, a.qkv_w, GemmArgs{a.qkv_b, nullptr, a.qkv, M, 3 * C, C}, stream);
  mark();
  if (e == cudaSuccess) e = launch_attention(a.qkv, a.attn, a.B, a.N, C, a.nh, stream);
  mark();
  if (e == cudaSuccess)
    e = sm90_gemm<BN_PROJ, EPI_BIAS_RESID, PP_PROJ>(
        a.attn, a.proj_w, GemmArgs{a.proj_b, a.x, a.y, M, C, C}, stream);
  mark();
  if (e == cudaSuccess) e = launch_layernorm(a.y, a.ln2_w, a.ln2_b, a.h, M, C, a.eps, stream);
  mark();
  if (e == cudaSuccess)
    e = sm90_gemm<BN_FC1, EPI_BIAS_GELU, PP_FC1>(
        a.h, a.fc1_w, GemmArgs{a.fc1_b, nullptr, a.hid, M, a.hidden, C}, stream);
  mark();
  if (e == cudaSuccess)
    e = sm90_gemm<BN_FC2, EPI_BIAS_RESID, PP_FC2>(
        a.hid, a.fc2_w, GemmArgs{a.fc2_b, a.y, a.out, M, C, a.hidden}, stream);
  mark();
  return e;
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One eval ViT block. Weights are (out, in) bf16 matrices and float32
// vectors. Scratch: h (B*N, C), qkv (B*N, 3C), attn / y (B*N, C), hid (B*N,
// hidden) bf16. Output out (B*N, C) bf16. Every tensor 16-byte aligned.
extern "C" int vit_block_forward(
    const bf16* x, const float* ln1_w, const float* ln1_b, const bf16* qkv_w,
    const float* qkv_b, const bf16* proj_w, const float* proj_b, const float* ln2_w,
    const float* ln2_b, const bf16* fc1_w, const float* fc1_b, const bf16* fc2_w,
    const float* fc2_b, bf16* h, bf16* qkv, bf16* attn, bf16* y, bf16* hid, bf16* out, int B,
    int N, int C, int nh, int hidden, float eps, cudaStream_t stream) {
  if (!block_shape_ok(B, N, C, nh, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockArgs a{x, ln1_w, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_w, ln2_b, fc1_w, fc1_b,
                    fc2_w, fc2_b, h, qkv, attn, y, hid, out, B, N, C, nh, hidden, eps};
  return static_cast<int>(run_block(a, stream, nullptr));
}

// The same block `reps` times with CUDA events around each of its seven
// launches; phase_ms[7] gets the mean ms of LN1, qkv, attention, proj, LN2,
// fc1 and fc2. Synchronizes the stream.
extern "C" int vit_block_phases(
    const bf16* x, const float* ln1_w, const float* ln1_b, const bf16* qkv_w,
    const float* qkv_b, const bf16* proj_w, const float* proj_b, const float* ln2_w,
    const float* ln2_b, const bf16* fc1_w, const float* fc1_b, const bf16* fc2_w,
    const float* fc2_b, bf16* h, bf16* qkv, bf16* attn, bf16* y, bf16* hid, bf16* out, int B,
    int N, int C, int nh, int hidden, float eps, float* phase_ms, int reps,
    cudaStream_t stream) {
  if (!block_shape_ok(B, N, C, nh, hidden) || reps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockArgs a{x, ln1_w, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_w, ln2_b, fc1_w, fc1_b,
                    fc2_w, fc2_b, h, qkv, attn, y, hid, out, B, N, C, nh, hidden, eps};
  cudaEvent_t ev[8];
  int made = 0;
  cudaError_t e = cudaSuccess;
  for (; made < 8 && e == cudaSuccess; ++made) e = cudaEventCreate(&ev[made]);
  for (int i = 0; i < 7; ++i) phase_ms[i] = 0.f;
  for (int r = 0; r < reps && e == cudaSuccess; ++r) {
    e = run_block(a, stream, ev);
    if (e == cudaSuccess) e = cudaEventSynchronize(ev[7]);
    for (int i = 0; i < 7 && e == cudaSuccess; ++i) {
      float ms = 0.f;
      e = cudaEventElapsedTime(&ms, ev[i], ev[i + 1]);
      phase_ms[i] += ms / reps;
    }
  }
  for (int i = 0; i < made; ++i) cudaEventDestroy(ev[i]);
  return static_cast<int>(e);
}

// The GEMM core alone: out (M, N) = epilogue(A (M, K) . W (N, K)^T + bias),
// epi 0 bias, 1 bias + resid, 2 bias + GELU; tile 128 x bn (128, 192, 256),
// or 128 x 128 ping-pong for bn = -128.
extern "C" int vit_gemm(const bf16* A, const bf16* W, const float* bias, const bf16* resid,
                        bf16* out, int M, int N, int K, int epi, int bn, cudaStream_t stream) {
  const GemmArgs g{bias, resid, out, M, N, K};
  cudaError_t e;
  switch (epi) {
    case EPI_BIAS: e = sm90_gemm_bn<EPI_BIAS>(bn, A, W, g, stream); break;
    case EPI_BIAS_RESID: e = sm90_gemm_bn<EPI_BIAS_RESID>(bn, A, W, g, stream); break;
    case EPI_BIAS_GELU: e = sm90_gemm_bn<EPI_BIAS_GELU>(bn, A, W, g, stream); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
