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
// (2.23 ms at 989 TFLOP/s); the stem's pair alone is close to its bytes.
//
// Design: each conv is an implicit GEMM on Hopper's TMA and wgmma, written on
// the primitives of sm90_gemm.cuh (K6's core) with the same schedule: one
// persistent block of 384 threads per SM walks the output tiles, the weight
// panel outermost (consecutive tiles share it, so it stays in L2).
//  * An output tile is tT time rows x Fb bins of one image, tT Fb <= 128
//    (the host's plan: ops/conv_block.py::tile_plan), by BN output channels.
//  * A: x is a 4-D tensor map (C, F, T, B). For tap (dt, df) and channel
//    step c0 the producer loads the box (BK, Fb, tT, 1) at (c0, f0 + df - 1,
//    t0 + dt - 1, b): it lands as tT Fb rows of BK channels, the K-major,
//    swizzled A tile wgmma reads. TMA fills coordinates outside the tensor
//    with zeros, negative ones included: that is the SAME padding, and
//    channels past Cin read as zero, so any Cin % 8 == 0 works unpadded.
//    BK is 64 (128-byte rows and swizzle) or, for Cin <= 16, 16 (32-byte
//    rows and swizzle: no MMAs on 48 zero channels).
//  * B: the HWIO weights as they are, a 3-D map (Cout, Cin, 9): per tap and
//    channel step, BN / 64 boxes of (64, BK) land as BK rows of 64 output
//    channels, the MN-major B that wgmma reads with its transpose bit.
//  * Warpgroup 2 is the producer (one thread issues the loads into a ring of
//    stages with full and empty mbarriers; setmaxnreg 40); warpgroups 0 and
//    1 consume (setmaxnreg 232): cooperative, each runs wgmma m64nBNk16 on
//    its 64 rows of a 128 x BN tile (BN 64, 128, 192, 256), or ping-pong,
//    each owns every other 128 x BN tile (BN 64, 128) and the two take
//    turns at the mainloop. The K loop is 9 taps x ceil(Cin / BK) steps.
//  * relu_conv: the consumers rewrite their rows of each landed A tile in
//    shared memory as relu(x + b1) rounded to bf16, skipping the rows whose
//    tap falls outside the image and the channels past Cin (TMA's zeros
//    stay zero), then fence.proxy.async before wgmma reads them.
//  * Resident form, where the whole weight matrix is one panel that fits in
//    shared memory beside three ring stages and Fb % 8 == 0 (the stem's
//    convs): the producer loads all 9 ceil(Cin / BK) B tiles once per block,
//    and the ring holds, per (channel step, df), one box of (tT + 2) Fb
//    rows that the three taps dt read at row offsets 0, Fb and 2 Fb (whole
//    swizzle groups): three times fewer A bytes and no B bytes per tile.
//  * Epilogue: + the float32 bias, ReLU, one rounding to bf16, written into
//    a 128-byte-swizzled staging tile in shared memory and stored by one
//    thread through a 4-D output map with box (64, Fb, tT, 1): positions
//    past T or F and channels past Cout are clipped by the store.
// The pair is two launches on the caller's stream with the bf16 mid in
// device memory, the same arithmetic as _kernel_double.

#include "sm90_gemm.cuh"

namespace {

constexpr int CONV_BM = 128;  // output positions per tile
constexpr int CONV_THREADS = 384;
constexpr int CONV_MAX_STAGES = 16;

// The tile form of one conv: BN output channels, BK input channels per K
// step, PP ping-pong (each consumer warpgroup owns whole 128-row tiles).
template <int BN, int BK, bool PP>
struct ConvTile {
  static_assert(BK == 64 || BK == 16, "K steps of 64 (128-byte swizzle) or 16 (32-byte)");
  static_assert(!PP || BN <= 128, "ping-pong holds a 128 x BN tile per warpgroup");
  static constexpr int ROWS = PP ? 128 : 64;  // output rows a warpgroup owns per tile
  static constexpr int ROW_BYTES = BK * 2;    // one position's BK channels
  static constexpr int A_BYTES = CONV_BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * BK * 2;  // BN / 64 blocks of BK rows x 128 bytes
  static constexpr int OUT_BYTES = (PP ? 2 : 1) * CONV_BM * BN * 2;  // staged output tiles
  static constexpr int FIT = (230400 - OUT_BYTES) / (A_BYTES + B_BYTES);
  static constexpr int MAX_STAGES = FIT < CONV_MAX_STAGES ? FIT : CONV_MAX_STAGES;
  static_assert(MAX_STAGES >= 2, "ring of at least 2 stages in 227 KB");
};

struct ConvArgs {
  const float* bias;  // (Cout,) float32
  const float* bin;   // (Cin,) float32, relu_conv's input bias (RELU_IN only)
  int B, T, F, Cin, Cout;
  int tT, Fb;     // the tile: tT time rows x Fb bins
  int stages;     // ring depth
  int a_stage;    // bytes of a ring stage's A box (1024-aligned)
};

// shared memory of a launch: the ring's A boxes, its B tiles (or the resident
// weights), the staged output, the barriers, 1024 bytes of alignment
template <int BN, int BK, bool PP, bool RES>
int conv_smem(const ConvArgs& a) {
  using C = ConvTile<BN, BK, PP>;
  const int csteps = (a.Cin + BK - 1) / BK;
  const int b_region = RES ? 9 * csteps * C::B_BYTES : a.stages * C::B_BYTES;
  return a.stages * a.a_stage + b_region + C::OUT_BYTES + 8 * (2 * a.stages + 3) + 1024;
}

template <int BN, int BK, bool PP, bool RELU_IN, bool RES>
__global__ void __launch_bounds__(CONV_THREADS, 1)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap tma_x,
                  const __grid_constant__ CUtensorMap tma_w,
                  const __grid_constant__ CUtensorMap tma_out, const ConvArgs a) {
  using C = ConvTile<BN, BK, PP>;
  static_assert(!RELU_IN || (BK == 64 && !RES), "relu_conv transforms 128-byte rows");
  constexpr int ROWS = C::ROWS, HALVES = ROWS / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int S = a.stages;
  const int csteps = (a.Cin + BK - 1) / BK, ksteps = 9 * csteps;
  // ring stages per tile: one per (tap, channel step), or per (channel
  // step, df) in the resident form
  const int nsteps = RES ? 3 * csteps : ksteps;
  const uint32_t sA = base, sB = base + S * a.a_stage;
  const uint32_t sOut = sB + (RES ? ksteps : S) * C::B_BYTES;
  const uint32_t full = sOut + C::OUT_BYTES, empty = full + 8 * S;
  const uint32_t order = empty + 8 * S;  // ping-pong turns, one per warpgroup
  const uint32_t b_full = order + 16;    // the resident weights have landed
  const int wg = threadIdx.x / 128;
  const int nT = (a.T + a.tT - 1) / a.tT, nF = (a.F + a.Fb - 1) / a.Fb;
  const int m_tiles = a.B * nT * nF;
  const int tiles = m_tiles * ((a.Cout + BN - 1) / BN);
  const int rows = a.tT * a.Fb;

  // tile t: output channels n0.., image b, time rows t0.., bins f0..
  auto tile_at = [&](int t, int& n0, int& b, int& t0, int& f0) {
    n0 = t / m_tiles * BN;
    int m = t % m_tiles;
    f0 = m % nF * a.Fb;
    m /= nF;
    t0 = m % nT * a.tT;
    b = m / nT;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, PP ? 4 : 8);  // one arrival per consumer warp reading it
    }
    mbar_init(order, 4);
    mbar_init(order + 8, 4);
    mbar_init(b_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: the block's tiles in order, every (tap, channel step)
    // through the ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      if (RES && blockIdx.x < tiles) {  // every weight tile once, (tap, channel step) order
        mbar_expect_tx(b_full, ksteps * C::B_BYTES);
        for (int k = 0; k < ksteps; ++k)
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(sB + k * C::B_BYTES + j * BK * 128, &tma_w, 64 * j, k % csteps * BK,
                        k / csteps, b_full);
      }
      const uint32_t bytes = RES ? (a.tT + 2) * a.Fb * C::ROW_BYTES
                                 : rows * C::ROW_BYTES + C::B_BYTES;
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int n0, b, t0, f0;
        tile_at(t, n0, b, t0, f0);
        for (int ks = 0; ks < nsteps; ++ks) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, bytes);
          if (RES) {  // the (tT + 2) x Fb box of df = ks % 3 for the three dt
            tma_load_4d(sA + s * a.a_stage, &tma_x, ks / 3 * BK, f0 + ks % 3 - 1, t0 - 1, b,
                        full + 8 * s);
          } else {
            const int tap = ks / csteps, c0 = ks % csteps * BK;
            tma_load_4d(sA + s * a.a_stage, &tma_x, c0, f0 + tap % 3 - 1, t0 + tap / 3 - 1, b,
                        full + 8 * s);
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_3d(sB + s * C::B_BYTES + j * BK * 128, &tma_w, n0 + 64 * j, c0, tap,
                          full + 8 * s);
          }
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: cooperative, warpgroup wg takes rows 64 wg .. 64 wg + 63 of
    // every tile; ping-pong, all rows of the block's tiles wg, wg + 2, ...
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool leader = PP ? threadIdx.x % 128 == 0 : threadIdx.x == 0;
    const uint32_t stg = sOut + (PP ? wg * (C::OUT_BYTES / 2) : 0);
    const int row0 = PP ? 0 : wg * 64;  // the warpgroup's first row of a tile
    const int epi_bar = PP ? 1 + wg : 1, epi_threads = PP ? 128 : 256;
    float acc[HALVES][BN / 2];
    uint32_t order_ph = 0;
    if (RES) mbar_wait(b_full, 0);
    for (int i = PP ? wg : 0;; i += PP ? 2 : 1) {
      const int t = blockIdx.x + i * gridDim.x;
      if (t >= tiles) break;
      int n0, b, t0, f0;
      tile_at(t, n0, b, t0, f0);
      if (PP && i > 0) {  // the other warpgroup's previous mainloop is done
        mbar_wait(order + 8 * wg, order_ph);
        order_ph ^= 1;
      }
      const int p0 = i * nsteps;  // ring position of the tile's first stage
      int s = p0 % S, prev = -1;
      uint32_t ph = (p0 / S) & 1;
      for (int ks = 0; ks < nsteps; ++ks) {
        mbar_wait(full + 8 * s, ph);
        const uint32_t at = sA + s * a.a_stage;
        if constexpr (RELU_IN) {
          // relu(x + b1) in place over this warpgroup's rows, 16 bytes (8
          // channels) a piece; pieces whose tap position lies outside the
          // image, or whose channels lie past Cin, keep TMA's zeros
          const int tap = ks / csteps, c0 = ks % csteps * BK;
#pragma unroll
          for (int k = 0; k < ROWS / 16; ++k) {
            const int q = threadIdx.x % 128 + 128 * k;
            const int r = row0 + q / 8, piece = q % 8, c = c0 + 8 * piece;
            const int tt = t0 + r / a.Fb + tap / 3 - 1, ff = f0 + r % a.Fb + tap % 3 - 1;
            if (r >= rows || c >= a.Cin || tt < 0 || tt >= a.T || ff < 0 || ff >= a.F) continue;
            const uint32_t p = at + r * 128 + ((piece ^ (r % 8)) * 16);
            uint32_t v[4];
            asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                         : "r"(p));
            const float4 b0 = *reinterpret_cast<const float4*>(a.bin + c);
            const float4 b1 = *reinterpret_cast<const float4*>(a.bin + c + 4);
            const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v[e]);
              v[e] = pack_bf16(fmaxf(__bfloat162float(h.x) + bb[2 * e], 0.f),
                               fmaxf(__bfloat162float(h.y) + bb[2 * e + 1], 0.f));
            }
            asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(p), "r"(v[0]),
                         "r"(v[1]), "r"(v[2]), "r"(v[3]));
          }
          fence_async_shared();
          named_barrier(3 + wg, 128);
        }
        wgmma_fence();
        // the taps of this stage: (dt, ks % 3) of channel step ks / 3 from
        // one box in the resident form, else one; per tap, A from its rows
        // (64 h further per half, +32 bytes per k16) and B from its tile (+16
        // rows per k16)
#pragma unroll
        for (int dt = 0; dt < (RES ? 3 : 1); ++dt) {
          const uint32_t a_rows = at + (row0 + (RES ? dt * a.Fb : 0)) * C::ROW_BYTES;
          const uint32_t b_tile = RES ? sB + ((3 * dt + ks % 3) * csteps + ks / 3) * C::B_BYTES
                                      : sB + s * C::B_BYTES;
          const uint64_t da = BK == 64 ? desc_sw128(a_rows) : desc_sw32(a_rows);
          const uint64_t db = desc_sw128_mn(b_tile, BK * 128);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int h = 0; h < HALVES; ++h)
              wgmma_ss<BN, 1>(acc[h], da + (64 * C::ROW_BYTES >> 4) * h + 2 * kk,
                              db + 128 * kk, ks > 0 || dt > 0 || kk > 0);
        }
        wgmma_commit();
        // the group before this one has retired: its stage is free
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < HALVES; ++h) fence_regs(acc[h]);
      if (lane == 0) {
        mbar_arrive(empty + 8 * prev);
        if (PP) mbar_arrive(order + 8 * (1 - wg));  // the other warpgroup's turn
      }

      // epilogue: once the previous tile's store has read the staging tile
      if (leader) bulk_wait_read();
      named_barrier(epi_bar, epi_threads);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float2 bv = n0 + c < a.Cout ? *reinterpret_cast<const float2*>(a.bias + n0 + c)
                                          : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row0 + h * 64 + warp * 16 + lane / 4 + 8 * half;
            const float v0 = fmaxf(acc[h][4 * j + 2 * half] + bv.x, 0.f);
            const float v1 = fmaxf(acc[h][4 * j + 2 * half + 1] + bv.y, 0.f);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stg + staged<CONV_BM>(r, c)),
                         "r"(pack_bf16(v0, v1)));
          }
      }
      fence_async_shared();
      named_barrier(epi_bar, epi_threads);
      if (leader) {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_store_4d(&tma_out, stg + j * CONV_BM * 128, n0 + 64 * j, f0, t0, b);
        bulk_commit();
      }
    }
    if (leader) bulk_wait();
  }
}

// NHWC (B, T, F, C) bf16 as a 4-D map (C, F, T, B) read or written in boxes
// of (box_c, Fb, tT, 1)
cudaError_t nhwc_map(CUtensorMap* map, const bf16* t, const ConvArgs& a, int C, int box_c,
                     CUtensorMapSwizzle swizzle) {
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)a.F, (uint64_t)a.T, (uint64_t)a.B};
  const uint64_t row = (uint64_t)C * sizeof(bf16);
  const uint64_t strides[3] = {row, row * a.F, row * a.F * a.T};
  const uint32_t box[4] = {(uint32_t)box_c, (uint32_t)a.Fb, (uint32_t)a.tT, 1};
  return make_tmap(map, t, 4, dims, strides, box, swizzle);
}

template <int BN, int BK, bool PP, bool RELU_IN, bool RES>
cudaError_t launch_conv(const bf16* x, const bf16* w, bf16* out, const ConvArgs& a,
                        cudaStream_t stream) {
  CUtensorMap tx, tw, to;
  ConvArgs r = a;
  r.tT = RES ? a.tT + 2 : a.tT;  // the resident form's x boxes hold the halo rows
  cudaError_t e = nhwc_map(&tx, x, r, a.Cin, BK,
                           BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == cudaSuccess) {
    // HWIO as (Cout, Cin, 9): boxes of 64 output channels x BK input channels of one tap
    const uint64_t dims[3] = {(uint64_t)a.Cout, (uint64_t)a.Cin, 9};
    const uint64_t strides[2] = {(uint64_t)a.Cout * sizeof(bf16),
                                 (uint64_t)a.Cout * a.Cin * sizeof(bf16)};
    const uint32_t box[3] = {64, (uint32_t)BK, 1};
    e = make_tmap(&tw, w, 3, dims, strides, box);
  }
  if (e == cudaSuccess) e = nhwc_map(&to, out, a, a.Cout, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  auto kernel = conv3x3_wgmma<BN, BK, PP, RELU_IN, RES>;
  const int smem = conv_smem<BN, BK, PP, RES>(a);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // persistent: one block per SM, or one per tile
  const long tiles = (long)a.B * ((a.T + a.tT - 1) / a.tT) * ((a.F + a.Fb - 1) / a.Fb) *
                     ((a.Cout + BN - 1) / BN);
  const int grid = tiles < sm_count() ? (int)tiles : sm_count();
  kernel<<<grid, CONV_THREADS, smem, stream>>>(tx, tw, to, a);
  return cudaGetLastError();
}

// One conv on tile form (BN, BK, PP): the resident form where `resident`
// allows it and it fits (one weight panel, Fb % 8 == 0, three stages of
// (tT + 2) Fb rows beside the weights), else the ring of (tap, channel
// step) stages, `a.stages` deep at most (0: as deep as shared memory allows)
template <int BN, int BK, bool PP, bool RELU_IN>
cudaError_t conv_form(bool resident, const bf16* x, const bf16* w, bf16* out, ConvArgs a,
                      cudaStream_t stream) {
  using C = ConvTile<BN, BK, PP>;
  const int want = a.stages == 0 || a.stages > CONV_MAX_STAGES ? CONV_MAX_STAGES : a.stages;
  if constexpr (!RELU_IN && BN == 64) {
    if (resident && a.Cout <= BN && a.Fb % 8 == 0) {
      const int bytes = (a.tT + 2) * a.Fb * C::ROW_BYTES;
      a.a_stage = (bytes + 1023) / 1024 * 1024;
      a.stages = 1;
      const int fit = (230400 - conv_smem<BN, BK, PP, true>(a) + a.a_stage) / a.a_stage;
      if (fit >= 3) {
        a.stages = fit < want ? fit : want;
        return launch_conv<BN, BK, PP, false, true>(x, w, out, a, stream);
      }
    }
  }
  a.a_stage = C::A_BYTES;
  a.stages = C::MAX_STAGES < want ? C::MAX_STAGES : want;
  if (a.stages < 2) return cudaErrorInvalidValue;
  return launch_conv<BN, BK, PP, RELU_IN, false>(x, w, out, a, stream);
}

// One conv with the tile chosen at run time: bn 64, 128, 192, 256
// cooperative, -64 or -128 ping-pong; bk 64, or 16 (not with relu_in)
cudaError_t conv(int bn, int bk, bool relu_in, bool resident, const bf16* x, const bf16* w,
                 bf16* out, const ConvArgs& a, cudaStream_t stream) {
  if (bk == 16 && !relu_in) {
    switch (bn) {
      case 64: return conv_form<64, 16, false, false>(resident, x, w, out, a, stream);
      case -64: return conv_form<64, 16, true, false>(resident, x, w, out, a, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (bk != 64) return cudaErrorInvalidValue;
#define K7_TILES(RELU)                                                                    \
  switch (bn) {                                                                           \
    case 64: return conv_form<64, 64, false, RELU>(resident, x, w, out, a, stream);       \
    case 128: return conv_form<128, 64, false, RELU>(resident, x, w, out, a, stream);     \
    case 192: return conv_form<192, 64, false, RELU>(resident, x, w, out, a, stream);     \
    case 256: return conv_form<256, 64, false, RELU>(resident, x, w, out, a, stream);     \
    case -64: return conv_form<64, 64, true, RELU>(resident, x, w, out, a, stream);       \
    case -128: return conv_form<128, 64, true, RELU>(resident, x, w, out, a, stream);     \
    default: return cudaErrorInvalidValue;                                                \
  }
  if (relu_in) K7_TILES(true)
  K7_TILES(false)
#undef K7_TILES
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One ConvBlock call. mode 0 (single): out = relu(conv(x, w1) + b1), Cout =
// cout. mode 1 (pair): mid (B, T, F, cmid) = relu(conv(x, w1) + b1), out =
// relu(conv(mid, w2) + b2). mode 2 (relu_conv): out = relu(conv(relu(x +
// b1), w2) + b2), cmid = cin. x (B, T, F, cin) bf16; weights contiguous HWIO
// bf16; biases float32; every tensor 16-byte aligned. Tiles of tT x Fb
// positions (tT Fb <= 128); conv1 on tile (bn1, bk1), conv2 (bn2, bk2);
// `stages` the ring depth, at most (and for 0) as deep as shared memory
// allows; `resident` lets a conv take the resident form where it fits.
// Needs every channel count % 8 == 0.
extern "C" int conv_block_forward(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                                  const float* b2, bf16* mid, bf16* out, int mode, int B, int T,
                                  int F, int cin, int cmid, int cout, int tT, int Fb, int bn1,
                                  int bk1, int bn2, int bk2, int stages, int resident,
                                  cudaStream_t stream) {
  if (B < 1 || T < 1 || F < 1 || cin < 8 || cin % 8 || cout < 8 || cout % 8 || mode < 0 ||
      mode > 2 || (mode == 1 && (cmid < 8 || cmid % 8 || !mid)) || (mode != 2 && !w1) ||
      (mode != 0 && (!w2 || !b2)) || tT < 1 || Fb < 1 || tT * Fb > CONV_BM || Fb > 256 ||
      stages < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long Ml = (long)B * T * F;
  if (Ml * (cin > cout ? cin : cout) >= (1L << 31) || (mode == 1 && Ml * cmid >= (1L << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool res = resident != 0;
  const ConvArgs a{b1, nullptr, B, T, F, cin, mode == 0 ? cout : cmid, tT, Fb, stages, 0};
  cudaError_t e;
  if (mode == 0) {
    e = conv(bn1, bk1, false, res, x, w1, out, a, stream);
  } else if (mode == 1) {
    e = conv(bn1, bk1, false, res, x, w1, mid, a, stream);
    const ConvArgs a2{b2, nullptr, B, T, F, cmid, cout, tT, Fb, stages, 0};
    if (e == cudaSuccess) e = conv(bn2, bk2, false, res, mid, w2, out, a2, stream);
  } else {
    const ConvArgs a2{b2, b1, B, T, F, cin, cout, tT, Fb, stages, 0};
    e = conv(bn2, bk2, true, res, x, w2, out, a2, stream);
  }
  return static_cast<int>(e);
}
