// The Hopper GEMM core: TMA-fed, mbarrier-ringed, warp-specialised wgmma
// for sm_90a, as raw PTX (no CUTLASS), and the primitives it is built from.
// Used by K6 (vit_block.cu: its four GEMMs, and the same primitives in its
// attention), K7 (conv_block.cu: its implicit-GEMM mainloop is written
// beside this one on the same primitives, with 4-D TMA boxes per tap and
// the weights as a transposed B), K3/K5 (swin_bwd_sm90.cuh: the Swin
// block backward's GEMM forms, transposed A included, and wgmma attention)
// and K9/K10 (frontend_common.cuh: split-TF32 wgmma with A from registers
// and float32 TMA boxes).
//
//   C (M, N) = A (M, K) . B (N, K)^T     A, B bf16 K-major, float32 sums
//
// with one of three epilogues applied to the float32 sums: bias then
// round; bias, round, + a bf16 residual, round; bias, exact erf GELU, round.
// B in (N, K) is nn.Linear's own (out, in) weight layout, wgmma's "TN" form:
// neither operand is transposed.
//
// What bounds it: at the PaSST block's shapes (M = 19264, K = 768 or 3072)
// the tensor-core rate; a 128 x 128 tile with K = 768 reads 0.016 bytes of
// L2 a FLOP, and its epilogue writes 32 KB, so the per-tile epilogue and
// the load ring are what keep it from that rate.
//
// Design: one persistent block of 384 threads per SM walks the output tiles
// (consecutive tiles share A's row block, so B, the weights, stays in L2).
// Warpgroup 2 is the producer: one thread issues cp.async.bulk.tensor loads
// of A (128 x 64) and B (BN x 64), 128-byte swizzled, into a ring of stages
// with a full and an empty mbarrier each, and the warpgroup gives registers
// up (setmaxnreg 40). Warpgroups 0 and 1 are the consumers (setmaxnreg 232),
// in one of two schedules (chosen per GEMM by scripts/torch_k6_tiles.py):
//  * cooperative: a 128 x BN tile (BN 128, 192, 256), each warpgroup
//    running wgmma m64nBNk16 on its 64-row half;
//  * ping-pong: each warpgroup owns every other 128 x 128 tile (two
//    m64n128k16 per k-step), the two mainloops in turns, so one
//    warpgroup's epilogue runs under the other's mainloop.
// A consumer keeps one commit group in flight and frees a stage when the
// group that read it has retired. The epilogue writes the rounded tile into
// a 128-byte-swizzled staging buffer in shared memory (conflict-free) and
// one thread stores it with TMA (rows and columns past the edge are not
// written; loads past M, N and K arrive as zeros); the residual is
// TMA-loaded into that buffer while the mainloop runs.
//
// TMA descriptors (CUtensorMap) are host objects: they are encoded on every
// launch with cuTensorMapEncodeTiled, found through the runtime's driver
// entry point (no -lcuda), and passed as __grid_constant__ parameters. They
// hold raw addresses, so they are never cached across calls. They need
// 16-byte aligned base addresses and row strides (K % 8 == 0).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// device primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival, announcing the bytes its TMA loads will bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// a 2-D box from shared memory to global (rows and columns past the edges
// are not written), tracked by the thread's bulk groups
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// order this thread's shared-memory writes before later TMA (async proxy)
// reads of them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1-15) over `n` threads, here one warpgroup
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a tile stored as rows of 64 bf16 (128
// bytes) with TMA's 128-byte swizzle, based on a 1024-byte boundary: 8-row
// groups 1024 bytes apart (SBO), LBO unused, layout type 1 (B128). Used for
// K-major operands, and for an MN-major B of 64 columns (V: rows are keys).
// Moving 16 along K within a row is +32 bytes on the address; 16 rows
// further is +2048.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// the same for an MN-major operand wider than 64 (wgmma's transposed B):
// 64-column blocks of rows of 128 bytes, `lbo` bytes apart (LBO), 8-row
// groups 1024 bytes apart (SBO)
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// K-major rows of 16 bf16 (32 bytes) with TMA's 32-byte swizzle, based on a
// 256-byte boundary: 8-row groups 256 bytes apart (SBO), layout type 3
// (B32); one k16 slice is the whole row
__device__ __forceinline__ uint64_t desc_sw32(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (static_cast<uint64_t>(3) << 62);
}

// D (64 x N) = A . B (+ D), A 64 x 16 bf16 from registers (four pairs: rows
// l / 4 and + 8, columns 2 (l % 4) and + 8, as mma.sync's A fragment), B
// 16 x N from shared memory MN-major (transposed).
template <int N>
__device__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);

// D (64 x N float32; N / 2 registers a thread) = A . B^T (+ D when scale_d),
// A 64 x 16 and B N x 16 from shared memory, both K-major; with TB = 1, B is
// 16 x N MN-major (wgmma's transpose bit) and D = A . B; with TA = 1, A is
// MN-major (16 x 64 stored, D = A^T ...). Accumulator layout (warp w of the
// warpgroup, lane l, register i): row 16 w + l / 4 + 8 ((i % 4) / 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2.
template <int N, int TB = 0, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 192 || N == 256, "wgmma_ss widths");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %20, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %100, %99;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %132, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
  }
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// D (64 x N float32) = A . B^T (+ D), A 64 x 8 tf32 from registers (rows
// l / 4 and + 8 of the warp's 16, columns l % 4 and + 4: a[0] (r, c), a[1]
// (r + 8, c), a[2] (r, c + 4), a[3] (r + 8, c + 4), as mma.sync's tf32 A
// fragment), B N x 8 tf32 from shared memory K-major (tf32 takes no
// transpose). The tensor core reads the top 19 bits of each register: an
// operand not already rounded to tf32 is truncated. Used by K9 and K10
// (frontend_common.cuh) in split-TF32 products.
template <int N>
__device__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                              int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// x rounded to tf32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as a 32-bit pattern whose low 13 bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// the split-TF32 operand: hi = tf32(x), lo = tf32(x - hi); hi + lo is x
// within 2^-22 of |x|
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 tensor (or `dtype`) of `rank` dims (innermost first, dims[0]
// contiguous) with byte strides of the outer dims, read in boxes of `box`
// elements with the 128-byte swizzle (box[0] = 64 bf16; or `swizzle`, box[0]
// at most its width) and zeros past every edge, negative coordinates included
inline cudaError_t make_tmap(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                             const uint64_t* strides, const uint32_t* box,
                             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B,
                             CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorMisalignedAddress;
  for (int i = 0; i < rank - 1; ++i)
    if (strides[i] % 16) return cudaErrorInvalidPitchValue;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i < rank - 1) s[i] = strides[i];
  }
  const CUresult r = fn(map, dtype, rank, const_cast<void*>(base), d, s,
                        b, e, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row-major (rows, cols) bf16 matrix read in boxes of box_rows x 64
inline cudaError_t make_tmap_2d(CUtensorMap* map, const bf16* base, int rows, int cols,
                                int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * sizeof(bf16)};
  const uint32_t box[2] = {64, static_cast<uint32_t>(box_rows)};
  return make_tmap(map, base, 2, dims, strides, box);
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// ---------------------------------------------------------------------------
// the GEMM

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_RESID = 1, EPI_BIAS_GELU = 2 };

constexpr int GEMM_BM = 128;  // two consumer warpgroups of 64 rows
constexpr int GEMM_BK = 64;   // one 128-byte swizzle row of bf16
constexpr int GEMM_THREADS = 384;
// registers a thread after setmaxnreg (producer 40, consumers 232), from the
// block's own pool: at most 168 a thread at launch, one block per SM
static_assert(40 * 128 + 232 * 256 <= 168 * GEMM_THREADS,
              "setmaxnreg within the block's registers");

struct GemmArgs {
  const float* bias;  // (N,) float32
  const bf16* resid;  // (M, N) bf16, EPI_BIAS_RESID only
  bf16* out;          // (M, N) bf16
  int M, N, K;
};

// PP (ping-pong): each consumer warpgroup owns whole 128 x BN tiles, taking
// every other tile of the block, and the two run their mainloops in turn
// (an order barrier each), so one warpgroup's epilogue overlaps the other's
// mainloop (BN 128 only: 128 accumulators a thread). The turns also keep a
// warpgroup from waiting on a stage whose earlier fill, meant for the other
// warpgroup, is still outstanding: the full barrier's parity would not tell
// the two fills apart. Otherwise the two warpgroups share each tile, 64 rows
// each (cooperative).
template <int BN, bool PP>
struct GemmTile {
  static_assert(!PP || BN == 128, "ping-pong holds a 128 x 128 tile per warpgroup");
  static constexpr int ROWS = PP ? 128 : 64;  // output rows a warpgroup owns per tile
  static constexpr int A_BYTES = GEMM_BM * GEMM_BK * 2;
  static constexpr int B_BYTES = BN * GEMM_BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = 2 * ROWS * BN * 2;  // both warpgroups' staged outputs
  // cooperative 6, 4, 3 for BN 128, 192, 256; ping-pong 5
  static constexpr int STAGES = (230400 - OUT_BYTES) / STAGE;
  static constexpr int SMEM = STAGES * STAGE + OUT_BYTES + 8 * (2 * STAGES + 4) + 1024;
  static_assert(STAGES >= 3 && SMEM <= 232448, "ring of at least 3 stages in 227 KB");
};

// byte offset of output element (r, c) of a warpgroup's ROWS x BN staging
// tile: BN / 64 boxes of ROWS x 64, rows of 128 bytes in TMA's 128-byte
// swizzle (16-byte chunk index XOR row % 8)
template <int ROWS>
__device__ __forceinline__ uint32_t staged(int r, int c) {
  return (c / 64) * (ROWS * 128) + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
}

// Epilogue: each consumer warpgroup writes its ROWS x BN tile, bias (+ GELU)
// applied and rounded, into its staging buffer in shared memory, and one
// thread stores it with TMA while the warpgroup goes on to the next tile.
// For the residual form the residual tile is TMA-loaded into the same buffer
// at the start of the tile (once the previous tile's store has read it),
// and each thread adds it in place.
template <int BN, int EPI, bool PP>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    sm90_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b,
                     const __grid_constant__ CUtensorMap tma_out,
                     const __grid_constant__ CUtensorMap tma_res, const GemmArgs g) {
  using T = GemmTile<BN, PP>;
  constexpr int ROWS = T::ROWS, HALVES = ROWS / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sA = base, sB = base + T::STAGES * T::A_BYTES;
  const uint32_t sOut = base + T::STAGES * T::STAGE;
  const uint32_t full = sOut + T::OUT_BYTES, empty = full + 8 * T::STAGES;
  const uint32_t res_full = empty + 8 * T::STAGES;  // one per consumer warpgroup
  const uint32_t order = res_full + 16;              // ping-pong turns, one per warpgroup
  const int wg = threadIdx.x / 128;
  const int tiles_n = (g.N + BN - 1) / BN;
  const int tiles = (g.M + GEMM_BM - 1) / GEMM_BM * tiles_n;
  const int kblocks = (g.K + GEMM_BK - 1) / GEMM_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, PP ? 4 : 8);  // one arrival per consumer warp reading it
    }
    mbar_init(res_full, 1);
    mbar_init(res_full + 8, 1);
    mbar_init(order, 4);
    mbar_init(order + 8, 4);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: the block's tiles in order, every k-block through the ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * GEMM_BM, n0 = t % tiles_n * BN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, T::STAGE);
          tma_load_2d(sA + s * T::A_BYTES, &tma_a, kb * GEMM_BK, m0, full + 8 * s);
          tma_load_2d(sB + s * T::B_BYTES, &tma_b, kb * GEMM_BK, n0, full + 8 * s);
          if (++s == T::STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: cooperative, warpgroup wg takes rows 64 wg .. 64 wg + 63 of
    // every tile; ping-pong, it takes all rows of the block's tiles wg, wg +
    // 2, ... (their k-blocks sit at ring positions tile * kblocks + kb)
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    const uint32_t stg = sOut + wg * (T::OUT_BYTES / 2), res_bar = res_full + 8 * wg;
    float acc[HALVES][BN / 2];
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
    uint32_t res_ph = 0, order_ph = 0;
    for (int i = PP ? wg : 0;; i += PP ? 2 : 1) {
      const int t = blockIdx.x + i * gridDim.x;
      if (t >= tiles) break;
      const int m0 = t / tiles_n * GEMM_BM, n0 = t % tiles_n * BN;
      const int row0 = m0 + (PP ? 0 : wg * 64);  // the warpgroup's first output row
      if (EPI == EPI_BIAS_RESID && leader) {
        bulk_wait_read();  // the previous tile's store has read the buffer
        mbar_expect_tx(res_bar, T::OUT_BYTES / 2);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(stg + b * ROWS * 128, &tma_res, n0 + 64 * b, row0, res_bar);
      }
      if (PP && i > 0) {  // the other warpgroup's previous mainloop is done
        mbar_wait(order + 8 * wg, order_ph);
        order_ph ^= 1;
      }
      const int p0 = i * kblocks;  // ring position of the tile's first k-block
      int s = p0 % T::STAGES, prev = -1;
      uint32_t ph = (p0 / T::STAGES) & 1;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(full + 8 * s, ph);
        const uint64_t da = desc_sw128(sA + s * T::A_BYTES + (PP ? 0 : wg) * 64 * 128);
        const uint64_t db = desc_sw128(sB + s * T::B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GEMM_BK / 16; ++kk)
#pragma unroll
          for (int h = 0; h < HALVES; ++h)  // rows 64 h .. 64 h + 63: 8192 bytes further
            wgmma_ss<BN>(acc[h], da + 512 * h + 2 * kk, db + 2 * kk, kb > 0 || kk > 0);
        wgmma_commit();
        // the group before this one has retired: its stage is free
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == T::STAGES) {
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

      // epilogue: the staging buffer is free (or holds the residual)
      if (EPI == EPI_BIAS_RESID) {
        mbar_wait(res_bar, res_ph);
        res_ph ^= 1;
      } else {
        if (leader) bulk_wait_read();
        named_barrier(1 + wg, 128);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float2 b = n0 + c < g.N ? *reinterpret_cast<const float2*>(g.bias + n0 + c)
                                      : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t at = stg + staged<ROWS>(h * 64 + warp * 16 + lane / 4 + 8 * half, c);
            float v0 = acc[h][4 * j + 2 * half] + b.x, v1 = acc[h][4 * j + 2 * half + 1] + b.y;
            if (EPI == EPI_BIAS_GELU) {
              v0 = gelu_erf(v0);
              v1 = gelu_erf(v1);
            } else if (EPI == EPI_BIAS_RESID) {
              uint32_t rv;
              asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(rv) : "r"(at));
              const __nv_bfloat162 r = *reinterpret_cast<__nv_bfloat162*>(&rv);
              v0 = __bfloat162float(__float2bfloat16_rn(v0)) + __bfloat162float(r.x);
              v1 = __bfloat162float(__float2bfloat16_rn(v1)) + __bfloat162float(r.y);
            }
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(v0, v1)));
          }
      }
      fence_async_shared();
      named_barrier(1 + wg, 128);
      if (leader) {
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_store_2d(&tma_out, stg + b * ROWS * 128, n0 + 64 * b, row0);
        bulk_commit();
      }
    }
    if (leader) bulk_wait();
  }
}

// C = A . B^T with epilogue EPI on the stream: A (M, K), B (N, K), the
// output and the residual (M, N) bf16, row-major; needs K % 8 == 0 and N % 8
// == 0 (16-byte strides) and 16-byte aligned matrices
template <int BN, int EPI, bool PP>
cudaError_t sm90_gemm(const bf16* A, const bf16* Bw, const GemmArgs& g, cudaStream_t stream) {
  using T = GemmTile<BN, PP>;
  if (g.M < 1 || g.N < 1 || g.K < 1 || g.N % 8 || g.K % 8) return cudaErrorInvalidValue;
  CUtensorMap ta, tb, to, tr;
  cudaError_t e = make_tmap_2d(&ta, A, g.M, g.K, GEMM_BM);
  if (e == cudaSuccess) e = make_tmap_2d(&tb, Bw, g.N, g.K, BN);
  if (e == cudaSuccess) e = make_tmap_2d(&to, g.out, g.M, g.N, T::ROWS);
  if (e == cudaSuccess)
    e = make_tmap_2d(&tr, EPI == EPI_BIAS_RESID ? g.resid : g.out, g.M, g.N, T::ROWS);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(sm90_gemm_kernel<BN, EPI, PP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  // persistent: one block per SM, or one per tile
  const int tiles = (g.M + GEMM_BM - 1) / GEMM_BM * ((g.N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  sm90_gemm_kernel<BN, EPI, PP><<<grid, GEMM_THREADS, T::SMEM, stream>>>(ta, tb, to, tr, g);
  return cudaGetLastError();
}

// the same with the tile chosen at run time: BN 128, 192 or 256
// cooperative, or 128 ping-pong (bn = -128)
template <int EPI>
cudaError_t sm90_gemm_bn(int bn, const bf16* A, const bf16* Bw, const GemmArgs& g,
                         cudaStream_t stream) {
  switch (bn) {
    case 128: return sm90_gemm<128, EPI, false>(A, Bw, g, stream);
    case 192: return sm90_gemm<192, EPI, false>(A, Bw, g, stream);
    case 256: return sm90_gemm<256, EPI, false>(A, Bw, g, stream);
    case -128: return sm90_gemm<128, EPI, true>(A, Bw, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
