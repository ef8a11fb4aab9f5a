// Hopper building blocks for warp-specialised kernels: mbarriers (init,
// arrive, arrive with an expected byte count, a parity wait that traps
// instead of hanging), asynchronous bulk copies into shared memory (TMA
// tensor tiles through a CUtensorMap, and plain contiguous pieces), wgmma
// matrix descriptors, fences, commit and wait, and the host-side lookup of
// the driver's tensor-map encoder.
//
// wgmma descriptors here use no swizzle. A K-major operand is then built of
// core matrices of 8 rows x 16 bytes, the 8 rows 16 bytes apart (128
// contiguous bytes); LBO is the byte distance between the two core matrices
// of a k16 step (along K), SBO the distance between 8-row groups (along M
// or N).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing is linked)
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"  // smem_u32

namespace organseg {

// A wait on one mbarrier phase that lasts this long is a broken ring (a
// wrong parity or byte count): trap, so the launch fails instead of hanging.
constexpr unsigned long long kHangNs = 4000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// asynchronous proxy (TMA); a __syncthreads() follows it.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// One arrival that also expects `bytes` of asynchronous copies to land.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kHangNs) __trap();
}

// TMA: one box of a rank-5 tensor map into shared memory (128-byte aligned),
// completing `bar`'s transaction count. Boxes that reach outside the tensor
// (negative coordinates too) are filled with zeros.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// A contiguous piece of global memory into shared memory; source,
// destination and size are multiples of 16 bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, no swizzle (layout type 0, base offset 0).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most `kPending` committed wgmma groups of this warpgroup
// are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence, commit or wait.
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64x48] (+)= A[64x16] . B[16x48], bf16 in, f32 accumulate, A and B
// K-major in shared memory. scale_d = 0 overwrites D.
// Accumulator layout (warp w of the warpgroup, lane l, g = l/4, q = l%4):
// d[4j], d[4j+1] are row 16w+g, columns 8j+2q, 8j+2q+1; d[4j+2], d[4j+3]
// the same columns of row 16w+g+8.
__device__ __forceinline__ void wgmma_m64n48k16(float (&d)[24], uint64_t a, uint64_t b,
                                                uint32_t scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The driver's cuTensorMapEncodeTiled, fetched through the runtime, so the
// library links only the runtime. Returns nullptr if the driver lacks it.
using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                          const cuuint32_t*, CUtensorMapInterleave,
                                          CUtensorMapSwizzle, CUtensorMapL2promotion,
                                          CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

}  // namespace organseg
