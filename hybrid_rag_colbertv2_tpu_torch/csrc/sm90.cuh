// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// mbarriers, bulk asynchronous and tensor (TMA) copies, proxy fences,
// wgmma shared-memory descriptors and the register-A wgmma products,
// register reallocation.
// Thin wrappers over PTX, one instruction each (PTX ISA 8.x,
// "Asynchronous operations", "mbarrier", "wgmma"); and what the wgmma
// scans share besides: an uncached load, the exact int8 -> bf16
// conversion.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// Makes initialised mbarriers visible to the async proxy and other threads.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of bulk-copy transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// True once the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Blocks until the phase of parity `parity` has completed. A fresh barrier
// counts its (virtual) previous phase, parity 1, as completed. The waiting
// thread is suspended (up to the time hint, in ns) rather than spinning, so
// it leaves the issue slots to the warps that work.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity), "r"(0x989680u)
        : "memory");
  } while (!done);
}

// -- copies and fences -------------------------------------------------------

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into this block's shared memory, completing on `bar` as
// transaction bytes.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One box of the 2-D tensor that the tensor map `map` describes (in
// parameter, constant or global memory), at element coordinates (x, y),
// innermost first, into this block's shared memory, completing on `bar`
// as transaction bytes: the whole box, its out-of-bounds elements (filled
// with zeros) included.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// Brings a tensor map into the cache ahead of its first copy.
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones: its writes before wgmma reads them, its reads before a
// bulk copy overwrites them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- register reallocation (whole warpgroup, multiples of 8 in [24, 256]) ----

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- wgmma -------------------------------------------------------------------

// Descriptor of a K-major bf16 operand in 128-byte-swizzle layout: rows of
// 64 elements (128 bytes) whose 16-byte pieces sit at piece ^ (row % 8),
// 8-row atoms of 1024 bytes one after another (stride byte offset 1024),
// each atom 1024-byte aligned. A k-step's operand starts k * 32 bytes into
// the row; the hardware applies the swizzle to the absolute address.
__device__ __forceinline__ uint64_t desc_k_sw128(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

// Byte offset of 16-byte piece `piece` (0..7) of row `row` in that layout.
__device__ __forceinline__ uint32_t sw128_offset(int row, int piece) {
  return static_cast<uint32_t>(row * 128 + ((piece ^ (row & 7)) << 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator register across
// the asynchronous product that writes it.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d(64 x 64, fp32) (+)= a(64 x 16, bf16, registers) * b(16 x 64, bf16,
// K-major in shared memory, descriptor `b`); `accumulate` 0 overwrites d.
// Fragments (warp w of the warpgroup, lane = 4 g + t):
//   a[0] = A[16w + g][2t, 2t+1]     a[1] = A[16w + g + 8][2t, 2t+1]
//   a[2] = A[16w + g][2t+8, 2t+9]   a[3] = A[16w + g + 8][2t+8, 2t+9]
//   d[4j + 2h + e] = D[16w + g + 8h][8j + 2t + e]
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(0), "r"(accumulate));
}

// -- shared by the scans -----------------------------------------------------

// A load the compiler may not hoist out of its branch: `out` is read only
// when a later column segment adds to it, and a speculated read would put a
// device-memory round trip on every doc.
__device__ __forceinline__ float load_volatile(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// x - y on bf16 pairs, as one bf16x2 FMA (y * -1 + x); exact where the
// difference is representable.
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(y), "r"(0xBF80BF80u), "r"(x));
  return r;
}

// Four int8 (one word, lowest byte first) -> four bf16, exact. A byte
// permute sets 0x43 above each byte's low 7 bits r, the bf16 128 + r, and
// above its sign bit alone, the bf16 128 (s >= 0) or 256 (s < 0); their
// difference is s (r or r - 128, two's complement), |s| <= 128.
__device__ __forceinline__ uint2 s8x4_to_bf16x4(uint32_t w) {
  const uint32_t low = w & 0x7F7F7F7Fu, sign = w & 0x80808080u;
  return make_uint2(bf16x2_sub(__byte_perm(low, 0x43434343u, 0x4140),
                               __byte_perm(sign, 0x43434343u, 0x4140)),
                    bf16x2_sub(__byte_perm(low, 0x43434343u, 0x4342),
                               __byte_perm(sign, 0x43434343u, 0x4342)));
}

}  // namespace sm90
