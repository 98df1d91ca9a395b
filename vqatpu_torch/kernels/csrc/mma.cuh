// bf16 tensor-core products with f32 accumulators (mma.sync, sm_80 and
// later), shared by the bf16-operand instances of rank_softmax.cu and
// tri_pool.cu and by tri_pool_backward.cu: fragments loaded from shared
// memory by ldmatrix, one m16n8k16 product a call, and split_bf16x3, which
// makes a float32 operand three bf16 ones.  Also the tensor-map copies (TMA, sm_90) that
// feed rank_softmax.cu's and linear_f32.cu's rings: one thread asks for a
// whole box, and the copy reports its bytes to an mbarrier in shared memory.
//
// Fragments of mma.sync.m16n8k16.row.col (lane = 4 * group + tig):
//   A (16 x 16, row-major): a0 rows group, k 2*tig..+1; a1 rows group+8;
//     a2 and a3 the same at k + 8.
//   B (16 x 8, k-major per column): b0 k 2*tig..+1 of column group; b1 at
//     k + 8.  The lower 16 bits of a register hold the lower k.
//   C (16 x 8, f32): c0, c1 row group, columns 2*tig, 2*tig+1; c2, c3
//     row group+8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// w = w0 + w1 + w2, each bf16 rounded to nearest from what the terms
// before it leave: every bf16 x bf16 product is exact in f32, so three
// products give w * x to f32 accuracy
__device__ __forceinline__ void split_bf16x3(float w, __nv_bfloat16& w0, __nv_bfloat16& w1,
                                             __nv_bfloat16& w2) {
  w0 = __float2bfloat16_rn(w);
  const float r = w - __bfloat162float(w0);
  w1 = __float2bfloat16_rn(r);
  w2 = __float2bfloat16_rn(r - __bfloat162float(w1));
}

// A generic pointer into shared memory as the 32-bit address that
// ldmatrix takes: a per-thread base plus constant offsets folds into the
// instruction, where each generic address would hold a register.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lanes 8m..8m+7 give the 16-byte rows of matrix m.
// Lane l receives row l/4, elements 2*(l%4) and 2*(l%4)+1, of each.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  ldmatrix_x4(r, smem_addr(p));
}

// The same, each matrix transposed: lane l receives column l/4, rows
// 2*(l%4) and 2*(l%4)+1.  From [k][n] rows this gives B fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  ldmatrix_x4_trans(r, smem_addr(p));
}

// c += a * b over one 16 x 8 x 16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b over one 16 x 8 x 16 tile (zero accumulators in).
__device__ __forceinline__ void mma_bf16_zero(float (&c)[4], const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// mbarrier with `count` arrivals a phase; then fence_barrier_init and a
// __syncthreads before any thread uses it
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(s), "r"(count));
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of copies in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(s), "r"(bytes) : "memory");
}

// Copy the box of the tensor map `map` (a __grid_constant__ kernel
// parameter) at coordinates (c0, c1, c2) from device memory to shared
// memory; completion counts against `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int c0, int c1,
                                            int c2, unsigned long long* bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(d), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(b)
      : "memory");
}

// The same for a 2-d tensor map, at coordinates (c0, c1), c0 the inner one.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            unsigned long long* bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(d), "l"(map), "r"(c0), "r"(c1), "r"(b)
      : "memory");
}

// one plain arrival
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(s) : "memory");
}

// Order this thread's earlier shared-memory accesses before its later
// asynchronous (TMA) ones.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait until phase `parity` of `bar` has completed.  A phase that never
// completes (a fault of the caller's byte count) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  for (long long spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(s), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1LL << 22)) __trap();
  }
}

}  // namespace
