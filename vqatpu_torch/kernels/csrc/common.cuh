// cp.async (sm_80 and later), shared by the kernels of this directory:
// copies from device memory into shared memory that do not pass through
// registers, grouped with commit/wait, so that a ring of shared-memory stages
// fills while the block computes on another.

#pragma once

#include <cuda_runtime.h>

namespace {

// Copy BYTES (4, 8 or 16) from `src` in device memory to `dst` in shared
// memory, both aligned to BYTES.  With `ok` false nothing is read and `dst`
// is filled with zeros; `src` must still be a valid address.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    // .cg: cache in L2 only; each 16-byte unit is read once
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(s), "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
