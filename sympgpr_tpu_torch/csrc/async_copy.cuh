// Asynchronous global -> shared copies (cp.async, sm_80 and later) behind
// three small device functions.  Without __CUDA_ARCH__ (a host compiler
// building a kernel's source to run it on the CPU) each copy is a plain
// synchronous copy and the commit and wait do nothing, so the same kernel
// source runs there unchanged.

#pragma once

#include <string.h>

// Copy the first src_bytes of a BYTES-wide (4, 8 or 16) chunk from global
// src to shared dst and zero the rest.  Bytes past src_bytes are never
// read: with src_bytes == 0 nothing is read, and src may point anywhere
// inside the operand.  dst and src are BYTES-aligned.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    // .cg: through L2 only, the operands are streamed once per tile
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(src_bytes));
  }
#else
  memcpy(dst, src, size_t(src_bytes));
  memset(static_cast<char*>(dst) + src_bytes, 0, size_t(BYTES - src_bytes));
#endif
}

// Close the group of copies this thread issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until at most N of this thread's committed groups are in flight.
// The copies are then visible to this thread; a __syncthreads() after the
// wait makes every thread's copies visible to the block.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}
