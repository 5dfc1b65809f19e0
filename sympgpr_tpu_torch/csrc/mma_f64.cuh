// float64 warp-level matrix multiply-accumulate on the tensor cores (DMMA,
// mma.sync.aligned.m16n8k4 with .f64 operands, sm_90 and PTX ISA >= 7.8)
// behind one device function.  Without __CUDA_ARCH__ (a host compiler
// building a kernel's source to run it on the CPU) the same fragment
// semantics are computed from __shfl_sync exchanges of the lanes' values,
// so a fragment layout the kernel gets wrong shows there too.
//
// Fragments of D (16 x 8) = A (16 x 4, row) * B (4 x 8, col) + C, lane l of
// the warp with g = l / 4 and t = l % 4 (PTX ISA, "Matrix Fragments for
// mma.m16n8k4", .f64):
//   a[i], i < 2:  A[g + 8 i][t]
//   b:            B[t][g]
//   c[i], i < 4:  C[g + 8 (i / 2)][2 t + (i % 2)]

#pragma once

#include <math.h>

__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[2],
                                        double b) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
#else
  // every lane takes part in every exchange: A[r][k] is a[r / 8] of lane
  // 4 (r % 8) + k, B[k][n] is b of lane 4 n + k
  const int lane = int(threadIdx.x) & 31, g = lane / 4, t = lane % 4;
  for (int k = 0; k < 4; ++k) {
    const double a_lo = __shfl_sync(0xffffffffu, a[0], 4 * g + k);
    const double a_hi = __shfl_sync(0xffffffffu, a[1], 4 * g + k);
    const double b_0 = __shfl_sync(0xffffffffu, b, 4 * (2 * t) + k);
    const double b_1 = __shfl_sync(0xffffffffu, b, 4 * (2 * t + 1) + k);
    c[0] = fma(a_lo, b_0, c[0]);
    c[1] = fma(a_lo, b_1, c[1]);
    c[2] = fma(a_hi, b_0, c[2]);
    c[3] = fma(a_hi, b_1, c[3]);
  }
#endif
}
