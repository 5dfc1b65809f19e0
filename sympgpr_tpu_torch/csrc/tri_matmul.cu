// Matrix products with a lower-triangular operand on Hopper (sm_90a): the
// batched triangular matmuls of the blocked triangular inverse and the syrk
// S = W^T W that forms Ky^{-1} from W = L^{-1}.
//
// Replaces two Pallas kernels:
//  * sympgpr_tpu/ops/pallas_trimm.py:40 _trimm_tile (batched A @ L and
//    L @ A, L lower) -> tri_gemm_kernel<kRight> / <kLeft>;
//  * sympgpr_tpu/ops/pallas_syrk.py:33 _syrk_tile (W^T W, W lower)
//    -> tri_gemm_kernel<kSyrk>.
// The plain PyTorch versions are torch.tril(L) followed by torch.matmul
// (ops/cuda_trimm.py) and W.T @ W (ops/cuda_syrk.py).
//
// What bounds them: arithmetic.  A (64 x 64) output tile reads 2 x 16 x 64
// values per 16-deep k step and does 64 x 64 x 16 multiply-adds from them,
// 32 multiply-adds per value loaded from device memory, so the float32 (or
// float64) FMA pipes and the shared-memory reads that feed them set the
// time, not HBM.  The structural zeros are what the design saves: the triangular
// product needs half of a dense product's multiply-adds, the syrk a sixth.
//
// Design (first version, right before fast; no wgmma or TMA yet):
//  * A classic shared-memory tiled GEMM: 64 x 64 output tile per block of
//    256 threads, each thread a 4 x 4 register tile, k in steps of 16
//    staged in shared memory.  Plain IEEE FMAs in float32 or float64; never
//    TF32 (a reduced-precision product turned real GP Choleskys into NaN,
//    docs/DESIGN.md section 3).
//  * The syrk accumulates float32 input in float64 (inputs converted,
//    DFMA, result rounded to float32 once).  S = Ky^{-1} feeds the trace
//    term of the NLL gradient, a sum over all (2N)^2 entries.  With this
//    kernel accumulating in float32 (one accumulator per output over k up
//    to 8192) the Adam fit at N = 4096 went NaN after ~30 steps and
//    escalated its jitter from 1e-2 to 1e-1 on an H100; with float64
//    accumulation it stays at 1e-2.  cuBLAS's float32 W.T @ W in its place
//    also stays at 1e-2 (another order of summation), so a float32
//    accumulation as accurate as cuBLAS's may suffice; not tried.  The
//    triangular matmuls keep float32 accumulation: W = L^{-1} from them is
//    within 4e-6 of float64 there.
//  * k-ranges skip the structural zeros: for C = A L tile column j0 only
//    accumulates k >= j0; for C = L A tile row i0 only k < i0 + 64; the syrk
//    tile (i, j), j <= i, only k >= i0.
//  * Every load of the triangular operand is masked by element (row >= col)
//    inside the tile, so no element above its diagonal is ever read: the
//    upper triangle may hold anything, NaN included.
//  * The syrk grid covers only the lower tile pairs (one block per pair, a
//    1-D grid decoded to (i, j)); each block writes its tile and the
//    mirrored upper tile, and a diagonal tile writes each element once.
//  * The ragged edge (n not a multiple of 64) is masked in the kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;  // output tile rows
constexpr int kBN = 64;  // output tile columns
constexpr int kBK = 16;  // k depth staged per step
constexpr int kTM = 4;   // rows per thread
constexpr int kTN = 4;   // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);

constexpr int kRight = 0;  // C = A @ tril(B)
constexpr int kLeft = 1;   // C = tril(A) @ B
constexpr int kSyrk = 2;   // C = tril(A)^T @ tril(A), B == A

// accumulator type: float64 for the syrk, the data's type otherwise
template <typename T, int MODE>
using Acc = std::conditional_t<MODE == kSyrk, double, T>;

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    tri_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    T* __restrict__ C, int n, size_t batch_stride) {
  __shared__ T As[kBK][kBM];  // As[kk][m] = Aop[row0 + m][k0 + kk]
  __shared__ T Bs[kBK][kBN];  // Bs[kk][c] = Bop[k0 + kk][col0 + c]

  int bi, bj;
  if constexpr (MODE == kSyrk) {
    // lower tile pairs t = bi (bi + 1) / 2 + bj, bj <= bi
    const int t = blockIdx.x;
    bi = int((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
    while (bi * (bi + 1) / 2 > t) --bi;
    while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
    bj = t - bi * (bi + 1) / 2;
  } else {
    bi = blockIdx.y;
    bj = blockIdx.x;
  }
  const size_t off = size_t(blockIdx.z) * batch_stride;
  A += off;
  B += off;
  C += off;
  const int row0 = bi * kBM, col0 = bj * kBN;
  int kbeg = 0, kend = n;
  if constexpr (MODE == kRight) kbeg = col0;
  if constexpr (MODE == kLeft) kend = min(n, row0 + kBM);
  if constexpr (MODE == kSyrk) kbeg = row0;

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  using A_t = Acc<T, MODE>;
  A_t acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[m][c] = A_t(0);

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      int m, kk;
      T v = T(0);
      if constexpr (MODE == kSyrk) {
        // Aop[m][kk] = W[k0 + kk][row0 + m]: coalesced along m
        m = e % kBM;
        kk = e / kBM;
        const int r = k0 + kk, c = row0 + m;
        if (r < n && c < n && r >= c) v = A[size_t(r) * n + c];
      } else {
        kk = e % kBK;
        m = e / kBK;
        const int r = row0 + m, c = k0 + kk;
        const bool tri = MODE == kLeft;  // Aop = tril(L)
        if (r < n && c < n && (!tri || r >= c)) v = A[size_t(r) * n + c];
      }
      As[kk][m] = v;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int c = e % kBN, kk = e / kBN;
      const int r = k0 + kk, cc = col0 + c;
      const bool tri = MODE != kLeft;  // Bop = tril(L) or tril(W)
      T v = T(0);
      if (r < n && cc < n && (!tri || r >= cc)) v = B[size_t(r) * n + cc];
      Bs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      A_t a[kTM], b[kTN];
#pragma unroll
      for (int m = 0; m < kTM; ++m) a[m] = A_t(As[kk][ty * kTM + m]);
#pragma unroll
      for (int c = 0; c < kTN; ++c) b[c] = A_t(Bs[kk][tx * kTN + c]);
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[m][c] = fma(a[m], b[c], acc[m][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int r = row0 + ty * kTM + m;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int cc = col0 + tx * kTN + c;
      if (r >= n || cc >= n) continue;
      const T v = T(acc[m][c]);
      if constexpr (MODE == kSyrk) {
        if (bi != bj || r >= cc) C[size_t(r) * n + cc] = v;
        if (bi != bj || r > cc) C[size_t(cc) * n + r] = v;  // mirror
      } else {
        C[size_t(r) * n + cc] = v;
      }
    }
  }
}

template <typename T>
int trimm(const T* A, const T* B, T* C, int nb, int s, int right,
          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nt = unsigned((s + kBM - 1) / kBM);
  const dim3 grid(nt, nt, unsigned(nb));
  const size_t stride = size_t(s) * size_t(s);
  if (right) {
    tri_gemm_kernel<T, kRight><<<grid, kThreads, 0, st>>>(A, B, C, s, stride);
  } else {
    tri_gemm_kernel<T, kLeft><<<grid, kThreads, 0, st>>>(A, B, C, s, stride);
  }
  return int(cudaGetLastError());
}

template <typename T>
int syrk(const T* W, T* S, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nt = unsigned((n + kBM - 1) / kBM);
  tri_gemm_kernel<T, kSyrk><<<nt * (nt + 1) / 2, kThreads, 0, st>>>(W, W, S,
                                                                     n, 0);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer to
// row-major data.  trimm: A, B, C are (nb, s, s); right != 0 computes
// C = A @ tril(B), right == 0 computes C = tril(A) @ B.  syrk: W and S are
// (n, n); S = tril(W)^T tril(W), full.  The return value is the
// cudaError_t of the launch (0 on success).
extern "C" int trimm_f32(const float* A, const float* B, float* C, int nb,
                         int s, int right, void* stream) {
  return trimm<float>(A, B, C, nb, s, right, stream);
}

extern "C" int trimm_f64(const double* A, const double* B, double* C, int nb,
                         int s, int right, void* stream) {
  return trimm<double>(A, B, C, nb, s, right, stream);
}

extern "C" int syrk_lower_f32(const float* W, float* S, int n, void* stream) {
  return syrk<float>(W, S, n, stream);
}

extern "C" int syrk_lower_f64(const double* W, double* S, int n,
                              void* stream) {
  return syrk<double>(W, S, n, stream);
}
