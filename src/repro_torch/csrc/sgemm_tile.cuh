// Exact-fp32 tile engine shared by the training kernels (hinge.cu, hvp.cu).
//
// One CTA of 256 threads computes a 128 x 128 tile of a product
//   acc(m, n) = sum_k A(m, k) * B(n, k)
// with A an (M, K) row-major operand (k contiguous) and B either an (Nn, K)
// row-major operand (k contiguous, `BKContig`) or a (K, Nn) row-major one
// (n contiguous). The contraction streams through shared memory in 16-wide
// K slices, double-buffered through registers: the next slice is loaded
// from device memory while the current one is multiplied, then written to
// the other shared buffer, so each slice costs one barrier. Loads are
// scalar and masked, so any (M, Nn, K) works and rows of any length need no
// alignment (D = 101,938 leaves every other row of X only 8-byte aligned);
// a warp's loads are contiguous in memory. Each thread accumulates an 8 x 8
// sub-tile with FFMA in fp32 registers (no TF32), reading its A and B
// fragments as 16-byte shared-memory loads. Nothing is atomic and the
// summation order is fixed, so two launches give identical bits.
//
// Offsets are 64-bit: N * D = 1.44e9 at Wiki10-31K width, within 1.5x of
// 2^31.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sgemm {

constexpr int kBM = 128;             // tile rows (A side)
constexpr int kBN = 128;             // tile columns (B side)
constexpr int kBK = 16;              // K slice per stage
constexpr int kThreads = 256;
constexpr int kStride = kBM + 4;     // shared row stride, floats
constexpr int kPerThread = kBM * kBK / kThreads;   // 8 staged loads

struct __align__(16) Smem {
  float a[2][kBK][kStride];
  float b[2][kBK][kStride];
};

// Stage the K slice [k0, k0 + 16) of rows [r0, r0 + 128) of a k-contiguous
// operand p (element (row, k) at p[row * ld + k]); zero outside (rows, K).
__device__ __forceinline__ void load_kcontig(float (&reg)[kPerThread],
                                             const float* __restrict__ p,
                                             int64_t ld, int rows, int K,
                                             int r0, int k0) {
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const int e = threadIdx.x + s * kThreads;
    const int row = r0 + e / kBK, k = k0 + e % kBK;
    reg[s] = (row < rows && k < K) ? p[static_cast<int64_t>(row) * ld + k]
                                   : 0.0f;
  }
}

__device__ __forceinline__ void store_kcontig(const float (&reg)[kPerThread],
                                              float (*sm)[kStride]) {
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const int e = threadIdx.x + s * kThreads;
    sm[e % kBK][e / kBK] = reg[s];
  }
}

// The same slice of a row-contiguous operand: element (row, k) at
// p[k * ld + row].
__device__ __forceinline__ void load_rowcontig(float (&reg)[kPerThread],
                                               const float* __restrict__ p,
                                               int64_t ld, int rows, int K,
                                               int r0, int k0) {
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const int e = threadIdx.x + s * kThreads;
    const int row = r0 + e % kBN, k = k0 + e / kBN;
    reg[s] = (row < rows && k < K) ? p[static_cast<int64_t>(k) * ld + row]
                                   : 0.0f;
  }
}

__device__ __forceinline__ void store_rowcontig(
    const float (&reg)[kPerThread], float (*sm)[kStride]) {
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const int e = threadIdx.x + s * kThreads;
    sm[e / kBN][e % kBN] = reg[s];
  }
}

// Row (i) and column (j) of a thread's 8 x 8 sub-tile within the tile.
__device__ __forceinline__ int tile_row(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x / 16) * 4 + (i & 3);
}
__device__ __forceinline__ int tile_col(int j) {
  return (j < 4 ? 0 : 64) + (threadIdx.x % 16) * 4 + (j & 3);
}

// acc = A[m0:m0+128, :] . B[n0:n0+128, :]^T over all of K.
template <bool BKContig>
__device__ __forceinline__ void mainloop(float (&acc)[8][8], Smem& sm,
                                         const float* __restrict__ A,
                                         int64_t lda, int M,
                                         const float* __restrict__ B,
                                         int64_t ldb, int Nn, int K, int m0,
                                         int n0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float ra[kPerThread], rb[kPerThread];
  const int ktiles = (K + kBK - 1) / kBK;
  load_kcontig(ra, A, lda, M, K, m0, 0);
  if (BKContig)
    load_kcontig(rb, B, ldb, Nn, K, n0, 0);
  else
    load_rowcontig(rb, B, ldb, Nn, K, n0, 0);
  store_kcontig(ra, sm.a[0]);
  if (BKContig)
    store_kcontig(rb, sm.b[0]);
  else
    store_rowcontig(rb, sm.b[0]);
  __syncthreads();

  for (int t = 0; t < ktiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < ktiles;
    if (more) {                       // next slice in flight during the FMAs
      const int k0 = (t + 1) * kBK;
      load_kcontig(ra, A, lda, M, K, m0, k0);
      if (BKContig)
        load_kcontig(rb, B, ldb, Nn, K, n0, k0);
      else
        load_rowcontig(rb, B, ldb, Nn, K, n0, k0);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sm.a[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.a[cur][k][64 + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&sm.b[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sm.b[cur][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {                       // the other buffer was freed by the
      store_kcontig(ra, sm.a[cur ^ 1]);   // barrier ending slice t - 1
      if (BKContig)
        store_kcontig(rb, sm.b[cur ^ 1]);
      else
        store_rowcontig(rb, sm.b[cur ^ 1]);
    }
    __syncthreads();
  }
}

// Sum `v` over the 16 threads that share a tile row (one half-warp), in a
// fixed order.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// out = 2 * W + two_c * (R . X) for R (L, N), X (N, D), W and out (L, D):
// pass B of both training kernels (the gradient, the Hessian-vector
// product). With `RowNorms`, each tile also writes its partial sum of W^2
// per label to wpart[l * gridDim.y + blockIdx.y].
template <bool RowNorms>
__global__ void __launch_bounds__(kThreads)
reg_plus_rx_kernel(const float* __restrict__ R, const float* __restrict__ X,
                   const float* __restrict__ W, float* __restrict__ out,
                   float* __restrict__ wpart, int L, int N, int D,
                   float two_c) {
  __shared__ Smem sm;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[8][8];
  mainloop<false>(acc, sm, R, N, L, X, D, D, N, m0, n0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = m0 + tile_row(i);
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = n0 + tile_col(j);
      if (l < L && d < D) {
        const int64_t o = static_cast<int64_t>(l) * D + d;
        const float w = W[o];
        out[o] = __fadd_rn(__fmul_rn(2.0f, w), __fmul_rn(two_c, acc[i][j]));
        if (RowNorms) part = fmaf(w, w, part);
      }
    }
    if (RowNorms) {
      part = row_sum16(part);
      if (threadIdx.x % 16 == 0 && l < L)
        wpart[static_cast<int64_t>(l) * gridDim.y + blockIdx.y] = part;
    }
  }
}

// Host side: grid of 128 x 128 tiles over (rows, cols); false when it
// exceeds what a launch takes.
inline bool tile_grid(int rows, int cols, dim3* grid) {
  const int gx = (rows + kBM - 1) / kBM, gy = (cols + kBN - 1) / kBN;
  if (gx < 1 || gy < 1 || gy > 65535) return false;
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  return true;
}

}  // namespace sgemm
