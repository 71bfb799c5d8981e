// Generalized-Hessian vector product for Hopper: the TRON inner (CG)
// loop's hvp(V, act) over one label batch.
//
//   Hv = 2 V + 2C (act * (V X^T)) X                    (L, D)
//
// with `act` the (L, N) active mask the hinge kernel emitted at the
// current Newton iterate.
//
// Replaces the TPU kernel `_hvp_kernel` in src/repro/kernels/hvp/kernel.py
// (called through `hvp_pallas`). That kernel keeps a (128, D) output tile
// resident in VMEM across a sequential sweep over instance tiles
// (`pl.when(j == 0)` initialisation), which caps D at 8,192
// (`MAX_FUSED_D`; above it the JAX wrapper falls back to plain jnp). Here
// the same function is two passes over 128 x 128 tiles, with no limit on
// D:
//
//   pass A  u = act * (V X^T), tile by tile (contraction over D streamed
//           through shared memory), the mask applied in the epilogue;
//   pass B  Hv = 2V + 2C u X (contraction over N), the tile engine and
//           epilogue shared with hinge.cu's gradient pass.
//
// What bounds it on an H100: operations. It runs once per CG iteration,
// the most-executed compute of DiSMEC training; at the trainer's shape
// (L = 1,024, N = 14,146, D = 101,938) its two contractions are 5.91 TFLOP
// of fp32, 88 ms at 67 TFLOP/s, against 6.3 GB of compulsory traffic (2 ms
// at 3.35 TB/s). The design is hinge.cu's: FFMA in fp32 registers at 8 x 8
// outputs per thread (sgemm_tile.cuh), no TF32, no atomics, no split-K, so
// the bits are the same on every launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_tile.cuh"

namespace {

using sgemm::kBM;
using sgemm::kBN;

__global__ void __launch_bounds__(sgemm::kThreads)
masked_scores_kernel(const float* __restrict__ V, const float* __restrict__ X,
                     const float* __restrict__ act, float* __restrict__ u,
                     int L, int N, int D) {
  __shared__ sgemm::Smem sm;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[8][8];
  sgemm::mainloop<true>(acc, sm, V, D, L, X, D, N, D, m0, n0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = m0 + sgemm::tile_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + sgemm::tile_col(j);
      if (l < L && n < N) {
        const int64_t o = static_cast<int64_t>(l) * N + n;
        u[o] = __fmul_rn(act[o], acc[i][j]);
      }
    }
  }
}

}  // namespace

// V (L, D), X (N, D), act (L, N) f32, contiguous -> out (L, D) f32, every
// element written. Scratch from the caller: u (L, N). Launches both passes
// on `stream` of `device`; returns the first CUDA error (0: none).
extern "C" int hvp_f32(const float* V, const float* X, const float* act,
                       float* out, float* u, int L, int N, int D, float C,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_a, grid_b;
  if (L < 1 || N < 1 || D < 1 || !sgemm::tile_grid(L, N, &grid_a) ||
      !sgemm::tile_grid(L, D, &grid_b))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  masked_scores_kernel<<<grid_a, sgemm::kThreads, 0, s>>>(V, X, act, u, L, N,
                                                          D);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sgemm::reg_plus_rx_kernel<false><<<grid_b, sgemm::kThreads, 0, s>>>(
      u, X, V, out, nullptr, L, N, D, 2.0f * C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
