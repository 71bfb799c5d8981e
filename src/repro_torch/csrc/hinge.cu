// Fused squared-hinge objective, gradient and active mask for Hopper: the
// TRON outer loop's obj_grad(W) -> (f, grad, act) over one label batch.
//
//   scores = W X^T,  z = 1 - S * scores,  act = 1[z > 0]
//   f      = sum_d W^2 + C sum_i act z^2               (L,)
//   grad   = 2 W + 2C (act * (scores - S)) X           (L, D)
//
// Replaces the TPU kernel `_hinge_kernel` in src/repro/kernels/hinge/
// kernel.py (called through `hinge_obj_grad_pallas`). That kernel keeps a
// (128, D) gradient tile resident in VMEM across a sequential sweep over
// instance tiles and accumulates f and grad there (`pl.when(j == 0)`
// initialisation), which caps D at 8,192 (`MAX_FUSED_D`; above it the JAX
// wrapper falls back to plain jnp). Hopper has neither a resident full-D
// tile (227 KB of shared memory per SM) nor a grid that runs in order, so
// the same function is computed in passes over 128 x 128 tiles, with no
// limit on D:
//
//   pass A  scores tile by tile (contraction over D streamed through
//           shared memory); the epilogue takes the tile in registers and
//           writes act, r = act * (scores - S) and each tile's partial
//           sum of act z^2 per label into an (L, ceil(N/128)) buffer;
//   pass B  grad = 2W + 2C r X (contraction over N); the epilogue also
//           writes each tile's partial sum of W^2 per label into an
//           (L, ceil(D/128)) buffer;
//   pass C  f = sum of the W^2 partials + C * sum of the act z^2
//           partials, per label in a fixed order.
//
// Instances past N are masked in the loads, so they contribute nothing and
// f needs none of the JAX wrapper's `- C * n_pad` correction.
//
// What bounds it on an H100: operations. At the trainer's shape (L = 1,024,
// N = 14,146, D = 101,938) the two contractions are 5.91 TFLOP of fp32, 88
// ms at 67 TFLOP/s; reading W, X and S once and writing grad and act is
// 6.5 GB, 2 ms at 3.35 TB/s. The design keeps every tile's arithmetic in
// fp32 FFMA (sgemm_tile.cuh) at 8 x 8 outputs per thread: no TF32, which
// keeps three digits and would flip `act` where z is near 0 and with it
// TRON's trajectory; no atomics and no split-K, so the result is the same
// bits on every launch, as the checkpoint contracts require.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_tile.cuh"

namespace {

using sgemm::kBM;
using sgemm::kBN;

__global__ void __launch_bounds__(sgemm::kThreads)
hinge_scores_kernel(const float* __restrict__ W, const float* __restrict__ X,
                    const float* __restrict__ S, float* __restrict__ act,
                    float* __restrict__ r, float* __restrict__ fpart, int L,
                    int N, int D) {
  __shared__ sgemm::Smem sm;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[8][8];
  sgemm::mainloop<true>(acc, sm, W, D, L, X, D, N, D, m0, n0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = m0 + sgemm::tile_row(i);
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + sgemm::tile_col(j);
      if (l < L && n < N) {
        const int64_t o = static_cast<int64_t>(l) * N + n;
        const float s = S[o], score = acc[i][j];
        const float z = __fsub_rn(1.0f, __fmul_rn(s, score));
        const float a = z > 0.0f ? 1.0f : 0.0f;
        act[o] = a;
        r[o] = __fmul_rn(a, __fsub_rn(score, s));
        part = __fadd_rn(part, __fmul_rn(__fmul_rn(a, z), z));
      }
    }
    part = sgemm::row_sum16(part);
    if (threadIdx.x % 16 == 0 && l < L)
      fpart[static_cast<int64_t>(l) * gridDim.y + blockIdx.y] = part;
  }
}

__global__ void objective_kernel(const float* __restrict__ wpart, int n_wt,
                                 const float* __restrict__ fpart, int n_ft,
                                 float C, float* __restrict__ f, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float reg = 0.0f, loss = 0.0f;
  for (int t = 0; t < n_wt; ++t)
    reg += wpart[static_cast<int64_t>(l) * n_wt + t];
  for (int t = 0; t < n_ft; ++t)
    loss += fpart[static_cast<int64_t>(l) * n_ft + t];
  f[l] = __fadd_rn(reg, __fmul_rn(C, loss));
}

}  // namespace

// W (L, D), X (N, D), S (L, N) f32, contiguous -> f (L,), grad (L, D),
// act (L, N) f32, every element written. Scratch from the caller: r (L, N),
// fpart (L, ceil(N/128)), wpart (L, ceil(D/128)). Launches its three
// passes on `stream` of `device`; returns the first CUDA error (0: none).
extern "C" int hinge_obj_grad_f32(const float* W, const float* X,
                                  const float* S, float* f, float* grad,
                                  float* act, float* r, float* fpart,
                                  float* wpart, int L, int N, int D,
                                  float C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_a, grid_b;
  if (L < 1 || N < 1 || D < 1 || !sgemm::tile_grid(L, N, &grid_a) ||
      !sgemm::tile_grid(L, D, &grid_b))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hinge_scores_kernel<<<grid_a, sgemm::kThreads, 0, s>>>(W, X, S, act, r,
                                                         fpart, L, N, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sgemm::reg_plus_rx_kernel<true><<<grid_b, sgemm::kThreads, 0, s>>>(
      r, X, W, grad, wpart, L, N, D, 2.0f * C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  objective_kernel<<<(L + 127) / 128, 128, 0, s>>>(
      wpart, static_cast<int>(grid_b.y), fpart, static_cast<int>(grid_a.y),
      C, f, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
