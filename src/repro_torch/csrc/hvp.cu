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
// (`MAX_FUSED_D`; above it the JAX wrapper falls back to plain jnp), and
// runs its fp32 products on the MXU. Here the same function is a split and
// two passes over 128 x 128 tiles on the tensor cores (split_tf32.cuh),
// with no limit on D:
//
//   split   V into big and small (L, padded(D)) arrays;
//   pass A  u = act * (V X^T), tile by tile as u^T = X V^T (contraction
//           over D), the mask applied in the epilogue, which writes u split
//           into big and small (L, padded(N)) arrays;
//   pass B  Hv = 2V + 2C u X (contraction over N), the kernel and epilogue
//           shared with hinge.cu's gradient pass.
//
// What bounds it on an H100: operations. It runs once per CG iteration,
// the most-executed compute of DiSMEC training; at the trainer's shape
// (L = 1,024, N = 14,146, D = 101,938) its two contractions are 5.91 TFLOP,
// which split fp32 runs as 17.7 TFLOP of TF32 products, 35.8 ms at 495
// TFLOP/s (88 ms for fp32 FFMA at 67 TFLOP/s), against 6.3 GB of
// compulsory traffic (2 ms at 3.35 TB/s). The split and not one TF32
// product for hinge.cu's reason: CG's directions feed TRON's step
// acceptance, and 11 bits would change its trajectory. No atomics and no
// split-K, so the bits are the same on every launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace {

using namespace split_tf32;

__global__ void __cluster_dims__(1, kCluster, 1)
__launch_bounds__(kThreads, 1)
masked_scores_kernel(const __grid_constant__ CUtensorMap vbig,
                     const __grid_constant__ CUtensorMap vsmall,
                     const __grid_constant__ CUtensorMap xmap,
                     const float* __restrict__ act, float* __restrict__ ubig,
                     float* __restrict__ usmall, int L, int N, int D,
                     int ldn) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;  // labels, rows
  float acc[kAcc];
  if (!mainloop<true>(acc, sm, &xmap, &vbig, &vsmall, D, m0, n0)) return;
  const Frag fr;
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int l = n0 + fr.col(j, v);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = m0 + fr.row(h);
        if (l < L && i < N) {
          unsigned hi, lo;
          split(__fmul_rn(act[static_cast<int64_t>(l) * N + i],
                          acc[4 * j + 2 * h + v]), hi, lo);
          const int64_t p = static_cast<int64_t>(l) * ldn + i;
          ubig[p] = __uint_as_float(hi);
          usmall[p] = __uint_as_float(lo);
        }
      }
    }
}

}  // namespace

// V (L, D), act (L, N) f32 contiguous, X (N, D) f32 with rows ldx floats
// apart, each starting 16-byte aligned -> out (L, D) f32, every element
// written. Scratch from the caller: vsplit (2, L, padded(D)), usplit (2, L,
// padded(N)). Launches its three kernels on `stream` of `device`; returns
// the first CUDA error (0: none; cudaErrorInvalidValue as in hinge.cu).
extern "C" int hvp_f32(const float* V, const float* X, const float* act,
                       float* out, float* vsplit, float* usplit, int L,
                       int N, int D, long long ldx, float C, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps m;
  if (!m.encode(vsplit, usplit, X, L, N, D, ldx))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* usmall = usplit + static_cast<int64_t>(L) * padded(N);
  if ((err = split_rows(V, vsplit, vsplit + static_cast<int64_t>(L) *
                        padded(D), L, D, s)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = launch(masked_scores_kernel, m.grid_a, s, m.bbig, m.bsmall,
                    m.xa, act, usplit, usmall, L, N, D, padded(N))) !=
      cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(launch(reg_plus_rx_kernel<false>, m.grid_b, s,
                                 m.rbig, m.rsmall, m.xb, V, out,
                                 static_cast<float*>(nullptr), L, N, D,
                                 2.0f * C));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
