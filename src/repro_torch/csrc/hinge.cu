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
// wrapper falls back to plain jnp). It runs its fp32 products on the MXU
// (`preferred_element_type=jnp.float32`). Hopper has neither a resident
// full-D tile (227 KB of shared memory per SM) nor a grid that runs in
// order, so the same function is computed in passes over 128 x 128 tiles,
// with no limit on D, on the tensor cores (split_tf32.cuh):
//
//   split   W into big and small (L, padded(D)) arrays, pass A's B operand;
//   pass A  scores^T = X W^T tile by tile (contraction over D); the
//           epilogue writes act, r = act * (scores - S) split into big and
//           small (L, padded(N)) arrays for pass B, and each tile's partial
//           sum of act z^2 per label into an (L, ceil(N/128)) buffer;
//   pass B  grad = 2W + 2C r X, computed as grad^T = X^T r^T (contraction
//           over N); the epilogue also writes each tile's partial sum of
//           W^2 per label into an (L, ceil(D/128)) buffer;
//   pass C  f = sum of the W^2 partials + C * sum of the act z^2
//           partials, per label in a fixed order.
//
// Instances past N are zero in the loads, so they contribute nothing and
// f needs none of the JAX wrapper's `- C * n_pad` correction.
//
// What bounds it on an H100: operations. At the trainer's shape (L = 1,024,
// N = 14,146, D = 101,938) the two contractions are 5.91 TFLOP; split fp32
// runs each as three TF32 products, 17.7 TFLOP, 35.8 ms at the tensor
// cores' 495 TFLOP/s (fp32 FFMA would take 88 ms at 67 TFLOP/s); reading
// W, X and S once and writing grad and act is 6.5 GB, 2 ms at 3.35 TB/s.
// Why the split and not one TF32 product: TF32 keeps 11 bits, so a score
// near the hinge (z near 0) moves by ~1e-3 of its terms' magnitude, which
// flips `act` and with it TRON's trajectory; the three products keep ~21
// bits, below what summing the same fp32 products in another order already
// changes. No atomics and no split-K, so the result is the same bits on
// every launch, as the checkpoint contracts require.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace {

using namespace split_tf32;

__global__ void __cluster_dims__(1, kCluster, 1)
__launch_bounds__(kThreads, 1)
hinge_scores_kernel(const __grid_constant__ CUtensorMap wbig,
                    const __grid_constant__ CUtensorMap wsmall,
                    const __grid_constant__ CUtensorMap xmap,
                    const float* __restrict__ S, float* __restrict__ act,
                    float* __restrict__ rbig, float* __restrict__ rsmall,
                    float* __restrict__ fpart, int L, int N, int D, int ldn) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;  // labels, rows
  float acc[kAcc];
  if (!mainloop<true>(acc, sm, &xmap, &wbig, &wsmall, D, m0, n0)) return;
  const Frag fr;
  float part[kAcc / 4][2];
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int l = n0 + fr.col(j, v);
      part[j][v] = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = m0 + fr.row(h);
        if (l < L && i < N) {
          const int64_t o = static_cast<int64_t>(l) * N + i;
          const float s = S[o], score = acc[4 * j + 2 * h + v];
          const float z = __fsub_rn(1.0f, __fmul_rn(s, score));
          const float a = z > 0.0f ? 1.0f : 0.0f;
          act[o] = a;
          unsigned hi, lo;
          split(__fmul_rn(a, __fsub_rn(score, s)), hi, lo);
          const int64_t p = static_cast<int64_t>(l) * ldn + i;
          rbig[p] = __uint_as_float(hi);
          rsmall[p] = __uint_as_float(lo);
          part[j][v] = __fadd_rn(part[j][v], __fmul_rn(__fmul_rn(a, z), z));
        }
      }
    }
  const float total = tile_row_sums(part, sm, fr);
  if (threadIdx.x < kBN && n0 + threadIdx.x < L)
    fpart[static_cast<int64_t>(n0 + threadIdx.x) * gridDim.y + blockIdx.y] =
        total;
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

// W (L, D), S (L, N) f32 contiguous, X (N, D) f32 with rows ldx floats
// apart, each starting 16-byte aligned -> f (L,), grad (L, D), act (L, N)
// f32, every element written. Scratch from the caller: wsplit (2, L,
// padded(D)), rsplit (2, L, padded(N)), fpart (L, ceil(N/128)), wpart (L,
// ceil(D/128)). Launches its four kernels on `stream` of `device`; returns
// the first CUDA error (0: none; cudaErrorInvalidValue for a shape out of
// range or an X whose rows are not 16-byte aligned).
extern "C" int hinge_obj_grad_f32(const float* W, const float* X,
                                  const float* S, float* f, float* grad,
                                  float* act, float* wsplit, float* rsplit,
                                  float* fpart, float* wpart, int L, int N,
                                  int D, long long ldx, float C, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps m;
  if (!m.encode(wsplit, rsplit, X, L, N, D, ldx))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rsmall = rsplit + static_cast<int64_t>(L) * padded(N);
  if ((err = split_rows(W, wsplit, wsplit + static_cast<int64_t>(L) *
                        padded(D), L, D, s)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = launch(hinge_scores_kernel, m.grid_a, s, m.bbig, m.bsmall,
                    m.xa, S, act, rsplit, rsmall, fpart, L, N, D,
                    padded(N))) != cudaSuccess ||
      (err = launch(reg_plus_rx_kernel<true>, m.grid_b, s, m.rbig, m.rsmall,
                    m.xb, W, grad, wpart, L, N, D, 2.0f * C)) != cudaSuccess)
    return static_cast<int>(err);
  objective_kernel<<<(L + 127) / 128, 128, 0, s>>>(
      wpart, static_cast<int>(m.grid_b.y), fpart,
      static_cast<int>(m.grid_a.y), C, f, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
