// Blocked top-k for Hopper: stage 1 of the two-stage top-k over a score
// matrix (paper §2.2.1's per-node top-k, within one device).
//
// Replaces the TPU kernel `_topk_kernel` in src/repro/kernels/topk/kernel.py
// (called through `blocked_topk_pallas`). Same function: each (row,
// bL-wide block) of scores reduces to k candidates by k rounds of "take the
// maximum, lowest index first on ties, then mask it to NEG_INF", and the
// candidates carry global label ids. The (n, n_blocks * k) candidate strip
// is merged outside the kernel by a stable sort, as the JAX package merges
// it outside the Pallas kernel.
//
// What bounds it on an H100: bytes. Each score is read once (32 MB for
// 256 x 30,976 fp32, about 10 us at 3.35 TB/s); the k rounds of compares
// are a few operations per score. The design: one CTA of 128 threads per
// (row, block); each thread keeps its bL/128 scores in registers for all k
// rounds, so the block is read from device memory once. A round is a
// thread-local best, a warp shuffle reduction and a 4-entry reduction in
// shared memory, all ordered by (value desc, index asc), which reproduces
// the first-argmax tie order of the TPU kernel exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 8;       // bL <= 1024
constexpr int kNone = 0x7fffffff;      // "no candidate" index
constexpr float kNegInf = -3.0e38f;    // NEG_INF of the JAX package

// (v1, i1) ranks before (v2, i2): larger value, then lower index.
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return i1 != kNone && (i2 == kNone || v1 > v2 || (v1 == v2 && i1 < i2));
}

__global__ void __launch_bounds__(kThreads)
blocked_topk_kernel(const float* __restrict__ scores,
                    float* __restrict__ vals, int* __restrict__ idx, int L,
                    int bL, int k) {
  const int blk = blockIdx.x;
  const int row = blockIdx.y;
  const int nb = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* s =
      scores + static_cast<int64_t>(row) * L + static_cast<int64_t>(blk) * bL;
  const int64_t out0 =
      (static_cast<int64_t>(row) * nb + blk) * static_cast<int64_t>(k);

  float v[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int i = tid + j * kThreads;
    v[j] = i < bL ? s[i] : 0.0f;
  }

  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int winner;

  for (int t = 0; t < k; ++t) {
    float bv = 0.0f;
    int bi = kNone;
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int i = tid + j * kThreads;
      if (i < bL && better(v[j], i, bv, bi)) {
        bv = v[j];
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      float wv = warp_v[0];
      int wi = warp_i[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        if (better(warp_v[w], warp_i[w], wv, wi)) {
          wv = warp_v[w];
          wi = warp_i[w];
        }
      vals[out0 + t] = wv;
      idx[out0 + t] = blk * bL + wi;
      winner = wi;
    }
    __syncthreads();
    const int wi = winner;
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j)
      if (tid + j * kThreads == wi) v[j] = kNegInf;
  }
}

}  // namespace

// scores (n, L) f32 with L % bL == 0 -> vals (n, (L / bL) * k) f32 and
// idx (n, (L / bL) * k) i32 in global coordinates. Launches on `stream` (a
// cudaStream_t) of `device`; returns cudaGetLastError() after the launch.
extern "C" int blocked_topk_f32(const float* scores, float* vals, int* idx,
                                int n, int L, int bL, int k, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n > 65535 || k < 1 || bL < 1 ||
      bL > kThreads * kMaxPerThread || L % bL != 0 || L < bL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(L / bL, n);
  blocked_topk_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(scores, vals,
                                                             idx, L, bL, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
