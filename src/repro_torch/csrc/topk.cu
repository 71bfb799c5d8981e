// Blocked top-k for Hopper: stage 1 of the two-stage top-k over a score
// matrix (paper §2.2.1's per-node top-k, within one device).
//
// Replaces the TPU kernel `_topk_kernel` in src/repro/kernels/topk/kernel.py
// (called through `blocked_topk_pallas`). Same function: each (row,
// bL-wide block) of scores reduces to k candidates by k rounds of "take the
// maximum, lowest index first on ties, then mask it to NEG_INF", and the
// candidates carry global label ids. The (n, n_blocks * k) candidate strip
// is merged outside the kernel by a stable sort, as the JAX package merges
// it outside the Pallas kernel. The kernel reads the unpadded (n, L) score
// matrix: positions at or past L read as NEG_INF in registers, which is
// the strip the JAX package's padded input gives, without the copy.
//
// What bounds it on an H100: bytes. Each score is read once (32 MB for
// 256 x 30,976 fp32, about 10 us at 3.35 TB/s); the k rounds are a few
// operations per score. The design:
//   - one warp per (row, block), eight warps a CTA taking consecutive
//     blocks of the flat (row, block) order; no shared memory and no
//     __syncthreads;
//   - a lane keeps its slots of the block in registers for all k rounds,
//     loaded as float4 where the rows allow it (L % 4 == 0, bL % 4 == 0, a
//     16-byte-aligned matrix): slot j of lane l is position (j / 4) * 128 +
//     4 * l + j % 4, 16 slots a lane at bL = 512; else one float a slot,
//     position 32 * j + l. Either way a lane's slots ascend with j.
//     Slots past bL are no position of the block and hold -inf with an
//     index past bL, so they never win: a real -inf ties with them and
//     has the lower index, and NEG_INF beats them;
//   - a lane keeps its own best (a scan of its slots in ascending order,
//     strict >, so the lowest position wins a tie); a round is a warp
//     argmax of (value, position) ordered by (value desc, position asc) in
//     two warp reductions (redux.sync): the largest order-preserving key
//     of the lanes' bests (-0 read as +0, so equal values tie), then the
//     lowest position among the lanes that hold it. The lane that holds
//     the winner stores it, masks that slot to NEG_INF and scans its slots
//     again.
// A block with nothing above NEG_INF left returns the lowest position
// holding NEG_INF in every later round (the repeated id 0 of a row of
// padding), as the TPU kernel's first argmax does; -inf entries lose to
// NEG_INF once masked slots exist, and ties go to the lower index.
// Scores are finite or +-inf (no NaN).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // (row, block) pairs a CTA
constexpr float kNegInf = -3.0e38f;    // NEG_INF of the JAX package
constexpr float kAbsent = -__builtin_huge_valf();      // -inf

// Position within the block of lane `lane`'s slot j.
template <bool VEC>
__device__ __forceinline__ int position(int lane, int j) {
  return VEC ? (j >> 2) * 128 + 4 * lane + (j & 3) : 32 * j + lane;
}

// An unsigned key in the order of the scores (finite or +-inf), -0 read
// as +0 so that equal scores have equal keys.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}

// S slots a lane (bL <= 32 * S).
template <int S, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
blocked_topk_kernel(const float* __restrict__ scores,
                    float* __restrict__ vals, int* __restrict__ idx, int L,
                    int bL, int nb, int64_t pairs, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= pairs) return;               // the whole warp
  const int64_t row = w / nb;
  const int blk = static_cast<int>(w % nb);
  const int base = blk * bL;
  const float* s = scores + row * L;
  float v[S];
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < S; j += 4) {
      const int p = position<true>(lane, j);
      float4 f = make_float4(kAbsent, kAbsent, kAbsent, kAbsent);
      if (p < bL)                       // bL % 4 == 0: all four or none
        f = base + p < L                // L % 4 == 0: all four or none
                ? *reinterpret_cast<const float4*>(s + base + p)
                : make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
      v[j] = f.x;
      v[j + 1] = f.y;
      v[j + 2] = f.z;
      v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int p = position<false>(lane, j);
      v[j] = p >= bL ? kAbsent : base + p < L ? s[base + p] : kNegInf;
    }
  }

  // The lane's best slot.
  float bv;
  int bj;
  auto scan = [&]() {
    bv = v[0];
    bj = 0;
#pragma unroll
    for (int j = 1; j < S; ++j)
      if (v[j] > bv) {
        bv = v[j];
        bj = j;
      }
  };
  scan();
  const int64_t out0 = w * k;
  for (int t = 0; t < k; ++t) {
    const int mine = position<VEC>(lane, bj);
    const unsigned key = order_key(bv);
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    const unsigned wp = __reduce_min_sync(
        0xffffffffu, key == top ? static_cast<unsigned>(mine) : 0xffffffffu);
    if (static_cast<unsigned>(mine) == wp) {   // this lane holds the winner
      vals[out0 + t] = bv;
      idx[out0 + t] = base + mine;
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (j == bj) v[j] = kNegInf;
      scan();
    }
  }
}

template <int S>
void launch(const float* scores, float* vals, int* idx, int L, int bL,
            int nb, int64_t pairs, int k, bool vec, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
  if (vec)
    blocked_topk_kernel<S, true><<<grid, kWarps * 32, 0, stream>>>(
        scores, vals, idx, L, bL, nb, pairs, k);
  else
    blocked_topk_kernel<S, false><<<grid, kWarps * 32, 0, stream>>>(
        scores, vals, idx, L, bL, nb, pairs, k);
}

}  // namespace

// scores (n, L) f32, any L >= 1 -> vals (n, nb * k) f32 and idx (n, nb * k)
// i32 in global coordinates, nb = ceil(L / bL): the candidates of the
// scores padded with NEG_INF to nb * bL. Launches on `stream` (a
// cudaStream_t) of `device`; returns cudaGetLastError() after the launch.
extern "C" int blocked_topk_f32(const float* scores, float* vals, int* idx,
                                int n, int L, int bL, int k, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || L < 1 || k < 1 || bL < 1 || bL > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (L + bL - 1) / bL;
  const int64_t pairs = static_cast<int64_t>(n) * nb;
  if ((pairs + kWarps - 1) / kWarps > 0x7fffffff ||
      static_cast<int64_t>(nb) * bL > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = L % 4 == 0 && bL % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bL <= 128)
    launch<4>(scores, vals, idx, L, bL, nb, pairs, k, vec, s);
  else if (bL <= 256)
    launch<8>(scores, vals, idx, L, bL, nb, pairs, k, vec, s);
  else if (bL <= 512)
    launch<16>(scores, vals, idx, L, bL, nb, pairs, k, vec, s);
  else
    launch<32>(scores, vals, idx, L, bL, nb, pairs, k, vec, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
