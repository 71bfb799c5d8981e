// Banded (sliding-window) causal GQA attention for Hopper: the attention
// of the LM's local layers at long sequence lengths (hymba-1.5b's prefill).
//
// Replaces the TPU kernel `_banded_kernel` in
// src/repro/kernels/banded_attn/kernel.py (called through
// `banded_attention_pallas`). Same function: query row i of head h attends
// to the keys j of KV head h / G with j <= i and j > i - window, at scale
// 1/sqrt(hd), with an optional tanh softcap; the softmax statistics and
// every sum are fp32 and the output is in q's type. Not a copy of the
// Pallas blocks: there the band of each query block is one slice of span
// = window + qc rounded up to 128 and clamped into [0, Tk), sized to fit
// the TPU's VMEM; here the band is walked tile by tile, so any window and
// any length run on the kernel.
//
// Layout: q (B, Tq, H, hd), k and v (B, Tk, KV, hd), out (B, Tq, H * hd),
// contiguous, as the model's projections produce them: no transposes
// around the kernel. Element offsets are int64_t.
//
// What bounds it on an H100: operations. Each query position does
// 4 * hd * min(i + 1, window) flops per head against a few bytes, far
// above the card's ~295 flops per byte. Two kernels, by type:
//
// bf16 (`wgmma_kernel`, the LM's path): both products on the tensor cores,
// bf16 x bf16 -> fp32 with `wgmma`. One CTA per (query head, 128 query
// positions, sequence): two consumer warpgroups of 64 rows each and one
// producer warp. The producer loads the CTA's Q tile once and then the
// band's K and V tiles of 64 keys by TMA, into a ring of 3 stages that
// complete on mbarriers; each tile is a box of (64 keys, hd) at column
// kvh * hd of a 3D tensor map over (B, T, heads * hd), whose batch
// dimension keeps a box from reading into the next sequence (past the end
// it reads zeros). The boxes are swizzled at hd * 2 bytes (128 at hd >= 64,
// in 64-column halves at hd = 128), the layout wgmma reads. Per key tile a
// warpgroup computes S = Q . K^T (m64n64k16, Q and K from shared memory,
// both K-major), applies scale, softcap and -- only on the tiles at the
// band's two edges -- the causal/window mask, updates its online softmax
// in fp32 registers (a row's four lanes reduce with shuffles), rounds the
// probabilities to bf16 in the registers where the S accumulator left them
// (wgmma's accumulator layout is its A-fragment layout) and adds P . V
// (m64nNk16, P from registers, V from shared memory MN-major: the
// transposed B that bf16 wgmma allows) into its output accumulator. A
// warpgroup skips the tiles outside its own rows' band but still releases
// them (after waiting for them, like every warp: see the loop). The heads
// of one KV group share K and V through L2 (adjacent blockIdx.x), not
// through shared memory. bf16 x bf16 products are exact in fp32, so the
// one rounding the kernel adds is P to bf16, as the plain version does (it
// rounds the normalized weights). Rows with no key so far keep (m, l, acc)
// = (-inf, 0, 0); exp2(-inf) = 0 drops that state once a key arrives.
//
// fp32 (`banded_attn_kernel`): FFMA on the CUDA cores, since a TF32
// product on the tensor cores would not keep fp32 accuracy. One CTA of
// 256 threads per (batch, KV head, tile of BQ query positions). Its
// kRows = 128 rows are the G query heads of the group times BQ = 128 / G
// positions, so the G heads share every K/V tile it stages in shared
// memory. It visits only the key tiles of its band, [max(0, q0 - window +
// 1), q0 + BQ), kKeys = 64 keys at a time, with an online softmax in fp32.
// Each thread owns 4 rows x 8 keys of the score tile and the same 4 rows x
// hd / 8 columns of the output accumulator; the 8 lanes sharing 4 rows
// reduce row maxima and sums with warp shuffles, and pass the
// probabilities to each other through shared memory. Rows of shared memory
// are padded by one float, so neither the score loop nor the weighted sum
// has bank conflicts. It runs on the fp32 CUDA cores, at most 67 TFLOP/s.
//
// Neither kernel uses atomics, and both sum in a fixed order: two launches
// give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------- fp32: FFMA kernel

namespace ffma {

constexpr int kThreads = 256;
constexpr int kRows = 128;                       // (head, position) rows
constexpr int kKeys = 64;                        // keys per K/V tile
constexpr int kCols = 8;                         // lanes sharing 4 rows
constexpr int kRowsPerThread = kRows / (kThreads / kCols);   // 4
constexpr int kKeysPerThread = kKeys / kCols;                // 8
constexpr unsigned kFull = 0xffffffffu;

// Sum or max over the 8 lanes of a row group (consecutive lanes).
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 2));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 4));
}
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  return x + __shfl_xor_sync(kFull, x, 4);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * (HD + 1) + kKeys * (HD + 1) + kKeys * HD +
                          kRows * (kKeys + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
banded_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   int Tq, int Tk, int H, int KV, int G, int BQ, int window,
                   float scale, float softcap) {
  constexpr int kQS = HD + 1;                    // padded row strides
  constexpr int kPS = kKeys + 1;
  constexpr int kDims = HD / kCols;              // output columns a thread
  extern __shared__ float smem[];
  float* sQ = smem;                              // kRows x kQS
  float* sK = sQ + kRows * kQS;                  // kKeys x kQS
  float* sV = sK + kKeys * kQS;                  // kKeys x HD
  float* sP = sV + kKeys * HD;                   // kRows x kPS

  const int tid = threadIdx.x;
  const int rg = tid / kCols;                    // row group: rows 4rg..4rg+3
  const int cg = tid % kCols;                    // keys cg + 8j, dims cg + 8j
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const int rows = G * BQ;                       // row r = g * BQ + i
  const int64_t key_stride = static_cast<int64_t>(KV) * HD;
  const int64_t kv0 = (static_cast<int64_t>(b) * Tk * KV + kvh) * HD;

  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int pos = q0 + r % BQ;
    float x = 0.0f;
    if (r < rows && pos < Tq)
      x = q[((static_cast<int64_t>(b) * Tq + pos) * H + kvh * G + r / BQ) *
            HD + d];
    sQ[r * kQS + d] = x;
  }

  int pos[kRowsPerThread];
  bool live[kRowsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kDims];
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int r = rg * kRowsPerThread + rr;
    pos[rr] = q0 + r % BQ;
    live[rr] = r < rows && pos[rr] < Tq;
    m[rr] = -INFINITY;
    l[rr] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) acc[rr][dd] = 0.0f;
  }

  const int lo = max(0, q0 - window + 1);
  const int hi = min(Tq, q0 + BQ);               // the band is [lo, hi)
  for (int j0 = lo; j0 < hi; j0 += kKeys) {
    __syncthreads();                             // last tile fully read
    for (int e = tid; e < kKeys * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const int key = j0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < Tk) {
        const int64_t off = kv0 + key * key_stride + d;
        kx = k[off];
        vx = v[off];
      }
      sK[j * kQS + d] = kx;
      sV[j * HD + d] = vx;
    }
    __syncthreads();

    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr)
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) s[rr][jj] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr)
        qv[rr] = sQ[(rg * kRowsPerThread + rr) * kQS + d];
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj)
        kv[jj] = sK[(cg + kCols * jj) * kQS + d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr)
#pragma unroll
        for (int jj = 0; jj < kKeysPerThread; ++jj)
          s[rr][jj] = fmaf(qv[rr], kv[jj], s[rr][jj]);
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        const int key = j0 + cg + kCols * jj;
        float x = s[rr][jj] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const bool ok =
            live[rr] && key <= pos[rr] && key > pos[rr] - window;
        s[rr][jj] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[rr][jj]);
      }
      const float m_new = fmaxf(m[rr], group_max(mx));
      // A row with no key in the band so far keeps (m, l, acc) = (-inf,
      // 0, 0); exp(-inf) = 0 drops the old state once a key arrives.
      const float corr = m_new == -INFINITY ? 1.0f : expf(m[rr] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        const float p = s[rr][jj] == -INFINITY ? 0.0f
                                               : expf(s[rr][jj] - m_new);
        sP[(rg * kRowsPerThread + rr) * kPS + cg + kCols * jj] = p;
        sum += p;
      }
      l[rr] = l[rr] * corr + group_sum(sum);
      m[rr] = m_new;
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) acc[rr][dd] *= corr;
    }
    __syncwarp();                                // a row group is one warp's

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pv[kRowsPerThread], vv[kDims];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr)
        pv[rr] = sP[(rg * kRowsPerThread + rr) * kPS + j];
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) vv[dd] = sV[j * HD + cg + kCols * dd];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr)
#pragma unroll
        for (int dd = 0; dd < kDims; ++dd)
          acc[rr][dd] = fmaf(pv[rr], vv[dd], acc[rr][dd]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    if (!live[rr]) continue;
    const int r = rg * kRowsPerThread + rr;
    const float inv = 1.0f / l[rr];              // the diagonal key: l >= 1
    float* o = out + ((static_cast<int64_t>(b) * Tq + pos[rr]) * H +
                      kvh * G + r / BQ) * HD;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) o[cg + kCols * dd] = acc[rr][dd] * inv;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int Tq, int Tk, int H, int KV,
                       int window, float scale, float softcap,
                       cudaStream_t stream) {
  const int G = H / KV;
  const int BQ = kRows / G;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      banded_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * KV);
  banded_attn_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Tq, Tk, H, KV,
      G, BQ, window, scale, softcap);
  return cudaGetLastError();
}

}  // namespace ffma

// ------------------------------------------------------- bf16: wgmma kernel

namespace wg {

constexpr int kBM = 128;                   // query positions a CTA
constexpr int kBN = 64;                    // keys a stage
constexpr int kStages = 3;
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout at head dim HD. A tile of rows x HD bf16 is kChunks
// regions of rows x kRow bytes, each row one swizzle span (32, 64 or 128
// bytes); Q takes kBM rows, each of a stage's K and V kBN rows.
template <int HD>
struct Tiles {
  static constexpr int kChunk = HD < 64 ? HD : 64;   // columns a region
  static constexpr int kChunks = HD / kChunk;
  static constexpr int kRow = 2 * kChunk;            // bytes
  static constexpr uint64_t kLayout = kRow == 128 ? 1 : kRow == 64 ? 2 : 3;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;      // one of K, V
  static constexpr int kOAcc = kChunk / 2;           // floats a P.V wgmma
  // 1 KB of slack aligns the swizzled regions to 1024 bytes.
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + (1 + 2 * kStages) * 8;
  static CUtensorMapSwizzle swizzle() {
    return kRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
           : kRow == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  }
};

// wgmma descriptors of a swizzled region: 8-row groups 8 * kRow bytes
// apart. K-major (Q, K: the k16 step's 32 bytes inside a row); MN-major
// (V: 16 keys = two 8-row groups a k16 step, the region kChunk columns
// wide), where the leading offset is set to the same stride: a region is
// one swizzle atom wide, so it is never read.
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  using T = Tiles<HD>;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(8 * T::kRow >> 4) << 32) |
         (T::kLayout << 62);
}
template <int HD>
__device__ __forceinline__ uint64_t mnmajor_desc(const void* p) {
  using T = Tiles<HD>;
  constexpr uint64_t kStride = 8 * T::kRow >> 4;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (kStride << 16) | (kStride << 32) | (T::kLayout << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (+)= A (64 x 16 at da, K-major) . B (64 x 16 at db, K-major)^T, bf16
// in, fp32 out; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A (64 x 16, this thread's bf16 fragment a) . B (16 x N at db,
// MN-major: the transposed B), fp32 out; one overload per N = 16, 32, 64
// (d holds N / 2 floats).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Grid: (H, ceil(Tq / kBM), B). Thread kConsumers issues every copy; the
// consumer warpgroups wg = 0, 1 own query rows q0 + 64 wg .. + 63. A
// thread's S and P.V accumulator elements 4j + 2hh + v sit at row
// 16 * warp + g + 8 hh of its warpgroup and column 8j + 2t + v (g = lane /
// 4, t = lane % 4).
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ out, int Tq, int H, int G,
             int window, float scale, float softcap) {
  using T = Tiles<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* skv = sq + T::kQBytes;      // stage s: K, then V
  uint64_t* qbar = reinterpret_cast<uint64_t*>(skv + 2 * kStages *
                                               T::kKVBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x, q0 = blockIdx.y * kBM, b = blockIdx.z;
  const int lo = max(0, q0 - window + 1) / kBN * kBN;
  const int hi = min(Tq, q0 + kBM);          // the band is [lo, hi)
  const int ntiles = (hi - lo + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {           // the producer warp
    if (threadIdx.x != kConsumers) return;
    const int kcol = h / G * HD;
    mbar_expect(qbar, T::kQBytes);
    for (int c = 0; c < T::kChunks; ++c)
      tma_load_3d(sq + c * kBM * T::kRow, &qmap, h * HD + c * T::kChunk, q0,
                  b, qbar);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
      unsigned char* kd = skv + 2 * s * T::kKVBytes;
      mbar_expect(&full[s], 2 * T::kKVBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        const int col = kcol + c * T::kChunk;
        tma_load_3d(kd + c * kBN * T::kRow, &kmap, col, lo + it * kBN, b,
                    &full[s]);
        tma_load_3d(kd + T::kKVBytes + c * kBN * T::kRow, &vmap, col,
                    lo + it * kBN, b, &full[s]);
      }
    }
    return;
  }

  const int wgi = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * wgi;              // the warpgroup's first row
  const int row0 = r0 + 16 * warp + g;       // this thread's rows: + 8 hh
  const bool live = r0 < Tq;
  const int r_last = min(r0 + 63, Tq - 1);
  const float scale_log2 = scale * kLog2e;

  float o[T::kChunks][T::kOAcc];
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < T::kOAcc; ++i) o[c][i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float sc[32] = {};                         // written by wgmma
  uint32_t pa[kBN / 16][4];
  if (live) mbar_wait(qbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages, j0 = lo + it * kBN;
    // Every warp waits for every stage, even one it skips: a warp that
    // skipped a wait could run a whole phase ahead of the barrier, where
    // the parity test cannot tell the phases apart.
    mbar_wait(&full[s], (it / kStages) & 1);
    // Does the tile hold a key of some live row's band?
    if (live && j0 <= r_last && j0 + kBN - 1 > r0 - window) {
      const unsigned char* kd = skv + 2 * s * T::kKVBytes;
      const unsigned char* vd = kd + T::kKVBytes;

      fence_operands(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 / T::kChunk, off = kk * 32 % T::kRow;
        wgmma_ss_n64(sc,
                     kmajor_desc<HD>(sq + c * kBM * T::kRow +
                                     64 * wgi * T::kRow + off),
                     kmajor_desc<HD>(kd + c * kBN * T::kRow + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(sc);

      // Only the tiles at the band's edges hold masked keys: the diagonal
      // and the window's far end.
      const bool edge = j0 + kBN - 1 > r0 || j0 + window <= r0 + 63;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pos = row0 + 8 * hh;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            float x = sc[4 * j + 2 * hh + v];
            x = softcap > 0.0f ? softcap * tanhf(x * scale / softcap) * kLog2e
                               : x * scale_log2;
            const int key = j0 + 8 * j + 2 * t + v;
            if (edge && (key > pos || key <= pos - window)) x = -INFINITY;
            sc[4 * j + 2 * hh + v] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        const float corr = ex2(m[hh] - m_use);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const float p = ex2(sc[4 * j + 2 * hh + v] - m_use);
            sc[4 * j + 2 * hh + v] = p;
            sum += p;
          }
        l[hh] = l[hh] * corr + sum;          // this lane's part of the row
        m[hh] = m_new;
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
          for (int j = 0; j < T::kOAcc / 4; ++j) {
            o[c][4 * j + 2 * hh] *= corr;
            o[c][4 * j + 2 * hh + 1] *= corr;
          }
      }
      // P as bf16 A fragments: k16 step ks is S columns 16 ks .. + 15.
#pragma unroll
      for (int ks = 0; ks < kBN / 16; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);

#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) fence_operands(o[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
        for (int ks = 0; ks < kBN / 16; ++ks)
          wgmma_rs(o[c], pa[ks],
                   mnmajor_desc<HD>(vd + c * kBN * T::kRow +
                                    16 * ks * T::kRow));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) fence_operands(o[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with it
  }
  if (!live) return;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int pos = row0 + 8 * hh;
    if (pos >= Tq) continue;
    const float inv = 1.0f / lt;             // the diagonal key: lt >= 1
    __nv_bfloat16* dst =
        out + ((static_cast<int64_t>(b) * Tq + pos) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < T::kOAcc / 4; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + c * T::kChunk + 8 * j +
                                           2 * t) =
            __floats2bfloat162_rn(o[c][4 * j + 2 * hh] * inv,
                                  o[c][4 * j + 2 * hh + 1] * inv);
  }
}

// (B, T, heads * HD) bf16 as a 3D tensor map read in boxes of (kChunk
// columns, rows, 1 sequence).
template <int HD>
bool head_map(CUtensorMap* map, const void* base, int B, int T, int heads,
              int rows) {
  const cuuint64_t width = static_cast<cuuint64_t>(heads) * HD;
  const cuuint64_t dims[3] = {width, static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {2 * width, 2 * width * T};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Tiles<HD>::kChunk),
                             static_cast<cuuint32_t>(rows), 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                    strides, box, Tiles<HD>::swizzle());
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Tq, int Tk, int H, int KV, int window,
                   float scale, float softcap, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!head_map<HD>(&qm, q, B, Tq, H, kBM) ||
      !head_map<HD>(&km, k, B, Tk, KV, kBN) ||
      !head_map<HD>(&vm, v, B, Tk, KV, kBN))
    return cudaErrorInvalidValue;
  constexpr int smem = Tiles<HD>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Tq + kBM - 1) / kBM, B);
  wgmma_kernel<HD><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), Tq, H, H / KV, window,
      scale, softcap);
  return cudaGetLastError();
}

}  // namespace wg

cudaError_t dispatch(bool bf16, int hd, const void* q, const void* k,
                     const void* v, void* out, int B, int Tq, int Tk, int H,
                     int KV, int window, float scale, float softcap,
                     cudaStream_t s) {
#define BAND_CASE(HD)                                                      \
  case HD:                                                                 \
    return bf16 ? wg::launch<HD>(q, k, v, out, B, Tq, Tk, H, KV, window,   \
                                 scale, softcap, s)                        \
                : ffma::launch_f32<HD>(q, k, v, out, B, Tq, Tk, H, KV,     \
                                       window, scale, softcap, s);
  switch (hd) {
    BAND_CASE(16)
    BAND_CASE(32)
    BAND_CASE(64)
    BAND_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BAND_CASE
}

}  // namespace

// q (B, Tq, H, hd), k and v (B, Tk, KV, hd) -> out (B, Tq, H * hd), all of
// one type: fp32 (bf16 = 0) or bf16 (bf16 = 1, each pointer 16-byte
// aligned, as a tensor map needs). softcap <= 0: none. Launches on
// `stream` (a cudaStream_t) of `device`; returns cudaGetLastError() after
// the launch.
extern "C" int banded_attn(const void* q, const void* k, const void* v,
                           void* out, int bf16, int B, int Tq, int Tk, int H,
                           int KV, int hd, int window, float scale,
                           float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool grid_ok =
      bf16 ? B <= 65535 && (Tq + wg::kBM - 1) / wg::kBM <= 65535
           : B * KV <= 65535;
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > ffma::kRows || Tq < 1 ||
      Tq > Tk || window < 1 || !grid_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  err = dispatch(bf16 != 0, hd, q, k, v, out, B, Tq, Tk, H, KV, window,
                 scale, softcap, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
