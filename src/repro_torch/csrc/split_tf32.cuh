// Split-fp32 ("3xTF32") tile engine on Hopper's tensor cores, shared by the
// training kernels (hinge.cu, hvp.cu).
//
// One CTA computes a 128 x 128 tile of
//   acc(m, n) = sum_k A(m, k) * B(n, k)
// with `wgmma.mma_async.m64n128k8.f32.tf32.tf32`, in fp32 accuracy: each
// operand x is split into big = x with its low 13 mantissa bits cleared
// (exactly TF32; x - big is exact in fp32) and small = x - big rounded to
// TF32, and each k-step adds small_a big_b + big_a small_b + big_a big_b.
// What is dropped (small_a small_b, and small's rounding) is below 2^-19
// of |a b|, where a single TF32 product keeps 2^-11.
//
//   A  X, the design matrix (N, D), row-major with any row stride: the
//      instance rows (pass A: A(m = i, k = d) = X[i, d]) or the feature
//      columns (pass B: A(m = d, k = i) = X[i, d]). Each thread loads its
//      wgmma A fragments from the shared stage and splits them in
//      registers. X's rows must start 16-byte aligned (the wrappers in
//      kernels/hinge/ops.py copy X into such rows, `aligned_rows`, when
//      they do not), so the stage comes by TMA in 128-byte-swizzled boxes,
//      whose fragment loads hit 32 banks (pass A) or 16 (pass B).
//   B  an operand already split by this file's kernels into two (rows, K)
//      arrays, big and small, whose rows are a multiple of 16 bytes apart:
//      the weights (pass A) or the kernel's own r or u (pass B), loaded as
//      2D TMA boxes of 32 k with the 128-byte swizzle that wgmma's K-major
//      descriptor reads. The two CTAs of a cluster take adjacent A tiles
//      and the same B rows; each loads 64 of the 128 B rows and multicasts
//      them to both, which cuts what a CTA reads from L2 per stage from 48
//      to 32 KB. TMA fills what lies outside the arrays with zeros.
//
// A ring of 4 stages of 32 k each, with a full and an empty mbarrier per
// stage; a stage is refilled when the consumers of both CTAs have released
// it. Two consumer warpgroups take 64 rows of A each and one producer warp
// issues the copies. Per stage a warpgroup issues its 12 wgmmas into a
// block accumulator (the first one overwrites it), waits for them, and
// adds the block into the tile's fp32 accumulator with FADD: the tensor
// cores' own accumulation is not IEEE round-to-nearest, so no chain of
// theirs is longer than 12 products of k8 (K = 101,938 would be 38,000 of
// them in one accumulator). The other warpgroup's wgmmas keep the tensor
// cores busy meanwhile.
//
// Nothing is atomic and every sum has a fixed order (no split-K), so two
// launches give identical bits. Offsets are 64-bit: N * D = 1.44e9 at
// Wiki10-31K width.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace split_tf32 {

using namespace hopper;

constexpr int kBM = 128;                 // A rows per CTA (2 x wgmma M)
constexpr int kBN = 128;                 // B rows per CTA (wgmma N)
constexpr int kBK = 32;                  // k per stage: one 128-byte row
constexpr int kStages = 4;
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kAcc = kBN / 2;            // fp32 accumulators per thread
constexpr unsigned kBigMask = 0xffffe000u;

// Shared A stage: pass A [kBM][kBK], pass B four boxes of [kBK][32
// features], 128-byte rows swizzled.
constexpr int kAStageBytes = kBM * kBK * 4;
constexpr int kBStageBytes = kBN * kBK * 4;    // one of big / small
// The two CTAs of a cluster take adjacent A tiles and the same B rows:
// each loads half of every B box and multicasts it to both.
constexpr int kCluster = 2;
constexpr int kBPart = kBN / kCluster;         // B rows each CTA loads
constexpr int kOffSmall = kStages * kBStageBytes;
constexpr int kOffA = 2 * kStages * kBStageBytes;
constexpr int kOffRed = kOffA + kStages * kAStageBytes;
constexpr int kOffBar = kOffRed + 8 * kBN * 4;
// 1 KB of slack aligns the swizzled B stages to 1024 bytes.
constexpr int kSmemBytes = 1024 + kOffBar + 2 * kStages * 8;

// Row stride (elements) of the split arrays: a multiple of 16 bytes, as a
// tensor map needs. The Python wrappers allocate with the same rule.
inline int padded(int n) { return (n + 3) / 4 * 4; }

// x = big + small: big exactly TF32 (truncated), small = x - big (exact)
// rounded to TF32.
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  big = __float_as_uint(x) & kBigMask;
  asm("cvt.rna.tf32.f32 %0, %1;"
      : "=r"(small) : "f"(__fsub_rn(x, __uint_as_float(big))));
}

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// The same barrier's arrival in the cluster's other CTA. It releases a
// stage whose reads have completed (the wgmmas waited for, the A fragments
// in registers), so it needs no cluster-scope release, which made every
// pass markedly slower on the card (PERF.md §6).
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(cluster_rank() ^ 1));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
               :: "r"(remote) : "memory");
}

// Every thread of both CTAs of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The 256 consumer threads only (the producer warp has left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// ------------------------------------------------------------------ copies

// The same box into this offset of both CTAs' shared memory, completing
// on the barrier at the same offset in each.
__device__ __forceinline__ void tma_load_both(void* dst,
                                              const CUtensorMap* map, int c0,
                                              int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar)), "h"(static_cast<uint16_t>(3))
      : "memory");
}

// Index (floats) of A(m, k) in an A stage (see kAStageBytes).
template <bool KMajor>
__device__ __forceinline__ int a_index(int m, int k) {
  if (KMajor) return m * kBK + ((((k >> 2) ^ (m & 7)) << 2) | (k & 3));
  return (m >> 5) * (kBK * 32) + k * 32 +
         (((((m & 31) >> 2) ^ (k & 7)) << 2) | (m & 3));
}

// ------------------------------------------------------------------- wgmma

// K-major operand in 128-byte-swizzled rows, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (+)= A (64 x 8, this thread's fragment a) . B (128 x 8 at desc)^T;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc],
                                           const unsigned (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

// ------------------------------------------------------------- the engine

struct Smem {
  unsigned char* b;           // big stages, then small stages (1024-aligned)
  float* a;                   // A stages
  float* red;                 // [8 consumer warps][kBN] epilogue partials
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  const unsigned base = smem_u32(raw);
  unsigned char* p = raw + ((1024 - (base & 1023)) & 1023);
  return Smem{p, reinterpret_cast<float*>(p + kOffA),
              reinterpret_cast<float*>(p + kOffRed),
              reinterpret_cast<uint64_t*>(p + kOffBar),
              reinterpret_cast<uint64_t*>(p + kOffBar) + kStages};
}

// Where a consumer thread's accumulator element sits in the tile: element
// 4j + 2h + v is A row row(h) and B row col(j, v) (wgmma's m64nN f32
// layout; warpgroup wg takes rows 64 wg .. 64 wg + 63).
struct Frag {
  int wg, warp, g, t;
  __device__ __forceinline__ Frag()
      : wg(threadIdx.x / 128), warp(threadIdx.x / 32),
        g(threadIdx.x % 32 / 4), t(threadIdx.x % 4) {}
  __device__ __forceinline__ int row(int h) const {
    return 64 * wg + 16 * (warp % 4) + g + 8 * h;
  }
  __device__ __forceinline__ int col(int j, int v) const {
    return 8 * j + 2 * t + v;
  }
};

// acc = A[m0 : m0 + 128, :] . B[n0 : n0 + 128, :]^T over all K, A from X
// (KMajor: A(m, k) = X[m, k], pass A; else A(m, k) = X[k, m], pass B) by
// TMA through xmap, B from the big/small tensor maps. Returns false on the
// producer warp, which has no tile; the consumers' accumulators are in
// `acc`.
template <bool KMajor>
__device__ __forceinline__ bool mainloop(float (&acc)[kAcc], const Smem& sm,
                                         const CUtensorMap* xmap,
                                         const CUtensorMap* bbig,
                                         const CUtensorMap* bsmall, int K,
                                         int m0, int n0) {
  const int ktiles = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {   // lane 0's boxes
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kCluster * kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();                         // both CTAs' barriers are ready

  if (threadIdx.x >= kConsumers) {        // the producer warp
    const int lane = threadIdx.x - kConsumers;
    const int part = static_cast<int>(cluster_rank()) * kBPart;
    // Stage s is free once both CTAs' consumers released its last use;
    // the last kStages waits leave no copy or arrival of the other CTA
    // still to come, so this CTA may exit.
    for (int it = 0; it < ktiles + kStages; ++it) {
      const int s = it % kStages, k0 = it * kBK;
      mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
      if (it >= ktiles) continue;
      float* a = reinterpret_cast<float*>(
          reinterpret_cast<unsigned char*>(sm.a) + s * kAStageBytes);
      if (lane == 0) {
        mbar_expect(&sm.full[s], 2 * kBStageBytes + kAStageBytes);
        const int b = s * kBStageBytes + part * kBK * 4;
        tma_load_both(sm.b + b, bbig, k0, n0 + part, &sm.full[s]);
        tma_load_both(sm.b + kOffSmall + b, bsmall, k0, n0 + part,
                      &sm.full[s]);
        if (KMajor)
          tma_load(a, xmap, k0, m0, &sm.full[s]);
        else
          for (int q = 0; q < kBM / 32; ++q)
            tma_load(a + q * kBK * 32, xmap, m0 + 32 * q, k0, &sm.full[s]);
      }
    }
    return false;
  }

  const Frag fr;
  const int r = 64 * fr.wg + 16 * (fr.warp % 4) + fr.g;   // A row (h = 0)
  float blk[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  for (int it = 0; it < ktiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    const float* a = reinterpret_cast<const float*>(
        reinterpret_cast<const unsigned char*>(sm.a) + s * kAStageBytes);
    unsigned big[4][4], small[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {      // wgmma's tf32 A fragment order
        const int m = r + 8 * (e & 1), k = 8 * j + fr.t + 4 * (e >> 1);
        split(a[a_index<KMajor>(m, k)], big[j][e], small[j][e]);
      }
    const uint64_t dbig = sw128_desc(sm.b + s * kBStageBytes);
    const uint64_t dsmall = sw128_desc(sm.b + kOffSmall + s * kBStageBytes);
    fence_operands(blk);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)            // k8 step j: 32 bytes on
      wgmma_tf32(blk, small[j], dbig + 2 * j, j > 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_tf32(blk, big[j], dsmall + 2 * j, 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_tf32(blk, big[j], dbig + 2 * j, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(blk);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], blk[i]);
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      mbar_arrive(&sm.empty[s]);
      mbar_arrive_peer(&sm.empty[s]);
    }
  }
  return true;
}

// Each consumer thread's part[j][v] (for B row col(j, v)) summed over the
// tile's 128 A rows in a fixed order; thread c < 128 gets B row c's sum.
__device__ __forceinline__ float tile_row_sums(float (&part)[kAcc / 4][2],
                                               const Smem& sm,
                                               const Frag& fr) {
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      float p = part[j][v];
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 4));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 8));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 16));
      if (fr.g == 0) sm.red[fr.warp * kBN + fr.col(j, v)] = p;
    }
  consumer_sync();
  float total = 0.0f;
  if (threadIdx.x < kBN)
#pragma unroll
    for (int w = 0; w < kConsumers / 32; ++w)
      total = __fadd_rn(total, sm.red[w * kBN + threadIdx.x]);
  return total;
}

// big = x & kBigMask and small = rna_tf32(x - big) of an (L, D) row-major
// array, into two (L, ld) arrays (pass A's B operand).
__global__ void split_rows_kernel(const float* __restrict__ src,
                                  float* __restrict__ big,
                                  float* __restrict__ small, int L, int D,
                                  int ld) {
  for (int l = blockIdx.y; l < L; l += gridDim.y)
    for (int d = blockIdx.x * blockDim.x + threadIdx.x; d < D;
         d += gridDim.x * blockDim.x) {
      unsigned b, s;
      split(src[static_cast<int64_t>(l) * D + d], b, s);
      const int64_t o = static_cast<int64_t>(l) * ld + d;
      big[o] = __uint_as_float(b);
      small[o] = __uint_as_float(s);
    }
}

// out = 2 W + two_c (R . X) for R (L, N) given split as two (L, ldn)
// arrays behind rbig/rsmall, X (N, D) behind xmap, W and out (L, D):
// pass B of both training kernels (the gradient, the Hessian-vector
// product), computed as out^T = X^T R^T over 128 features x 128 labels a
// CTA. With `RowNorms`, each tile also writes its partial sum of W^2 per
// label to wpart[l * gridDim.y + blockIdx.y].
template <bool RowNorms>
__global__ void __cluster_dims__(1, kCluster, 1)
__launch_bounds__(kThreads, 1)
reg_plus_rx_kernel(const __grid_constant__ CUtensorMap rbig,
                   const __grid_constant__ CUtensorMap rsmall,
                   const __grid_constant__ CUtensorMap xmap,
                   const float* __restrict__ W, float* __restrict__ out,
                   float* __restrict__ wpart, int L, int N, int D,
                   float two_c) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;  // labels, features
  float acc[kAcc];
  if (!mainloop<false>(acc, sm, &xmap, &rbig, &rsmall, N, m0, n0)) return;
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
        const int d = m0 + fr.row(h);
        if (l < L && d < D) {
          const int64_t o = static_cast<int64_t>(l) * D + d;
          const float w = W[o];
          out[o] = __fadd_rn(__fmul_rn(2.0f, w),
                             __fmul_rn(two_c, acc[4 * j + 2 * h + v]));
          if (RowNorms) part[j][v] = fmaf(w, w, part[j][v]);
        }
      }
    }
  if (RowNorms) {
    const float total = tile_row_sums(part, sm, fr);
    if (threadIdx.x < kBN && n0 + threadIdx.x < L)
      wpart[static_cast<int64_t>(n0 + threadIdx.x) * gridDim.y +
            blockIdx.y] = total;
  }
}

// ------------------------------------------------------------------- host

// An (rows, K) fp32 array, rows ld floats apart, read in box_rows x 32-k
// boxes with the 128-byte swizzle; what lies outside arrives as zeros.
inline bool operand_map(CUtensorMap* map, const float* base, int K,
                        int rows, int64_t ld, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Splits src (L, D) into big and small (L, padded(D)).
inline cudaError_t split_rows(const float* src, float* big, float* small,
                              int L, int D, cudaStream_t s) {
  const int gx = (D + 255) / 256;
  const dim3 grid(static_cast<unsigned>(gx < 64 ? gx : 64),
                  static_cast<unsigned>(L < 65535 ? L : 65535));
  split_rows_kernel<<<grid, 256, 0, s>>>(src, big, small, L, D, padded(D));
  return cudaGetLastError();
}

// Grid of 128-row B tiles (x, labels) by 128-row A tiles (y), y rounded
// up to whole clusters (a tile past the A rows reads zeros and writes
// nothing but zero partial sums); false when it exceeds what a launch
// takes.
inline bool tile_grid(int b_rows, int a_rows, dim3* grid) {
  const int gx = (b_rows + kBN - 1) / kBN;
  const int gy = ((a_rows + kBM - 1) / kBM + kCluster - 1) / kCluster *
                 kCluster;
  if (gx < 1 || gy < 1 || gy > 65535) return false;
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  return true;
}

// What a training kernel's launches need: the grids of passes A (labels x
// instances) and B (labels x features), the tensor maps of pass A's B
// operand (the split (L, D) weights), of pass B's (the split (L, N) r or
// u) and of X for each pass (128 rows x 32 features; 32 x 32, four a
// stage).
struct Maps {
  dim3 grid_a, grid_b;
  CUtensorMap bbig, bsmall, rbig, rsmall, xa, xb;

  // false when a shape is out of range, X's rows do not all start 16-byte
  // aligned (a tensor map's rule), or a map cannot be made.
  bool encode(const float* wsplit, const float* rsplit, const float* X,
              int L, int N, int D, int64_t ldx) {
    if (L < 1 || N < 1 || D < 1 || ldx < D || ldx % 4 != 0 ||
        reinterpret_cast<uintptr_t>(X) % 16 != 0 ||
        !tile_grid(L, N, &grid_a) || !tile_grid(L, D, &grid_b))
      return false;
    const int ldd = padded(D), ldn = padded(N);
    return operand_map(&bbig, wsplit, D, L, ldd, kBPart) &&
           operand_map(&bsmall, wsplit + static_cast<int64_t>(L) * ldd, D, L,
                       ldd, kBPart) &&
           operand_map(&rbig, rsplit, N, L, ldn, kBPart) &&
           operand_map(&rsmall, rsplit + static_cast<int64_t>(L) * ldn, N,
                       L, ldn, kBPart) &&
           operand_map(&xa, X, D, N, ldx, kBM) &&
           operand_map(&xb, X, D, N, ldx, kBK);
  }
};

// Launches a kernel of this engine with its dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace split_tf32
