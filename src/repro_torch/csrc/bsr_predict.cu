// Block-sparse (BSR) predict for Hopper: scores = x @ W_pruned^T over the
// packed surviving blocks of a Delta-pruned DiSMEC model, in six variants
// of one loop (weights fp32 or int8 with per-block scales; every row block,
// a shared selection of row blocks, or each query's own selection).
//
// Replaces the TPU kernels of src/repro/kernels/bsr_predict/kernel.py:
//   bsr_predict_f32        `_bsr_kernel`               (exhaustive, fp32)
//   bsr_predict_int8       `_bsr_int8_kernel`          (exhaustive, int8)
//   bsr_gather_f32         `_bsr_gather_kernel`        (sel (B,), fp32)
//   bsr_gather_int8        `_bsr_gather_int8_kernel`   (sel (B,), int8)
//   bsr_gather_pq_f32      `_bsr_gather_pq_kernel`     (sel (n, B), fp32)
//   bsr_gather_pq_int8     `_bsr_gather_pq_int8_kernel` (sel (n, B), int8)
// Those walk the packed blocks in order on one core (a static grid whose
// padding steps are clamped and gated off) and keep a row's (n, bl) output
// tile resident across the row's blocks. Here blocks run in parallel and in
// no order, so one CTA owns one (output slot, label tile of 128, tile of TN
// instance rows) and loops over row_ptr[r] .. row_ptr[r+1] of its own row
// block r itself; the output tile lives in registers and is written once.
// The slot is the row block itself (exhaustive), sel[i] (shared selection:
// output columns [i*bl, (i+1)*bl)), or sel[q, i] with one x row (per
// query). A row block with no packed blocks writes exact zeros, which is
// also what the fully pruned sentinel (row_ptr all zeros) gives; so does a
// selected id outside [0, R).
//
// Every variant runs the same per-element FFMA sequence: a thread owns
// (row, label) pairs and adds their products in packed-block order, 16
// features at a time in ascending order, whatever TN is. So a sorted full
// selection reproduces the exhaustive kernel bit for bit, and the per-query
// kernel at n = 1 reproduces the shared one (both at TN = 8, rows 1-7
// zero-filled), in fp32 and in int8 alike. Int8 weights arrive through the
// same cp.async pipeline (16 features in one 16-byte piece) and are
// widened to fp32 in registers; each block's fp32 partial dot is kept
// apart, multiplied by the block's scale when the block ends and then
// added to the running output, with no FMA contraction: o += scale *
// dot(x, q), as the TPU kernels compute it. No atomics and no split-K:
// every sum runs in a fixed order.
//
// What bounds it on an H100: at serving batch sizes (n <= 32) the weight
// stream, every packed block it visits read once (632 MB fp32 at Wiki10-31K
// width, 0.19 ms at 3.35 TB/s; a quarter of that in int8); at n = 256 the
// fp32 FMAs (81 GFLOP, 1.2 ms at 67 TFLOP/s), which int8 does not reduce.
// The design: a 3-stage cp.async pipeline runs over the flat (block,
// 16-feature chunk) sequence of the row, so loads of the next blocks are in
// flight while the current chunk is multiplied, with no bubble at block
// boundaries; the CTA's TN row tiles of one row block are neighbours in
// launch order and share each weight block through L2. Each thread
// accumulates a (TN/8 rows x 4 labels) tile with FFMA (not TF32) from
// 16-byte shared-memory reads: fp32 weight rows are padded to 20 floats so
// the reads of a quarter warp hit distinct banks, int8 rows are 16
// contiguous bytes, and x reads broadcast. A selection of B row blocks
// launches only B * label tiles * row tiles CTAs (31 at n <= 8 with B = 31
// on 132 SMs), so the gathered kernels sit far from their bound at small n.
//
// Offsets into blocks, x and out are 64-bit: nb * bl * bd passes 2^31 at
// WikiLSHTC-325K scale. Requires bd % 4 == 0 (fp32) or bd % 16 == 0 (int8)
// for 16-byte copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLabelTile = 128;       // 32 lanes x 4 labels
constexpr int kChunk = 16;            // features per pipeline stage
constexpr int kStages = 3;

enum Mode { kAll = 0, kShared = 1, kPerQuery = 2 };

// Shared-memory layout of one stage's weight tile, per weight type.
template <typename WT> struct Tile;
template <> struct Tile<float> {
  static constexpr int kStride = kChunk + 4;   // padded row (elements)
  static constexpr int kPerPiece = 4;          // elements per 16 bytes
};
template <> struct Tile<int8_t> {
  static constexpr int kStride = kChunk;       // one 16-byte piece per row
  static constexpr int kPerPiece = 16;
};
constexpr int kXStride = kChunk + 4;           // x rows: padded floats

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;   // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stage `it` of the row's flat (block, chunk) sequence into smem.
template <typename WT, int TN>
__device__ __forceinline__ void load_stage(
    WT* ws, float* xs, int it, const float* __restrict__ x,
    const WT* __restrict__ blocks, const int* __restrict__ block_cols,
    int p_begin, int kchunks, int n, int n0, int l0, int Dp, int bl,
    int bd) {
  using T = Tile<WT>;
  const int p = p_begin + it / kchunks;
  const int k0 = (it % kchunks) * kChunk;
  const int c = block_cols[p];
  const WT* wblk = blocks + static_cast<int64_t>(p) * bl * bd;
  constexpr int kPieces = kChunk / T::kPerPiece;    // 16-byte pieces per row
  constexpr int kTile = kLabelTile * kPieces;       // 512 fp32, 128 int8
  // A trip count known at compile time, so the copies unroll (fp32: two
  // per thread, no bound check; int8: one, half the threads idle).
#pragma unroll
  for (int s = 0; s < (kTile + kThreads - 1) / kThreads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    if (kTile % kThreads != 0 && e >= kTile) break;
    const int j = e / kPieces, q = e % kPieces;
    const int l = l0 + j, k = k0 + T::kPerPiece * q;
    const bool valid = l < bl && k < bd;
    const WT* src =
        valid ? wblk + static_cast<int64_t>(l) * bd + k : blocks;
    cp_async16(ws + j * T::kStride + T::kPerPiece * q, src, valid);
  }
  constexpr int kXPieces = kChunk / 4;
  for (int e = threadIdx.x; e < TN * kXPieces; e += kThreads) {
    const int i = e / kXPieces, q = e % kXPieces;
    const int row = n0 + i, k = k0 + 4 * q;
    const bool valid = row < n && k < bd;
    const float* src =
        valid ? x + static_cast<int64_t>(row) * Dp +
                    static_cast<int64_t>(c) * bd + k
              : x;
    cp_async16(xs + i * kXStride + 4 * q, src, valid);
  }
}

// Four consecutive int8 weights (one 32-bit word, lowest byte first) as
// fp32.
__device__ __forceinline__ float4 widen(int v) {
  return make_float4(static_cast<float>(static_cast<signed char>(v)),
                     static_cast<float>(static_cast<signed char>(v >> 8)),
                     static_cast<float>(static_cast<signed char>(v >> 16)),
                     static_cast<float>(static_cast<signed char>(v >> 24)));
}

template <int RN>
__device__ __forceinline__ void ffma_tile(float (&acc)[RN][4],
                                          const float4 (&w)[4],
                                          const float4 (&xv)[RN]) {
#pragma unroll
  for (int p = 0; p < RN; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[p][q] = fmaf(xv[p].x, w[q].x, acc[p][q]);
      acc[p][q] = fmaf(xv[p].y, w[q].y, acc[p][q]);
      acc[p][q] = fmaf(xv[p].z, w[q].z, acc[p][q]);
      acc[p][q] = fmaf(xv[p].w, w[q].w, acc[p][q]);
    }
}

template <typename WT, int TN, int MODE>
__global__ void __launch_bounds__(kThreads)
bsr_kernel(const float* __restrict__ x, const WT* __restrict__ blocks,
           const float* __restrict__ scales,
           const int* __restrict__ block_cols,
           const int* __restrict__ row_ptr, const int* __restrict__ sel,
           float* __restrict__ out, int n, int Dp, int out_cols, int R,
           int B, int bl, int bd, int n_tiles, int label_tiles) {
  using T = Tile<WT>;
  constexpr bool kInt8 = sizeof(WT) == 1;
  constexpr int RN = TN / 8;   // rows per thread: warp w owns rows w + 8p
  __shared__ __align__(16) WT ws[kStages][kLabelTile * T::kStride];
  __shared__ __align__(16) float xs[kStages][TN * kXStride];

  const int nt = blockIdx.x % n_tiles;
  const int rt = blockIdx.x / n_tiles;
  const int slot = rt / label_tiles;
  const int l0 = (rt % label_tiles) * kLabelTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Per query: tile nt is query q, one x row; otherwise TN rows from n0.
  int r = slot, n0 = nt * TN, n_rows = n;
  int64_t out_row0 = 0;
  if constexpr (MODE == kShared) r = sel[slot];
  if constexpr (MODE == kPerQuery) {
    r = sel[static_cast<int64_t>(nt) * B + slot];
    x += static_cast<int64_t>(nt) * Dp;
    n0 = 0;
    n_rows = 1;
    out_row0 = nt;
  }
  const bool in_range = r >= 0 && r < R;
  const int p_begin = in_range ? row_ptr[r] : 0;
  const int kchunks = (bd + kChunk - 1) / kChunk;
  const int total = in_range ? (row_ptr[r + 1] - p_begin) * kchunks : 0;

  float acc[RN][4], part[RN][4];
#pragma unroll
  for (int p = 0; p < RN; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = part[p][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total)
      load_stage<WT, TN>(ws[s], xs[s], s, x, blocks, block_cols, p_begin,
                         kchunks, n_rows, n0, l0, Dp, bl, bd);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();   // stage `it` has landed (this thread)
    __syncthreads();                // ... for every thread; stage it-1 free
    const int nxt = it + kStages - 1;
    if (nxt < total)
      load_stage<WT, TN>(ws[nxt % kStages], xs[nxt % kStages], nxt, x,
                         blocks, block_cols, p_begin, kchunks, n_rows, n0,
                         l0, Dp, bl, bd);
    cp_async_commit();
    const WT* wsb = ws[it % kStages];
    const float* xsb = xs[it % kStages];
    if constexpr (kInt8) {
      int4 wq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wq[q] = *reinterpret_cast<const int4*>(wsb + (lane + 32 * q) *
                                               T::kStride);
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 4) {
        float4 w[4], xv[RN];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = widen(kk == 0 ? wq[q].x : kk == 4 ? wq[q].y
                       : kk == 8 ? wq[q].z : wq[q].w);
#pragma unroll
        for (int p = 0; p < RN; ++p)
          xv[p] = *reinterpret_cast<const float4*>(
              xsb + (warp + 8 * p) * kXStride + kk);
        ffma_tile<RN>(part, w, xv);
      }
      if (it % kchunks == kchunks - 1) {     // the block ends: o += s * dot
        const float s = scales[p_begin + it / kchunks];
#pragma unroll
        for (int p = 0; p < RN; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[p][q] = __fadd_rn(acc[p][q], __fmul_rn(s, part[p][q]));
            part[p][q] = 0.0f;
          }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 4) {
        float4 w[4], xv[RN];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = *reinterpret_cast<const float4*>(
              wsb + (lane + 32 * q) * T::kStride + kk);
#pragma unroll
        for (int p = 0; p < RN; ++p)
          xv[p] = *reinterpret_cast<const float4*>(
              xsb + (warp + 8 * p) * kXStride + kk);
        ffma_tile<RN>(acc, w, xv);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int p = 0; p < RN; ++p) {
    const int row = n0 + warp + 8 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = l0 + lane + 32 * q;
      if (row < n_rows && l < bl)
        out[(out_row0 + row) * out_cols + static_cast<int64_t>(slot) * bl +
            l] = acc[p][q];
    }
  }
}

template <typename WT, int TN, int MODE>
void launch(const float* x, const WT* blocks, const float* scales,
            const int* block_cols, const int* row_ptr, const int* sel,
            float* out, int n, int Dp, int out_cols, int R, int slots,
            int bl, int bd, cudaStream_t stream) {
  const int n_tiles = MODE == kPerQuery ? n : (n + TN - 1) / TN;
  const int label_tiles = (bl + kLabelTile - 1) / kLabelTile;
  const unsigned grid = static_cast<unsigned>(slots) * label_tiles *
                        n_tiles;   // < 2^31: checked by run()
  bsr_kernel<WT, TN, MODE><<<grid, kThreads, 0, stream>>>(
      x, blocks, scales, block_cols, row_ptr, sel, out, n, Dp, out_cols, R,
      slots, bl, bd, n_tiles, label_tiles);
}

// Checks the shape, picks TN by n (8 / 32 / 64; 8 per query) and launches
// on `stream` of `device`; returns cudaGetLastError() after the launch.
template <typename WT, int MODE>
int run(const float* x, const WT* blocks, const float* scales,
        const int* block_cols, const int* row_ptr, const int* sel,
        float* out, int n, int Dp, int R, int slots, int bl, int bd,
        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int label_tiles = (bl + kLabelTile - 1) / kLabelTile;
  const int64_t tiles = static_cast<int64_t>(slots) * label_tiles *
                        (MODE == kPerQuery ? n : (n + 7) / 8);
  const int piece = sizeof(WT) == 1 ? 16 : 4;
  if (n < 1 || slots < 1 || R < 1 || bd % piece != 0 || tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int out_cols = slots * bl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (MODE == kPerQuery || n <= 8)
    launch<WT, 8, MODE>(x, blocks, scales, block_cols, row_ptr, sel, out, n,
                        Dp, out_cols, R, slots, bl, bd, s);
  else if (n <= 32)
    launch<WT, 32, MODE>(x, blocks, scales, block_cols, row_ptr, sel, out,
                         n, Dp, out_cols, R, slots, bl, bd, s);
  else
    launch<WT, 64, MODE>(x, blocks, scales, block_cols, row_ptr, sel, out,
                         n, Dp, out_cols, R, slots, bl, bd, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, Dp) f32, blocks (nb, bl, bd) f32, block_cols (nb,) i32,
// row_ptr (n_row_blocks + 1,) i32 -> out (n, Lp) f32, every element written.
extern "C" int bsr_predict_f32(const float* x, const float* blocks,
                               const int* block_cols, const int* row_ptr,
                               float* out, int n, int Dp, int Lp,
                               int n_row_blocks, int bl, int bd, int device,
                               void* stream) {
  if (Lp != n_row_blocks * bl)
    return static_cast<int>(cudaErrorInvalidValue);
  return run<float, kAll>(x, blocks, nullptr, block_cols, row_ptr, nullptr,
                          out, n, Dp, n_row_blocks, n_row_blocks, bl, bd,
                          device, stream);
}

// As bsr_predict_f32 over int8 blocks with fp32 per-block scales (nb,).
extern "C" int bsr_predict_int8(const float* x, const int8_t* blocks,
                                const float* scales, const int* block_cols,
                                const int* row_ptr, float* out, int n,
                                int Dp, int n_row_blocks, int bl, int bd,
                                int device, void* stream) {
  return run<int8_t, kAll>(x, blocks, scales, block_cols, row_ptr, nullptr,
                           out, n, Dp, n_row_blocks, n_row_blocks, bl, bd,
                           device, stream);
}

// sel (B,) i32 row-block ids, any order -> out (n, B * bl) f32: columns
// [i*bl, (i+1)*bl) hold row block sel[i]'s scores.
extern "C" int bsr_gather_f32(const float* x, const float* blocks,
                              const int* block_cols, const int* row_ptr,
                              const int* sel, float* out, int n, int Dp,
                              int n_row_blocks, int B, int bl, int bd,
                              int device, void* stream) {
  return run<float, kShared>(x, blocks, nullptr, block_cols, row_ptr, sel,
                             out, n, Dp, n_row_blocks, B, bl, bd, device,
                             stream);
}

// As bsr_gather_f32 over int8 blocks with fp32 per-block scales (nb,).
extern "C" int bsr_gather_int8(const float* x, const int8_t* blocks,
                               const float* scales, const int* block_cols,
                               const int* row_ptr, const int* sel,
                               float* out, int n, int Dp, int n_row_blocks,
                               int B, int bl, int bd, int device,
                               void* stream) {
  return run<int8_t, kShared>(x, blocks, scales, block_cols, row_ptr, sel,
                              out, n, Dp, n_row_blocks, B, bl, bd, device,
                              stream);
}

// sel (n, B) i32, row q's own row-block ids -> out (n, B * bl) f32: row q's
// columns [i*bl, (i+1)*bl) hold row block sel[q, i]'s scores for x[q].
extern "C" int bsr_gather_pq_f32(const float* x, const float* blocks,
                                 const int* block_cols, const int* row_ptr,
                                 const int* sel, float* out, int n, int Dp,
                                 int n_row_blocks, int B, int bl, int bd,
                                 int device, void* stream) {
  return run<float, kPerQuery>(x, blocks, nullptr, block_cols, row_ptr, sel,
                               out, n, Dp, n_row_blocks, B, bl, bd, device,
                               stream);
}

// As bsr_gather_pq_f32 over int8 blocks with fp32 per-block scales (nb,).
extern "C" int bsr_gather_pq_int8(const float* x, const int8_t* blocks,
                                  const float* scales, const int* block_cols,
                                  const int* row_ptr, const int* sel,
                                  float* out, int n, int Dp,
                                  int n_row_blocks, int B, int bl, int bd,
                                  int device, void* stream) {
  return run<int8_t, kPerQuery>(x, blocks, scales, block_cols, row_ptr, sel,
                                out, n, Dp, n_row_blocks, B, bl, bd, device,
                                stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
