// Block-sparse (BSR) predict for Hopper: scores = x @ W_pruned^T over the
// packed surviving blocks of a Delta-pruned DiSMEC model, in six variants
// of one loop, in four kernels (weights fp32 or int8 with per-block
// scales; every row block, a shared selection of row blocks, or each
// query's own selection).
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
// no order, so one CTA owns one (row block r, label tile, tile of rows)
// and loops over row_ptr[r] .. row_ptr[r+1] itself; the output tile lives
// in registers and is written once. r is the output slot itself
// (exhaustive) or sel[i] (shared selection: output columns [i*bl,
// (i+1)*bl)); per query, the rows are the (query, slot) pairs that chose
// r. A row block with no packed blocks writes exact zeros, which is also
// what the fully pruned sentinel (row_ptr all zeros) gives; so does a
// selected id outside [0, R).
//
// Every variant runs the same per-element FFMA sequence: a thread owns
// (row, label) pairs and adds their products in packed-block order,
// features in ascending order, one FFMA each, whatever the tile. The
// kernels below split only labels and rows across threads and CTAs, never
// a row block's blocks or features (no split-K); `bsr_kernel`'s zero-filled
// features past bd add an exact +0, and the others stop at bd. So a sorted
// full selection reproduces the exhaustive kernel bit for bit, and each row
// of the per-query kernel reproduces the shared one on that row alone, in
// fp32 and in int8 alike. Int8 weights are widened to fp32 exactly; each
// block's fp32 partial dot is kept apart, multiplied by the block's scale
// when the block ends and then added to the running output, with no FMA
// contraction: o += scale * dot(x, q), as the TPU kernels compute it. No
// atomics: every sum runs in a fixed order.
//
// What bounds it on an H100: at serving batch sizes (n <= 32) the weight
// stream, every packed block it visits read once (632 MB fp32 at Wiki10-31K
// width, 0.19 ms at 3.35 TB/s; a quarter of that in int8); at n = 256 the
// fp32 FMAs (81 GFLOP, 1.2 ms at 67 TFLOP/s), which int8 does not reduce.
//
// `ex_kernel`, the exhaustive fp32 kernel at every n (`gather_kernel` with
// each row block its own slot was slower at every n measured, 1 to 64,
// PERF.md, kernel 3). Small
// stages that every thread addresses itself, a __syncthreads each, keep
// `bsr_kernel` (below) under half of this bound. Here:
//   - one CTA per (row block r, 128 labels, row tile), the row tile fastest
//     in launch order, so the CTAs of r read its blocks from HBM about once;
//     the row tile is fixed by n at compile time: 16 rows to n = 16 (2 x 8
//     a thread, three CTAs an SM), 32 to n = 32 (4 x 8, two), 64 above
//     (8 x 8, two);
//   - a producer warp walks r's packed blocks in order, 32 features a
//     stage, and lands each stage on a 4-stage mbarrier ring as two TMA
//     boxes, the weights (128 label rows) and x (the tile's rows at the
//     block's column), each row 128 bytes stored with the 128-byte swizzle
//     (piece c of row j at piece c ^ (j % 8)); it stages the row block's
//     columns 32 at a time from one warp load; consumers release a stage on
//     an empty barrier, and nothing else synchronises them;
//   - consumer lanes are 8 along labels x 4 along rows, a thread's labels
//     8 apart and rows 4 apart, so the 16-byte reads of the 8 lanes of a
//     quarter warp hit 8 distinct pieces of 8 swizzled rows (distinct
//     banks), and the 4 row groups of a warp read x as broadcasts.
// What bounds it after that (H100 80GB HBM3, 700 W; PERF.md, kernel 3):
// to n = 16 the weight stream at ~2.6 TB/s; at n = 32 both the stream and
// the FFMAs; above, the FFMAs at ~60% of the 67 TFLOP/s peak, whatever the
// tile of 64 or 128 rows (8 x 8 or 4 x 8 a thread, one to three CTAs an
// SM); what holds them there is not measured.
//
// `bsr_kernel`, the exhaustive int8 kernel above its switch and the shared
// selection at n > 64 (below): a 3-stage cp.async pipeline runs over the
// flat (block, 16-feature chunk) sequence of the row, so loads of the next
// blocks are in flight while the current chunk is multiplied, with no
// bubble at block boundaries; the CTA's TN row tiles of one row block are
// neighbours in launch order and share each weight block through L2. Each
// thread accumulates a (TN/8 rows x 4 labels) tile with FFMA (not TF32)
// from 16-byte shared-memory reads: fp32 weight rows are padded to 20
// floats so the reads of a quarter warp hit distinct banks, int8 rows are
// 16 contiguous bytes (16 features in one cp.async piece, widened in
// registers), and x reads broadcast.
//
// `gather_kernel`, the gathered (shared selection) kernels at n <= 64, the fine
// stage of shortlist serving, and the exhaustive int8 kernel at n up to the
// switch its caller passes (each row block its own slot: 968 CTAs at R =
// 242, bl = 128, where `bsr_kernel` ran 242). A selection of B = 31 of 242 row
// blocks is ~1,240 blocks (81 MB fp32, 20 MB int8). `bsr_kernel`'s 128-label
// tile gave it 31 CTAs on 132 SMs with 2 x 8 KB in flight each: latency-bound
// at a tenth of the memory rate. Here:
//   - one CTA owns (slot, 32 labels) and all n rows: 124 CTAs at B = 31,
//     bl = 128, each streaming its 32 label rows of each block;
//   - thread 0 fills a ring of stages, each one block's 128 features, with
//     two TMA box copies (a tensor map over blocks as (nb * bl, bd) and one
//     over x), completing on an mbarrier: 8 stages at n <= 8, 4 above, so
//     ~119 KB (fp32) or ~36 KB (int8) of weights are in flight per SM,
//     several times what Little's law asks at ~1 us. Per-row 1D bulk
//     copies (33 a stage) and per-thread 16-byte cp.async copies were
//     tried first: both stalled on the number of requests, not bytes, at
//     under 1 TB/s. The boxes are 16 bytes wider than the stage, which
//     pads their rows in shared memory so lanes reading 8 rows at one
//     feature hit distinct banks; past bd, n and Dp they arrive as zeros;
//   - block_cols (and the int8 scales) of the row block are staged in
//     shared memory once a pass of up to 256 blocks, while the first
//     stages' weight copies (which need the block, not its column) are in
//     flight; a longer row takes more passes;
//   - at n <= 8 lanes map to labels and each warp to one row (n warps, no
//     padded row), and a lane widens its own int8 row in registers; at
//     9 <= n <= 64 lanes form 8 labels x 4 rows, a thread owning 4 labels
//     x RN rows (RN = 1 to n = 16, else 2), and each int8 stage is widened
//     once a CTA into an fp32 tile. Widening is a byte permute and an FADD
//     (exact) instead of an I2F at a quarter of their rate.
// What bounds it after that, on an H100 at 700 W: the weight stream at
// n = 1 fp32 (~2.1 TB/s reached); the one dependent chain of 40 x 128
// FFMAs per output element at n = 1 int8 (>= 11.7 us at 4 cycles each,
// with the launch and the first loads ~16 us); shared-memory reads per
// FFMA (3 bytes a thread-FFMA at RN = 2) at n = 32 and 64.
// At n > 64 the gathered kernels run `bsr_kernel` at TN = 64, whose
// 128 x 64 tile needs fewer shared-memory reads per FFMA once n fills it.
//
// `pq_kernel`, the per-query kernels (sel (n, B): each query its own B row
// blocks, the fine stage of per-query shortlist serving). The TPU kernels
// step through (query, slot, block), and `bsr_kernel` ran one CTA per
// (query, slot) until this design: each streamed its row block's ~40
// blocks for one x row, n * B * 40 blocks of 64 KB at n = 256, B = 31
// (20.8 GB of fp32 weights, read again once per query, where the union of
// the selected row blocks is under 0.74 GB), and 7 of its 8 warps
// multiplied zero-filled rows. Here the row block comes first:
//   - one CTA per (row block r, chunk of up to 8 * RN of the (query, slot)
//     pairs that chose r, label tile of 32 * LN labels), the label tile
//     fastest in launch order and then the chunk, so the CTAs of one r
//     share its blocks through L2; r = R stands for every id outside
//     [0, R) and writes their zeros, so every output element is written;
//   - the CTA finds its pairs itself: it scans sel (n * B int32, 31 KB at
//     n = 256) in passes of 8,192 entries, each thread keeping the warp
//     ballot of 32 of them, and a CTA-wide prefix of their counts places
//     the chunk's pairs in (q, i) order; no sort and no other launch. A row
//     block chosen more often than the grid's chunks hold (repeated ids)
//     is served by the same CTAs in further rounds;
//   - r's packed blocks stream once a CTA through a TMA ring, as in
//     gather_kernel; a stage's x rows (x[q] at the block's column) are no
//     box, and TMA has no row gather, so warp 0 issues a one-row box a pair
//     (512 bytes, each 128-byte aligned as TMA asks);
//   - a lane owns LN labels 32 apart and warp w pairs w, w + 8, ..., so x
//     reads broadcast; a chunk of np pairs spreads over min(np, 8) warps,
//     each multiplying only the ceil(np / 8) rows it holds (rounded up to
//     a power of two), and the other warps only wait; a lane widens its own
//     int8 rows in registers;
//   - (LN, RN) by n: (1, 1) at n <= 8, (1, 4) at n <= 32, (2, 8) above, the
//     64-label tile halving how often each x row is read where the chunks
//     fill (32- and 64-label tiles at every n measured once, PERF.md).
// What bounds it after that, on an H100 at 700 W (times in PERF.md): at
// n <= 64 the weight stream of the union of the selected row blocks, and in
// int8 at n <= 8 each CTA's dependent chain of 5,120 FFMAs (hence three
// CTAs an SM there); at n = 256 the FFMAs, well under the fp32 peak: a
// chunk of ~33 pairs multiplies 8 rows a warp where 5 hold pairs, and each
// stage's x rows are ~33 TMA requests (neither share measured apart).
// The scan's cost grows with R: every one of the (R + 1) * chunks * label
// tiles CTAs reads all of sel, (R + 1) * chunks * tiles * n * B * 4 bytes
// from L2 a launch: 62 MB at n = 256 and Wiki10-31K width (R = 242, B =
// 31), but 6.6 GB at WikiLSHTC-325K's (R = 2,540, B = 318), likely more
// than the weight stream there. Only Wiki10-31K width is measured; past
// it, a pre-pass that buckets sel by row block (its time counted in the
// kernel's) would read sel once.
//
// Offsets into blocks, x and out are 64-bit: nb * bl * bd passes 2^31 at
// WikiLSHTC-325K scale. Requires bd % 4 == 0 (fp32) or bd % 16 == 0 (int8)
// for 16-byte copies.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kLabelTile = 128;       // 32 lanes x 4 labels
constexpr int kChunk = 16;            // features per pipeline stage
constexpr int kStages = 3;

enum Mode { kAll = 0, kShared = 1 };

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
           int bl, int bd, int n_tiles, int label_tiles) {
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

  const int n0 = nt * TN;
  const int r = MODE == kShared ? sel[slot] : slot;
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
                         kchunks, n, n0, l0, Dp, bl, bd);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();   // stage `it` has landed (this thread)
    __syncthreads();                // ... for every thread; stage it-1 free
    const int nxt = it + kStages - 1;
    if (nxt < total)
      load_stage<WT, TN>(ws[nxt % kStages], xs[nxt % kStages], nxt, x,
                         blocks, block_cols, p_begin, kchunks, n, n0,
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
      if (row < n && l < bl)
        out[static_cast<int64_t>(row) * out_cols +
            static_cast<int64_t>(slot) * bl + l] = acc[p][q];
    }
  }
}

template <typename WT, int TN, int MODE>
void launch(const float* x, const WT* blocks, const float* scales,
            const int* block_cols, const int* row_ptr, const int* sel,
            float* out, int n, int Dp, int out_cols, int R, int slots,
            int bl, int bd, cudaStream_t stream) {
  const int n_tiles = (n + TN - 1) / TN;
  const int label_tiles = (bl + kLabelTile - 1) / kLabelTile;
  const unsigned grid = static_cast<unsigned>(slots) * label_tiles *
                        n_tiles;   // < 2^31: checked by run()
  bsr_kernel<WT, TN, MODE><<<grid, kThreads, 0, stream>>>(
      x, blocks, scales, block_cols, row_ptr, sel, out, n, Dp, out_cols, R,
      bl, bd, n_tiles, label_tiles);
}

// ---- `gather_kernel`: the shared selection at n <= 64 (see the note) ----

constexpr int kGLabels = 32;            // label tile: a weight box's rows
constexpr int kGStaged = 256;           // block_cols (and scales) a pass
constexpr int kGMaxWarps = 8;
constexpr int kGMaxRows = 64;           // n the kernel serves

// A stage is kGFeatures features of one block (a whole row at the usual bd
// = 128): a weight box of 32 label rows and an x box of the CTA's rows,
// one TMA copy each. Both boxes are 16 bytes wider than the stage (their
// pitch), which pads their rows in shared memory: 8 lanes reading 16 bytes
// of 8 rows at one feature hit distinct banks. The extra features are
// never read.
constexpr int kGFeatures = 128;
constexpr int kXPitch = kGFeatures + 4;                 // floats
template <typename WT> struct Gather;
template <> struct Gather<float> {
  static constexpr int kPitch = kGFeatures + 4;         // elements
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct Gather<int8_t> {
  static constexpr int kPitch = kGFeatures + 16;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// Ring depth: 8 stages at n <= 8 (at most 22 KB each); 4 above, where an
// x box of up to 64 rows takes 33 KB.
template <int LANES_L>
__host__ __device__ constexpr int gather_stages() {
  return LANES_L == 32 ? 8 : 4;
}

__host__ __device__ constexpr int round_kb(int bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

// Shared-memory bytes of one stage's weight and x boxes (each started on a
// 1 KB boundary), and of one widened fp32 tile.
template <typename WT>
__host__ __device__ constexpr int wbox_bytes() {
  return round_kb(kGLabels * Gather<WT>::kPitch *
                  static_cast<int>(sizeof(WT)));
}
__host__ __device__ constexpr int xbox_bytes(int rows_box) {
  return round_kb(rows_box * kXPitch * 4);
}
constexpr int kWideBytes = kGLabels * kXPitch * 4;

// Dynamic shared memory for x boxes of `rows_box` rows: 1 KB of slack to
// align the boxes, the ring's boxes, two widened fp32 tiles (int8 at
// n > 8), the ring's barriers, and the staged columns and scales.
template <typename WT, int LANES_L>
int gather_smem(int rows_box) {
  constexpr bool widen = sizeof(WT) == 1 && LANES_L != 32;
  return 1024 +
         gather_stages<LANES_L>() *
             (wbox_bytes<WT>() + xbox_bytes(rows_box) + 8) +
         (widen ? 2 * kWideBytes : 0) + 2 * kGStaged * 4;
}

// Four int8 weights (one 32-bit word, lowest byte first) as fp32, exactly:
// byte b ^ 0x80 is b + 128 in [0, 255]; placed under the exponent of 2^23
// (0x4b0000xx) it reads 2^23 + b + 128, and subtracting 2^23 + 128 leaves
// b. A byte permute and an FADD per weight, where a cast is an I2F at a
// quarter of their rate.
__device__ __forceinline__ float widen_byte(unsigned biased, unsigned sel) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4b000000u, sel)),
                   8388736.0f);
}

__device__ __forceinline__ float4 widen_exact(int v) {
  const unsigned u = static_cast<unsigned>(v) ^ 0x80808080u;
  return make_float4(widen_byte(u, 0x7440), widen_byte(u, 0x7441),
                     widen_byte(u, 0x7442), widen_byte(u, 0x7443));
}

__device__ __forceinline__ void fma4(float& t, const float4 x,
                                     const float4 w) {
  t = fmaf(x.x, w.x, t);
  t = fmaf(x.y, w.y, t);
  t = fmaf(x.z, w.z, t);
  t = fmaf(x.w, w.w, t);
}

// Features k .. k+3 into a thread's (RN rows x LN labels) tile, from fp32
// rows: its labels' weight rows LANES_L rows apart from `w` (rows wpitch
// floats apart), its x rows 32 / LANES_L rows apart from `xr` (xpitch).
template <int LANES_L, int RN, int LN>
__device__ __forceinline__ void ffma_step(float (&t)[RN][LN], const float* w,
                                          const float* xr, int wpitch,
                                          int xpitch, int k) {
  float4 wv[LN], xv[RN];
#pragma unroll
  for (int q = 0; q < LN; ++q)
    wv[q] = *reinterpret_cast<const float4*>(w + q * LANES_L * wpitch + k);
#pragma unroll
  for (int p = 0; p < RN; ++p)
    xv[p] = *reinterpret_cast<const float4*>(xr + p * (32 / LANES_L) *
                                                      xpitch + k);
#pragma unroll
  for (int p = 0; p < RN; ++p)
#pragma unroll
    for (int q = 0; q < LN; ++q) fma4(t[p][q], xv[p], wv[q]);
}

// Grid: slots x label tiles of 32. Block: warps of 32 lanes, LANES_L along
// labels and 32 / LANES_L along rows; a thread owns RN rows and
// 32 / LANES_L labels, each strided by its lanes, so a warp covers
// 32 / LANES_L * RN consecutive rows and all 32 labels. Thread 0 issues
// every copy: each stage's weight box of rows (block, l0 .. l0 + 31) and
// x box of rows 0 .. rows_box - 1, zero-filled past bd, n and Dp.
template <typename WT, int LANES_L, int RN>
__global__ void __launch_bounds__(kGMaxWarps * 32)
gather_kernel(const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap xmap,
              const float* __restrict__ scales,
              const int* __restrict__ block_cols,
              const int* __restrict__ row_ptr, const int* __restrict__ sel,
              float* __restrict__ out, int n, int out_cols, int R, int bl,
              int bd, int label_tiles, int rows_box) {
  constexpr bool kInt8 = sizeof(WT) == 1;
  constexpr bool kWiden = kInt8 && LANES_L != 32;   // widen once a CTA
  constexpr int F = kGFeatures;
  constexpr int WP = Gather<WT>::kPitch;
  constexpr int XP = kXPitch;
  constexpr int S = gather_stages<LANES_L>();
  constexpr int LN = 32 / LANES_L;     // labels a thread
  constexpr int LR = 32 / LANES_L;     // lanes along rows
  constexpr int WR = LR * RN;          // rows a warp
  constexpr int WB = wbox_bytes<WT>();
  const int XB = xbox_bytes(rows_box);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_w =
      smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* ring_x = ring_w + S * WB;
  float* wide = reinterpret_cast<float*>(ring_x + S * XB);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(wide) + (kWiden ? 2 * kWideBytes : 0));
  int* cols_s = reinterpret_cast<int*>(full + S);
  float* scl_s = reinterpret_cast<float*>(cols_s + kGStaged);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ll = lane % LANES_L;
  const int row0 = warp * WR + lane / LANES_L;
  const int slot = blockIdx.x / label_tiles;
  const int l0 = (blockIdx.x % label_tiles) * kGLabels;
  const int r = sel != nullptr ? sel[slot] : slot;   // null: exhaustive
  const bool in_range = r >= 0 && r < R;
  const int p_begin = in_range ? row_ptr[r] : 0;
  const int p_end = in_range ? row_ptr[r + 1] : 0;
  const int kchunks = (bd + F - 1) / F;
  const unsigned stage_bytes =
      kGLabels * WP * sizeof(WT) + rows_box * XP * 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  float acc[RN][LN], part[RN][LN];
#pragma unroll
  for (int p = 0; p < RN; ++p)
#pragma unroll
    for (int q = 0; q < LN; ++q) acc[p][q] = part[p][q] = 0.0f;

  // Stage g of the CTA (over all passes) sits in ring slot g % S, and its
  // barrier completes phase g / S.
  unsigned g = 0;
  for (int pc = p_begin; pc < p_end; pc += kGStaged) {
    const int nblk = min(kGStaged, p_end - pc);
    const int total = nblk * kchunks;   // this pass's stages
    auto issue_w = [&](int it) {
      const int s = (g + it) % S;
      mbar_expect(&full[s], stage_bytes);
      tma_load(ring_w + s * WB, &wmap, it % kchunks * F,
               (pc + it / kchunks) * bl + l0, &full[s]);
    };
    auto issue_x = [&](int it) {
      const int s = (g + it) % S;
      tma_load(ring_x + s * XB, &xmap,
               cols_s[it / kchunks] * bd + it % kchunks * F, 0, &full[s]);
    };

    __syncthreads();        // barriers set up; the last pass is done
    // The first stages' weights need the block, not its column: in flight
    // while the columns (and scales) are staged.
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int it = 0; it < S - 1 && it < total; ++it) issue_w(it);
    }
    for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
      cols_s[i] = block_cols[pc + i];
      if constexpr (kInt8) scl_s[i] = scales[pc + i];
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int it = 0; it < S - 1 && it < total; ++it) issue_x(it);

    for (int it = 0; it < total; ++it) {
      const unsigned gs = g + it;
      const int s = gs % S;
      const int k0 = it % kchunks * F;
      const int kend = min(F, bd - k0);
      mbar_wait(&full[s], (gs / S) & 1);
      const WT* wst = reinterpret_cast<const WT*>(ring_w + s * WB);
      const float* xst =
          reinterpret_cast<const float*>(ring_x + s * XB) + row0 * XP;
      const float* wf = reinterpret_cast<const float*>(wst);
      if constexpr (kWiden) {   // the int8 box -> an fp32 tile, once a CTA
        float* wd = wide + (gs & 1) * (kWideBytes / 4);
        for (int e = threadIdx.x; e < kGLabels * F / 16; e += blockDim.x) {
          const int j = e % kGLabels, k = e / kGLabels * 16;   // lanes: rows
          const int4 v = *reinterpret_cast<const int4*>(
              reinterpret_cast<const int8_t*>(wst) + j * WP + k);
          float4* d = reinterpret_cast<float4*>(wd + j * XP + k);
          d[0] = widen_exact(v.x);
          d[1] = widen_exact(v.y);
          d[2] = widen_exact(v.z);
          d[3] = widen_exact(v.w);
        }
        wf = wd;
      }
      __syncthreads();      // stage `it` ready to read; stage it-1 done
      if (threadIdx.x == 0 && it + S - 1 < total) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_w(it + S - 1);
        issue_x(it + S - 1);
      }
      float (&t)[RN][LN] = kInt8 ? part : acc;
      if constexpr (kInt8 && !kWiden) {
        // One label a lane (LANES_L == 32): the lane widens its own row,
        // 16 features at a time.
        const int8_t* wr = reinterpret_cast<const int8_t*>(wst) + ll * WP;
        auto step16 = [&](int k) {
          const int4 v = *reinterpret_cast<const int4*>(wr + k);
          const int vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float4 w = widen_exact(vw[h]);
#pragma unroll
            for (int p = 0; p < RN; ++p)
              fma4(t[p][0], *reinterpret_cast<const float4*>(
                                xst + p * XP + k + 4 * h), w);
          }
        };
        if (kend == F) {
#pragma unroll
          for (int k = 0; k < F; k += 16) step16(k);
        } else {
          for (int k = 0; k < kend; k += 16) step16(k);
        }
      } else {
        constexpr int wpitch = kInt8 ? XP : WP;   // fp32 rows of wf
        const float* wl = wf + ll * wpitch;
        if (kend == F) {
#pragma unroll
          for (int k = 0; k < F; k += 4)
            ffma_step<LANES_L>(t, wl, xst, wpitch, XP, k);
        } else {
          for (int k = 0; k < kend; k += 4)
            ffma_step<LANES_L>(t, wl, xst, wpitch, XP, k);
        }
      }
      if constexpr (kInt8) {
        if (k0 + F >= bd) {         // the block ends: o = o + s * dot
          const float sc = scl_s[it / kchunks];
#pragma unroll
          for (int p = 0; p < RN; ++p)
#pragma unroll
            for (int q = 0; q < LN; ++q) {
              acc[p][q] = __fadd_rn(acc[p][q], __fmul_rn(sc, part[p][q]));
              part[p][q] = 0.0f;
            }
        }
      }
    }
    g += total;
  }

#pragma unroll
  for (int p = 0; p < RN; ++p) {
    const int row = row0 + LR * p;
#pragma unroll
    for (int q = 0; q < LN; ++q) {
      const int l = l0 + ll + LANES_L * q;
      if (row < n && l < bl)
        out[static_cast<int64_t>(row) * out_cols +
            static_cast<int64_t>(slot) * bl + l] = acc[p][q];
    }
  }
}

// A 2D row-major tensor (outer x inner elements, rows row_bytes apart)
// read in boxes of box_outer x box_inner, stored densely; what lies
// outside the tensor arrives as zeros.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                const void* base, uint64_t inner, uint64_t outer,
                uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  return encode_map(map, type, 2, base, dims, strides, box, swizzle);
}

// Launches gather_kernel over ceil(n / rows a warp) <= 8 warps.
template <typename WT, int LANES_L, int RN>
cudaError_t launch_gather(const float* x, const WT* blocks,
                          const float* scales, const int* block_cols,
                          const int* row_ptr, const int* sel, float* out,
                          int n, int Dp, int out_cols, int R, int slots,
                          int nb, int bl, int bd, cudaStream_t stream) {
  constexpr int WR = 32 / LANES_L * RN;
  const int warps = (n + WR - 1) / WR;
  const int rows_box = warps * WR;
  const int label_tiles = (bl + kGLabels - 1) / kGLabels;
  CUtensorMap wmap, xmap;
  if (!tensor_map(&wmap, Gather<WT>::kType, blocks, bd,
                  static_cast<uint64_t>(nb) * bl, bd * sizeof(WT),
                  Gather<WT>::kPitch, kGLabels) ||
      !tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, Dp, n,
                  static_cast<uint64_t>(Dp) * 4, kXPitch, rows_box))
    return cudaErrorInvalidValue;
  // The most any n asks, set at every launch: a thread launching at another
  // n meanwhile can only set the same value.
  const cudaError_t err = cudaFuncSetAttribute(
      gather_kernel<WT, LANES_L, RN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      gather_smem<WT, LANES_L>(LANES_L == 32 ? kGMaxWarps : kGMaxRows));
  if (err != cudaSuccess) return err;
  gather_kernel<WT, LANES_L, RN>
      <<<static_cast<unsigned>(slots) * label_tiles, warps * 32,
         gather_smem<WT, LANES_L>(rows_box), stream>>>(
          wmap, xmap, scales, block_cols, row_ptr, sel, out, n, out_cols, R,
          bl, bd, label_tiles, rows_box);
  return cudaSuccess;
}

// ---- `ex_kernel`: the exhaustive fp32 product (see the note) ----

constexpr int kXF = 32;       // features a stage: one 128-byte swizzled row
constexpr int kExTL = 8;      // labels a thread, 8 apart
constexpr int kExWR = 2;      // consumer warps along rows
constexpr int kExWL = 2;      // consumer warps along labels
constexpr int kExS = 4;       // stages in the ring

// One configuration: a thread owns TR rows (4 apart) x kExTL labels (8
// apart); a warp's lanes are 8 along labels (fastest) x 4 along rows;
// kExWR x kExWL consumer warps, then one producer warp; kExS stages; MINB
// CTAs an SM. A stage is kXF features of one packed block: a weight box of
// the tile's kLabels label rows and an x box of its kRows rows, each row
// 128 bytes, stored by TMA with the 128-byte swizzle (16-byte piece c of
// row j at piece c ^ (j % 8)), so each box starts on a 1 KB boundary.
template <typename WT, int TR, int MINB>
struct Ex {
  static_assert(sizeof(WT) == 4,
                "ex_kernel's stage holds fp32 weights; an int8 stage (a "
                "32-byte-wide box, widened in registers, the block's scale "
                "applied when it ends) is not written yet");
  static constexpr int kRows = kExWR * 4 * TR;
  static constexpr int kLabels = kExWL * 8 * kExTL;
  static constexpr int kConsumers = kExWR * kExWL * 32;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kWB = kLabels * kXF * 4;
  static constexpr int kXB = kRows * kXF * 4;
  static_assert(kRows % 8 == 0 && kLabels % 8 == 0 && TR % 2 == 0,
                "the swizzle repeats every 8 rows of a box");
  // Slack to align the ring, the ring, its full and empty barriers.
  static constexpr int kSmem = 1024 + kExS * (kWB + kXB + 16);
};

// Grid: (row block r, label tile, row tile), the row tile fastest, so the
// CTAs that read r's blocks are neighbours in launch order. The producer
// warp walks r's packed blocks in order, kXF features at a time, and lands
// each stage's two boxes on the ring (full barrier: one arrival and the
// boxes' bytes; empty barrier: every consumer thread once it has read the
// stage). Consumer thread (warp w, lane) owns rows n0 + (w / kExWL) * 4 *
// TR + lane / 8 + 4 p and labels l0 + (w % kExWL) * 8 * kExTL + lane % 8 +
// 8 q; every
// output element is one fmaf chain from +0 over the blocks in order and
// each block's features in ascending order, stopping at bd.
template <typename WT, int TR, int MINB>
__global__ void __launch_bounds__(Ex<WT, TR, MINB>::kThreads, MINB)
ex_kernel(const __grid_constant__ CUtensorMap wmap,
          const __grid_constant__ CUtensorMap xmap,
          const int* __restrict__ block_cols,
          const int* __restrict__ row_ptr, float* __restrict__ out, int n,
          int out_cols, int bl, int bd, int label_tiles, int n_tiles) {
  using E = Ex<WT, TR, MINB>;
  constexpr int S = kExS, TL = kExTL, WL = kExWL;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_w =
      smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* ring_x = ring_w + S * E::kWB;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_x + S * E::kXB);
  uint64_t* empty = full + S;

  const int nt = blockIdx.x % n_tiles;
  const int rt = blockIdx.x / n_tiles;
  const int r = rt / label_tiles;
  const int l0 = rt % label_tiles * E::kLabels;
  const int n0 = nt * E::kRows;
  const int p_begin = row_ptr[r];
  const int p_end = row_ptr[r + 1];
  const int kchunks = (bd + kXF - 1) / kXF;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], E::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kExWR * WL) {   // the producer warp; lane 0 issues
    // Lane i holds the column of the group's block i; the next group's
    // columns are loaded while this one's stages are issued.
    int col = p_begin + lane < p_end ? block_cols[p_begin + lane] : 0;
    unsigned g = 0;
    for (int pc = p_begin; pc < p_end; pc += 32) {
      const int nxt =
          pc + 32 + lane < p_end ? block_cols[pc + 32 + lane] : 0;
      const int nblk = min(32, p_end - pc);
      for (int b = 0; b < nblk; ++b) {
        const int c = __shfl_sync(0xffffffffu, col, b);
        if (lane == 0) {
          for (int kc = 0; kc < kchunks; ++kc, ++g) {
            const int s = g % S;
            if (g >= S) mbar_wait(&empty[s], (g / S - 1) & 1);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_expect(&full[s], E::kWB + E::kXB);
            tma_load(ring_w + s * E::kWB, &wmap, kc * kXF,
                     (pc + b) * bl + l0, &full[s]);
            tma_load(ring_x + s * E::kXB, &xmap, c * bd + kc * kXF, n0,
                     &full[s]);
          }
        }
      }
      col = nxt;
    }
    return;
  }

  const int lr = lane >> 3;
  const int ll = lane & 7;
  const int xrow = (warp / WL) * 4 * TR + lr;     // + 4 p: (row & 7) = lr
  const int wrow = (warp % WL) * 8 * TL + ll;     // + 8 q: (row & 7) = ll
  float acc[TR][TL];
#pragma unroll
  for (int p = 0; p < TR; ++p)
#pragma unroll
    for (int q = 0; q < TL; ++q) acc[p][q] = 0.0f;

  const int total = (p_end - p_begin) * kchunks;
  int s = 0, kc = 0;
  unsigned phase = 0;
  for (int it = 0; it < total; ++it) {
    const int kend = min(kXF, bd - kc * kXF);
    mbar_wait(&full[s], phase);
    const unsigned char* xs = ring_x + s * E::kXB + xrow * 128;
    const unsigned char* ws = ring_w + s * E::kWB + wrow * 128;
    // Features 4c .. 4c+3 of the stage: piece c of each row, at piece
    // c ^ (row % 8); x rows 4 apart alternate between lr and lr ^ 4.
    auto step = [&](int c) {
      float4 xv[TR], wv[TL];
#pragma unroll
      for (int p = 0; p < TR; ++p)
        xv[p] = *reinterpret_cast<const float4*>(
            xs + p * 512 + ((c ^ lr ^ ((p & 1) << 2)) << 4));
#pragma unroll
      for (int q = 0; q < TL; ++q)
        wv[q] = *reinterpret_cast<const float4*>(ws + q * 1024 +
                                                 ((c ^ ll) << 4));
#pragma unroll
      for (int p = 0; p < TR; ++p)
#pragma unroll
        for (int q = 0; q < TL; ++q) fma4(acc[p][q], xv[p], wv[q]);
    };
    if (kend == kXF) {
#pragma unroll
      for (int c = 0; c < kXF / 4; ++c) step(c);
    } else {
      for (int c = 0; c < kend / 4; ++c) step(c);
    }
    mbar_arrive(&empty[s]);
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
    if (++kc == kchunks) kc = 0;
  }

#pragma unroll
  for (int p = 0; p < TR; ++p) {
    const int row = n0 + xrow + 4 * p;
    if (row >= n) break;
#pragma unroll
    for (int q = 0; q < TL; ++q) {
      const int l = l0 + wrow + 8 * q;
      if (l < bl)
        out[static_cast<int64_t>(row) * out_cols +
            static_cast<int64_t>(r) * bl + l] = acc[p][q];
    }
  }
}

// Launches ex_kernel over R x label tiles x row tiles CTAs.
template <typename WT, int TR, int MINB>
cudaError_t launch_ex(const float* x, const WT* blocks,
                      const int* block_cols, const int* row_ptr, float* out,
                      int n, int Dp, int out_cols, int R, int nb, int bl,
                      int bd, cudaStream_t stream) {
  using E = Ex<WT, TR, MINB>;
  const int label_tiles = (bl + E::kLabels - 1) / E::kLabels;
  const int n_tiles = (n + E::kRows - 1) / E::kRows;
  const int64_t grid = static_cast<int64_t>(R) * label_tiles * n_tiles;
  CUtensorMap wmap, xmap;
  if (grid > 0x7fffffff ||
      !tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, blocks, bd,
                  static_cast<uint64_t>(nb) * bl, bd * sizeof(WT), kXF,
                  E::kLabels, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, Dp, n,
                  static_cast<uint64_t>(Dp) * 4, kXF, E::kRows,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kernel = ex_kernel<WT, TR, MINB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, E::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), E::kThreads, E::kSmem, stream>>>(
      wmap, xmap, block_cols, row_ptr, out, n, out_cols, bl, bd,
      label_tiles, n_tiles);
  return cudaSuccess;
}

// ---- `pq_kernel`: the per-query selection, row block first (the note) ----

constexpr int kPQWarps = 8;
constexpr int kPQThreads = kPQWarps * 32;
constexpr int kScanPass = kPQThreads * 32;   // sel entries a scan pass reads

template <int V> struct Rows { static constexpr int value = V; };

// Calls f(Rows<E>()) with E the least of 1, 2, 4, ..., RN that is >= rows:
// a warp multiplies only as many of its RN pair rows as the chunk fills.
template <int RN, typename Fn>
__device__ __forceinline__ void with_rows(int rows, Fn&& f) {
  if constexpr (RN > 1) {
    if (rows <= RN / 2) {
      with_rows<RN / 2>(rows, f);
      return;
    }
  }
  f(Rows<RN>());
}

// One configuration: LN labels a lane (a label tile of 32 * LN), RN pair
// rows a warp (a chunk of 8 * RN pairs). A stage is one block's 128
// features: a weight box of the tile's label rows (padded rows, as in
// gather_kernel) and one 512-byte row a pair, each 128-byte aligned as TMA
// asks. The ring takes what fits in kBudget bytes, 2 to 8 stages: one CTA
// an SM at 64-label tiles or 64 rows; two at 32 rows; at 8 rows two in
// fp32, whose weight stream wants the deeper ring, and three in int8, whose
// CTAs each wait on a dependent FFMA chain that more CTAs overlap.
template <typename WT, int LN, int RN>
struct PQ {
  static constexpr int kLabels = 32 * LN;
  static constexpr int kRows = kPQWarps * RN;
  static constexpr int kWB = round_kb(kLabels * Gather<WT>::kPitch *
                                      static_cast<int>(sizeof(WT)));
  static constexpr int kXB = kRows * kGFeatures * 4;
  static constexpr int kBudget =
      (LN == 2 || RN == 8 ? 200 : RN == 1 && sizeof(WT) == 1 ? 64 : 100) *
      1024;
  static constexpr int kS = kBudget / (kWB + kXB);
  static constexpr int kStages = kS < 2 ? 2 : kS > 8 ? 8 : kS;
  // Slack to align the ring, the ring and its barriers, the staged columns
  // and scales, the chunk's pairs (flat index and query) and the scan's
  // warp totals.
  static constexpr int kSmem = 1024 + kStages * (kWB + kXB + 8) +
                               2 * kGStaged * 4 + 2 * kRows * 4 +
                               kPQWarps * 4;
};

// Grid: (row block r, chunk c, label tile) with the label tile fastest,
// r = R standing for every id outside [0, R). The CTA scans sel for its
// pairs j = q * B + i with sel[q, i] == r (in j order, by warp ballots),
// keeps those of rank c * rows .. + rows - 1, streams r's packed blocks
// once through a TMA ring and gathers each stage's x rows (x[q] at the
// block's column) as one-row boxes, a lane a row. A lane owns LN labels
// (32 apart) and warp w pairs w, w + 8, ..., of which it multiplies only
// the ceil(np / 8) the chunk's np pairs need (rounded up to a power of
// two); warps past np only wait. Out element (q, i * bl + l) is out[j * bl + l]. A
// selection with more than `chunks` * rows pairs for one r (duplicate ids)
// is served by the same CTAs, chunk c + chunks after chunk c.
template <typename WT, int LN, int RN>
__global__ void __launch_bounds__(kPQThreads)
pq_kernel(const __grid_constant__ CUtensorMap wmap,
          const __grid_constant__ CUtensorMap xmap,
          const float* __restrict__ scales,
          const int* __restrict__ block_cols,
          const int* __restrict__ row_ptr, const int* __restrict__ sel,
          float* __restrict__ out, int n, int R, int B, int bl, int bd,
          int label_tiles, int chunks) {
  using P = PQ<WT, LN, RN>;
  constexpr bool kInt8 = sizeof(WT) == 1;
  constexpr int F = kGFeatures;
  constexpr int WP = Gather<WT>::kPitch;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_w =
      smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* ring_x = ring_w + S * P::kWB;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_x + S * P::kXB);
  int* cols_s = reinterpret_cast<int*>(full + S);
  float* scl_s = reinterpret_cast<float*>(cols_s + kGStaged);
  int* pair_j = reinterpret_cast<int*>(scl_s + kGStaged);
  int* pair_q = pair_j + P::kRows;
  int* warp_sum = pair_q + P::kRows;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l0 = (blockIdx.x % label_tiles) * P::kLabels;
  const int rc = blockIdx.x / label_tiles;
  const int r = rc / chunks;
  const bool real = r < R;
  const int p_begin = real ? row_ptr[r] : 0;
  const int p_end = real ? row_ptr[r + 1] : 0;
  const int kchunks = (bd + F - 1) / F;
  const int entries = n * B;

  // Fills pair_j / pair_q with the pairs of rank lo .. lo + rows - 1 and
  // returns how many pairs r has. Thread t ends a pass holding the ballot
  // of entries base + 32 t .. + 31, so thread order is j order.
  auto scan = [&](int lo) {
    int total = 0;
    for (int base = 0; base < entries; base += kScanPass) {
      unsigned mine = 0;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int e = base + ((warp * 32 + k) << 5) + lane;
        const int v = e < entries ? sel[e] : 0;
        const bool hit = e < entries && (real ? v == r : v < 0 || v >= R);
        const unsigned b = __ballot_sync(0xffffffffu, hit);
        if (lane == k) mine = b;
      }
      const int cnt = __popc(mine);
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      if (lane == 31) warp_sum[warp] = incl;
      __syncthreads();
      int rank = total + incl - cnt, pass = 0;
      for (int w = 0; w < kPQWarps; ++w) {
        if (w < warp) rank += warp_sum[w];
        pass += warp_sum[w];
      }
      for (unsigned bits = mine; bits != 0; bits &= bits - 1, ++rank)
        if (rank >= lo && rank < lo + P::kRows) {
          const int j = base + (threadIdx.x << 5) + __ffs(bits) - 1;
          pair_j[rank - lo] = j;
          pair_q[rank - lo] = j / B;
        }
      total += pass;
      __syncthreads();        // warp_sum is rewritten by the next pass
    }
    return total;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int lo = rc % chunks * P::kRows;
  const int pairs = scan(lo);   // its barriers publish the mbarrier init

  float acc[RN][LN], part[RN][LN];
  // Stage g of the CTA (over all chunks and passes) sits in ring slot
  // g % S, and its barrier completes phase g / S.
  unsigned g = 0;
  while (lo < pairs) {
    const int np = min(P::kRows, pairs - lo);   // this chunk's pairs
    const int rows = (np + kPQWarps - 1) / kPQWarps;   // rows a warp needs
    const bool active = warp < np;
#pragma unroll
    for (int p = 0; p < RN; ++p)
#pragma unroll
      for (int q = 0; q < LN; ++q) acc[p][q] = part[p][q] = 0.0f;
    const unsigned stage_bytes =
        P::kLabels * WP * sizeof(WT) + np * F * 4;
    for (int pc = p_begin; pc < p_end; pc += kGStaged) {
      const int nblk = min(kGStaged, p_end - pc);
      const int total = nblk * kchunks;   // this pass's stages
      auto issue_w = [&](int it) {        // one thread
        const int s = (g + it) % S;
        mbar_expect(&full[s], stage_bytes);
        tma_load(ring_w + s * P::kWB, &wmap, it % kchunks * F,
                 (pc + it / kchunks) * bl + l0, &full[s]);
      };
      auto issue_x = [&](int it) {        // warp 0, a pair a lane
        const int s = (g + it) % S;
        const int col = cols_s[it / kchunks] * bd + it % kchunks * F;
        for (int i = lane; i < np; i += 32)
          tma_load(ring_x + s * P::kXB + i * F * 4, &xmap, col, pair_q[i],
                   &full[s]);
      };

      __syncthreads();      // the last pass (or chunk) is read
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int it = 0; it < S - 1 && it < total; ++it) issue_w(it);
      }
      for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
        cols_s[i] = block_cols[pc + i];
        if constexpr (kInt8) scl_s[i] = scales[pc + i];
      }
      __syncthreads();
      if (warp == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int it = 0; it < S - 1 && it < total; ++it) issue_x(it);
      }

      for (int it = 0; it < total; ++it) {
        const unsigned gs = g + it;
        const int s = gs % S;
        const int k0 = it % kchunks * F;
        const int kend = min(F, bd - k0);
        mbar_wait(&full[s], (gs / S) & 1);
        __syncthreads();    // stage `it` ready to read; stage it-1 done
        if (warp == 0 && it + S - 1 < total) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          if (lane == 0) issue_w(it + S - 1);
          __syncwarp();     // the expect precedes every x copy of the stage
          issue_x(it + S - 1);
        }
        if (!active) continue;
        // This warp's first pair row; its others are 8 rows apart.
        const float* xst =
            reinterpret_cast<const float*>(ring_x + s * P::kXB) + warp * F;
        with_rows<RN>(rows, [&](auto rows_c) {
          constexpr int RE = decltype(rows_c)::value;
          if constexpr (kInt8) {
            // A lane widens its own label rows, 16 features at a time.
            const int8_t* wr =
                reinterpret_cast<const int8_t*>(ring_w + s * P::kWB) +
                lane * WP;
            auto step16 = [&](int k) {
              int4 v[LN];
#pragma unroll
              for (int q = 0; q < LN; ++q)
                v[q] = *reinterpret_cast<const int4*>(wr + q * 32 * WP + k);
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                float4 xv[RE];
#pragma unroll
                for (int p = 0; p < RE; ++p)
                  xv[p] = *reinterpret_cast<const float4*>(
                      xst + p * kPQWarps * F + k + 4 * h);
#pragma unroll
                for (int q = 0; q < LN; ++q) {
                  const float4 w = widen_exact(h == 0   ? v[q].x
                                               : h == 1 ? v[q].y
                                               : h == 2 ? v[q].z
                                                        : v[q].w);
#pragma unroll
                  for (int p = 0; p < RE; ++p) fma4(part[p][q], xv[p], w);
                }
              }
            };
            if (kend == F) {
#pragma unroll
              for (int k = 0; k < F; k += 16) step16(k);
            } else {
              for (int k = 0; k < kend; k += 16) step16(k);
            }
          } else {
            const float* wl =
                reinterpret_cast<const float*>(ring_w + s * P::kWB) +
                lane * WP;
            auto step4 = [&](int k) {
              float4 wv[LN], xv[RE];
#pragma unroll
              for (int q = 0; q < LN; ++q)
                wv[q] = *reinterpret_cast<const float4*>(wl + q * 32 * WP +
                                                         k);
#pragma unroll
              for (int p = 0; p < RE; ++p)
                xv[p] = *reinterpret_cast<const float4*>(
                    xst + p * kPQWarps * F + k);
#pragma unroll
              for (int p = 0; p < RE; ++p)
#pragma unroll
                for (int q = 0; q < LN; ++q) fma4(acc[p][q], xv[p], wv[q]);
            };
            if (kend == F) {
#pragma unroll
              for (int k = 0; k < F; k += 4) step4(k);
            } else {
              for (int k = 0; k < kend; k += 4) step4(k);
            }
          }
        });
        if (kInt8 && k0 + F >= bd) {   // the block ends: o = o + s * dot
          const float sc = scl_s[it / kchunks];
#pragma unroll
          for (int p = 0; p < RN; ++p)
#pragma unroll
            for (int q = 0; q < LN; ++q) {
              acc[p][q] = __fadd_rn(acc[p][q], __fmul_rn(sc, part[p][q]));
              part[p][q] = 0.0f;
            }
        }
      }
      g += total;
    }

    if (active) {
#pragma unroll
      for (int p = 0; p < RN; ++p) {
        const int row = warp + kPQWarps * p;
        if (row >= np) break;
        const int64_t o = static_cast<int64_t>(pair_j[row]) * bl;
#pragma unroll
        for (int q = 0; q < LN; ++q) {
          const int l = l0 + lane + 32 * q;
          if (l < bl) out[o + l] = acc[p][q];
        }
      }
    }
    lo += chunks * P::kRows;
    if (lo < pairs) {
      __syncthreads();      // every read of the pair list is done
      scan(lo);
    }
  }
}

// Launches pq_kernel over (R + 1) x ceil(n / rows) x label tiles CTAs.
template <typename WT, int LN, int RN>
cudaError_t launch_pq(const float* x, const WT* blocks, const float* scales,
                      const int* block_cols, const int* row_ptr,
                      const int* sel, float* out, int n, int Dp, int R,
                      int B, int nb, int bl, int bd, cudaStream_t stream) {
  using P = PQ<WT, LN, RN>;
  const int label_tiles = (bl + P::kLabels - 1) / P::kLabels;
  const int chunks = (n + P::kRows - 1) / P::kRows;
  const int64_t grid = static_cast<int64_t>(R + 1) * chunks * label_tiles;
  CUtensorMap wmap, xmap;
  if (grid > 0x7fffffff || static_cast<int64_t>(n) * B > 0x7fffffff ||
      !tensor_map(&wmap, Gather<WT>::kType, blocks, bd,
                  static_cast<uint64_t>(nb) * bl, bd * sizeof(WT),
                  Gather<WT>::kPitch, P::kLabels) ||
      !tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, Dp, n,
                  static_cast<uint64_t>(Dp) * 4, kGFeatures, 1))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      pq_kernel<WT, LN, RN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmem);
  if (err != cudaSuccess) return err;
  pq_kernel<WT, LN, RN><<<static_cast<unsigned>(grid), kPQThreads,
                          P::kSmem, stream>>>(
      wmap, xmap, scales, block_cols, row_ptr, sel, out, n, R, B, bl, bd,
      label_tiles, chunks);
  return cudaSuccess;
}

// The per-query launch: pq_kernel with (LN, RN) = (1, 1) at n <= 8, (1, 4)
// at n <= 32, else (2, 8): the 64-label tile only where chunks of 64
// pairs fill, halving how often each x row is read.
template <typename WT>
int run_pq(const float* x, const WT* blocks, const float* scales,
           const int* block_cols, const int* row_ptr, const int* sel,
           float* out, int n, int Dp, int R, int B, int nb, int bl, int bd,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || B < 1 || R < 1 || bd % (sizeof(WT) == 1 ? 16 : 4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 8)
    err = launch_pq<WT, 1, 1>(x, blocks, scales, block_cols, row_ptr, sel,
                              out, n, Dp, R, B, nb, bl, bd, s);
  else if (n <= 32)
    err = launch_pq<WT, 1, 4>(x, blocks, scales, block_cols, row_ptr, sel,
                              out, n, Dp, R, B, nb, bl, bd, s);
  else
    err = launch_pq<WT, 2, 8>(x, blocks, scales, block_cols, row_ptr, sel,
                              out, n, Dp, R, B, nb, bl, bd, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shape, picks the kernel and its tile by n and launches on
// `stream` of `device`; returns cudaGetLastError() after the launch.
// gather_kernel serves n <= min(gather_max_n, 64) (RN = 1 at n <= 16, else
// 2): the shared selection up to 64 and the exhaustive int8 kernel up to
// the caller's switch. Every other launch runs bsr_kernel at TN = 8 / 32 /
// 64 (64 for the shared selection). The exhaustive fp32 product does not
// come here: bsr_predict_f32 launches ex_kernel itself.
template <typename WT, int MODE>
int run(const float* x, const WT* blocks, const float* scales,
        const int* block_cols, const int* row_ptr, const int* sel,
        float* out, int n, int Dp, int R, int slots, int nb, int bl, int bd,
        int gather_max_n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool gather = n <= gather_max_n && n <= kGMaxRows;
  const int64_t tiles =
      gather ? static_cast<int64_t>(slots) * ((bl + kGLabels - 1) / kGLabels)
             : static_cast<int64_t>(slots) *
                   ((bl + kLabelTile - 1) / kLabelTile) * ((n + 7) / 8);
  const int piece = sizeof(WT) == 1 ? 16 : 4;
  if (n < 1 || slots < 1 || R < 1 || bd % piece != 0 || tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int out_cols = slots * bl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gather) {
    if (n <= kGMaxWarps)
      err = launch_gather<WT, 32, 1>(x, blocks, scales, block_cols, row_ptr,
                                     sel, out, n, Dp, out_cols, R, slots, nb,
                                     bl, bd, s);
    else if (n <= 16)
      err = launch_gather<WT, 8, 1>(x, blocks, scales, block_cols, row_ptr,
                                    sel, out, n, Dp, out_cols, R, slots, nb,
                                    bl, bd, s);
    else
      err = launch_gather<WT, 8, 2>(x, blocks, scales, block_cols, row_ptr,
                                    sel, out, n, Dp, out_cols, R, slots, nb,
                                    bl, bd, s);
  } else if constexpr (MODE == kShared) {
    launch<WT, 64, MODE>(x, blocks, scales, block_cols, row_ptr, sel, out, n,
                         Dp, out_cols, R, slots, bl, bd, s);
  } else if (n <= 8) {
    launch<WT, 8, MODE>(x, blocks, scales, block_cols, row_ptr, sel, out, n,
                        Dp, out_cols, R, slots, bl, bd, s);
  } else if (n <= 32) {
    launch<WT, 32, MODE>(x, blocks, scales, block_cols, row_ptr, sel, out,
                         n, Dp, out_cols, R, slots, bl, bd, s);
  } else {
    launch<WT, 64, MODE>(x, blocks, scales, block_cols, row_ptr, sel, out,
                         n, Dp, out_cols, R, slots, bl, bd, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, Dp) f32, blocks (nb, bl, bd) f32, block_cols (nb,) i32,
// row_ptr (n_row_blocks + 1,) i32 -> out (n, Lp) f32, every element written.
// nb the blocks' first dim. ex_kernel at 128-label tiles of 16 rows (2 x 8
// a thread, three CTAs an SM) to n = 16, 32 rows (4 x 8, two CTAs an SM)
// to n = 32, and 64 rows (8 x 8, two CTAs an SM) above.
extern "C" int bsr_predict_f32(const float* x, const float* blocks,
                               const int* block_cols, const int* row_ptr,
                               float* out, int n, int Dp, int Lp,
                               int n_row_blocks, int nb, int bl, int bd,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n_row_blocks < 1 || bd % 4 != 0 || Lp != n_row_blocks * bl)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 16)
    err = launch_ex<float, 2, 3>(x, blocks, block_cols, row_ptr, out, n, Dp,
                                 Lp, n_row_blocks, nb, bl, bd, s);
  else if (n <= 32)
    err = launch_ex<float, 4, 2>(x, blocks, block_cols, row_ptr, out, n, Dp,
                                 Lp, n_row_blocks, nb, bl, bd, s);
  else
    err = launch_ex<float, 8, 2>(x, blocks, block_cols, row_ptr, out, n, Dp,
                                 Lp, n_row_blocks, nb, bl, bd, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// As bsr_predict_f32 over int8 blocks with fp32 per-block scales (nb,),
// nb the blocks' first dim. n <= gather_max_n (at most 64) runs
// gather_kernel with each row block as its own slot, larger n bsr_kernel:
// the same bits either way.
extern "C" int bsr_predict_int8(const float* x, const int8_t* blocks,
                                const float* scales, const int* block_cols,
                                const int* row_ptr, float* out, int n,
                                int Dp, int n_row_blocks, int nb, int bl,
                                int bd, int gather_max_n, int device,
                                void* stream) {
  return run<int8_t, kAll>(x, blocks, scales, block_cols, row_ptr, nullptr,
                           out, n, Dp, n_row_blocks, n_row_blocks, nb, bl,
                           bd, gather_max_n, device, stream);
}

// sel (B,) i32 row-block ids, any order -> out (n, B * bl) f32: columns
// [i*bl, (i+1)*bl) hold row block sel[i]'s scores. nb: blocks' first dim.
extern "C" int bsr_gather_f32(const float* x, const float* blocks,
                              const int* block_cols, const int* row_ptr,
                              const int* sel, float* out, int n, int Dp,
                              int n_row_blocks, int B, int nb, int bl,
                              int bd, int device, void* stream) {
  return run<float, kShared>(x, blocks, nullptr, block_cols, row_ptr, sel,
                             out, n, Dp, n_row_blocks, B, nb, bl, bd,
                             kGMaxRows, device, stream);
}

// As bsr_gather_f32 over int8 blocks with fp32 per-block scales (nb,).
extern "C" int bsr_gather_int8(const float* x, const int8_t* blocks,
                               const float* scales, const int* block_cols,
                               const int* row_ptr, const int* sel,
                               float* out, int n, int Dp, int n_row_blocks,
                               int B, int nb, int bl, int bd, int device,
                               void* stream) {
  return run<int8_t, kShared>(x, blocks, scales, block_cols, row_ptr, sel,
                              out, n, Dp, n_row_blocks, B, nb, bl, bd,
                              kGMaxRows, device, stream);
}

// sel (n, B) i32, row q's own row-block ids, any order, repeated ids and
// ids outside [0, n_row_blocks) allowed -> out (n, B * bl) f32: row q's
// columns [i*bl, (i+1)*bl) hold row block sel[q, i]'s scores for x[q]
// (zeros for an id outside). nb: blocks' first dim.
extern "C" int bsr_gather_pq_f32(const float* x, const float* blocks,
                                 const int* block_cols, const int* row_ptr,
                                 const int* sel, float* out, int n, int Dp,
                                 int n_row_blocks, int B, int nb, int bl,
                                 int bd, int device, void* stream) {
  return run_pq<float>(x, blocks, nullptr, block_cols, row_ptr, sel, out, n,
                       Dp, n_row_blocks, B, nb, bl, bd, device, stream);
}

// As bsr_gather_pq_f32 over int8 blocks with fp32 per-block scales (nb,).
extern "C" int bsr_gather_pq_int8(const float* x, const int8_t* blocks,
                                  const float* scales, const int* block_cols,
                                  const int* row_ptr, const int* sel,
                                  float* out, int n, int Dp,
                                  int n_row_blocks, int B, int nb, int bl,
                                  int bd, int device, void* stream) {
  return run_pq<int8_t>(x, blocks, scales, block_cols, row_ptr, sel, out, n,
                        Dp, n_row_blocks, B, nb, bl, bd, device, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
