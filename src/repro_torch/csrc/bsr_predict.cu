// Block-sparse (BSR) predict for Hopper: scores = x @ W_pruned^T over the
// packed surviving blocks of a Delta-pruned DiSMEC model.
//
// Replaces the TPU kernel `_bsr_kernel` in
// src/repro/kernels/bsr_predict/kernel.py (called through
// `bsr_predict_pallas`). That kernel walks the packed blocks in order on one
// core and keeps a row's (n, bl) output tile resident across the row's
// blocks. Here blocks run in parallel and in no order, so one CTA owns one
// (row block, label tile of 128, tile of TN instance rows) and loops over
// row_ptr[r] .. row_ptr[r+1] itself; the output tile lives in registers and
// is written once. A row block with no packed blocks writes exact zeros,
// which is also what the fully pruned sentinel (row_ptr all zeros) gives.
//
// What bounds it on an H100: at serving batch sizes (n <= 32) the weight
// stream, every packed fp32 block read once (632 MB at Wiki10-31K width,
// 0.19 ms at 3.35 TB/s); at n = 256 the fp32 FMAs (81 GFLOP, 1.2 ms at
// 67 TFLOP/s). The design: a 3-stage cp.async pipeline runs over the flat
// (block, 16-feature chunk) sequence of the row, so loads of the next
// blocks are in flight while the current chunk is multiplied, with no
// bubble at block boundaries; the CTA's TN row tiles of one row block are
// neighbours in launch order and share each weight block through L2. Each
// thread accumulates a (TN/8 rows x 4 labels) tile with FFMA (not TF32)
// from 16-byte shared-memory reads: weight rows are padded to 20 floats so
// the reads of a quarter warp hit distinct banks, and x reads broadcast.
//
// Offsets into blocks, x and out are 64-bit: nb * bl * bd passes 2^31 at
// WikiLSHTC-325K scale. Requires bd % 4 == 0 (16-byte copies).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLabelTile = 128;       // 32 lanes x 4 labels
constexpr int kChunk = 16;            // features per pipeline stage
constexpr int kStride = kChunk + 4;   // padded smem row (floats)
constexpr int kStages = 3;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
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
template <int TN>
__device__ __forceinline__ void load_stage(
    float* ws, float* xs, int it, const float* __restrict__ x,
    const float* __restrict__ blocks, const int* __restrict__ block_cols,
    int p_begin, int kchunks, int n, int n0, int l0, int Dp, int bl,
    int bd) {
  const int p = p_begin + it / kchunks;
  const int k0 = (it % kchunks) * kChunk;
  const int c = block_cols[p];
  const float* wblk = blocks + static_cast<int64_t>(p) * bl * bd;
  constexpr int kPieces = kChunk / 4;               // 16-byte pieces per row
#pragma unroll
  for (int s = 0; s < kLabelTile * kPieces / kThreads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    const int j = e / kPieces, q = e % kPieces;
    const int l = l0 + j, k = k0 + 4 * q;
    const bool valid = l < bl && k < bd;
    const float* src =
        valid ? wblk + static_cast<int64_t>(l) * bd + k : blocks;
    cp_async16(ws + j * kStride + 4 * q, src, valid);
  }
  for (int e = threadIdx.x; e < TN * kPieces; e += kThreads) {
    const int i = e / kPieces, q = e % kPieces;
    const int row = n0 + i, k = k0 + 4 * q;
    const bool valid = row < n && k < bd;
    const float* src =
        valid ? x + static_cast<int64_t>(row) * Dp +
                    static_cast<int64_t>(c) * bd + k
              : x;
    cp_async16(xs + i * kStride + 4 * q, src, valid);
  }
}

template <int TN>
__global__ void __launch_bounds__(kThreads)
bsr_predict_kernel(const float* __restrict__ x,
                   const float* __restrict__ blocks,
                   const int* __restrict__ block_cols,
                   const int* __restrict__ row_ptr, float* __restrict__ out,
                   int n, int Dp, int Lp, int bl, int bd, int n_tiles,
                   int label_tiles) {
  constexpr int RN = TN / 8;   // rows per thread: warp w owns rows w + 8p
  __shared__ __align__(16) float ws[kStages][kLabelTile * kStride];
  __shared__ __align__(16) float xs[kStages][TN * kStride];

  const int nt = blockIdx.x % n_tiles;
  const int rt = blockIdx.x / n_tiles;
  const int r = rt / label_tiles;
  const int l0 = (rt % label_tiles) * kLabelTile;
  const int n0 = nt * TN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int p_begin = row_ptr[r];
  const int kchunks = (bd + kChunk - 1) / kChunk;
  const int total = (row_ptr[r + 1] - p_begin) * kchunks;

  float acc[RN][4];
#pragma unroll
  for (int p = 0; p < RN; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total)
      load_stage<TN>(ws[s], xs[s], s, x, blocks, block_cols, p_begin,
                     kchunks, n, n0, l0, Dp, bl, bd);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();   // stage `it` has landed (this thread)
    __syncthreads();                // ... for every thread; stage it-1 free
    const int nxt = it + kStages - 1;
    if (nxt < total)
      load_stage<TN>(ws[nxt % kStages], xs[nxt % kStages], nxt, x, blocks,
                     block_cols, p_begin, kchunks, n, n0, l0, Dp, bl, bd);
    cp_async_commit();
    const float* wsb = ws[it % kStages];
    const float* xsb = xs[it % kStages];
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      float4 w[4], xv[RN];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = *reinterpret_cast<const float4*>(
            wsb + (lane + 32 * q) * kStride + kk);
#pragma unroll
      for (int p = 0; p < RN; ++p)
        xv[p] = *reinterpret_cast<const float4*>(
            xsb + (warp + 8 * p) * kStride + kk);
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
  }
  cp_async_wait<0>();

#pragma unroll
  for (int p = 0; p < RN; ++p) {
    const int row = n0 + warp + 8 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = l0 + lane + 32 * q;
      if (row < n && l < bl)
        out[static_cast<int64_t>(row) * Lp + static_cast<int64_t>(r) * bl +
            l] = acc[p][q];
    }
  }
}

template <int TN>
void launch(const float* x, const float* blocks, const int* block_cols,
            const int* row_ptr, float* out, int n, int Dp, int Lp,
            int n_row_blocks, int bl, int bd, cudaStream_t stream) {
  const int n_tiles = (n + TN - 1) / TN;
  const int label_tiles = (bl + kLabelTile - 1) / kLabelTile;
  const unsigned grid = static_cast<unsigned>(n_row_blocks) * label_tiles *
                        n_tiles;   // < 2^31: checked by bsr_predict_f32
  bsr_predict_kernel<TN><<<grid, kThreads, 0, stream>>>(
      x, blocks, block_cols, row_ptr, out, n, Dp, Lp, bl, bd, n_tiles,
      label_tiles);
}

}  // namespace

// x (n, Dp) f32, blocks (nb, bl, bd) f32, block_cols (nb,) i32,
// row_ptr (n_row_blocks + 1,) i32 -> out (n, Lp) f32, every element written.
// Launches on `stream` (a cudaStream_t) of `device`; returns
// cudaGetLastError() after the launch.
extern "C" int bsr_predict_f32(const float* x, const float* blocks,
                               const int* block_cols, const int* row_ptr,
                               float* out, int n, int Dp, int Lp,
                               int n_row_blocks, int bl, int bd, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = static_cast<int64_t>(n_row_blocks) *
                        ((bl + kLabelTile - 1) / kLabelTile) *
                        ((n + 7) / 8);
  if (n < 1 || n_row_blocks < 1 || bd % 4 != 0 || tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 8)
    launch<8>(x, blocks, block_cols, row_ptr, out, n, Dp, Lp, n_row_blocks,
              bl, bd, s);
  else if (n <= 32)
    launch<32>(x, blocks, block_cols, row_ptr, out, n, Dp, Lp, n_row_blocks,
               bl, bd, s);
  else
    launch<64>(x, blocks, block_cols, row_ptr, out, n, Dp, Lp, n_row_blocks,
               bl, bd, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
