// Banded (sliding-window) causal GQA attention for Hopper: the attention
// of the LM's local layers at long sequence lengths (hymba-1.5b's prefill).
//
// Replaces the TPU kernel `_banded_kernel` in
// src/repro/kernels/banded_attn/kernel.py (called through
// `banded_attention_pallas`). Same function: query row i of head h attends
// to the keys j of KV head h / G with j <= i and j > i - window, at scale
// 1/sqrt(hd), with the softmax and every sum in fp32; the output is in q's
// type. Not a copy of the Pallas blocks: there the band of each query
// block is one slice of span = window + qc rounded up to 128 and clamped
// into [0, Tk), sized to fit the TPU's VMEM; here the band is walked tile
// by tile, so any window and any length run on the kernel.
//
// Layout: q (B, Tq, H, hd), k and v (B, Tk, KV, hd), out (B, Tq, H * hd),
// contiguous, as the model's projections produce them: no transposes
// around the kernel. Element offsets are int64_t.
//
// What bounds it on an H100: operations. Each query position does
// 4 * hd * min(i + 1, window) flops per head against a few bytes, far
// above the card's ~295 flops per byte. This first version does its
// products on the fp32 CUDA cores (FFMA), not the tensor cores, so it can
// reach at most 67 TFLOP/s of the 989 TFLOP/s bf16 peak its bound is
// taken at; wgmma and TMA are later work.
//
// Design: one CTA of 256 threads per (batch, KV head, tile of BQ query
// positions). Its kRows = 128 rows are the G query heads of the group
// times BQ = 128 / G positions, so the G heads share every K/V tile it
// stages in shared memory. It visits only the key tiles of its band,
// [max(0, q0 - window + 1), q0 + BQ), kKeys = 64 keys at a time, with an
// online softmax in fp32. Each thread owns 4 rows x 8 keys of the score
// tile and the same 4 rows x hd / 8 columns of the output accumulator; the
// 8 lanes sharing 4 rows reduce row maxima and sums with warp shuffles,
// and pass the probabilities to each other through shared memory. Rows of
// shared memory are padded by one float, so neither the score loop nor the
// weighted sum has bank conflicts. No atomics: two launches give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;                       // (head, position) rows
constexpr int kKeys = 64;                        // keys per K/V tile
constexpr int kCols = 8;                         // lanes sharing 4 rows
constexpr int kRowsPerThread = kRows / (kThreads / kCols);   // 4
constexpr int kKeysPerThread = kKeys / kCols;                // 8
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
banded_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, int Tq,
                   int Tk, int H, int KV, int G, int BQ, int window,
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
      x = to_f32(q[((static_cast<int64_t>(b) * Tq + pos) * H + kvh * G +
                    r / BQ) * HD + d]);
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
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
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
    T* o = out + ((static_cast<int64_t>(b) * Tq + pos[rr]) * H + kvh * G +
                  r / BQ) * HD;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) store(o + cg + kCols * dd,
                                             acc[rr][dd] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Tq, int Tk, int H, int KV, int window,
                   float scale, float softcap, cudaStream_t stream) {
  const int G = H / KV;
  const int BQ = kRows / G;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      banded_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * KV);
  banded_attn_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk, H, KV, G, BQ,
      window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* out, int B, int Tq, int Tk, int H, int KV,
                     int window, float scale, float softcap,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, Tq, Tk, H, KV, window,
                                  scale, softcap, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, Tq, Tk, H, KV, window,
                                  scale, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, Tq, Tk, H, KV, window,
                                  scale, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, Tq, Tk, H, KV, window,
                                    scale, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Tq, H, hd), k and v (B, Tk, KV, hd) -> out (B, Tq, H * hd), all of
// one type: fp32 (bf16 = 0) or bf16 (bf16 = 1). softcap <= 0: none.
// Launches on `stream` (a cudaStream_t) of `device`; returns
// cudaGetLastError() after the launch.
extern "C" int banded_attn(const void* q, const void* k, const void* v,
                           void* out, int bf16, int B, int Tq, int Tk, int H,
                           int KV, int hd, int window, float scale,
                           float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kRows || Tq < 1 ||
      Tq > Tk || window < 1 || B * KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, out, B, Tq, Tk, H, KV,
                                       window, scale, softcap, s)
             : dispatch<float>(hd, q, k, v, out, B, Tq, Tk, H, KV, window,
                               scale, softcap, s);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
