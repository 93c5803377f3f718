// Row gather for Hopper (sm_90a): out[i] = src[idx[i]] for f32 rows.
//
// Replaces: tools/probe_prims.py::pallas_row_gather (_gather_kernel), the
// TPU probe's hand-written row gather (one DMA per row, 16 in flight). Its
// P % block restriction belonged to the DMA ring; this kernel takes any P.
//
// What bounds it on this card: bytes. Each output row is read once from a
// random source row and written once, with no arithmetic. Rows of 8 and
// 16 floats are whole 32-byte sectors; a 1-float row still costs its
// sector on the read.
//
// Design: one thread per 16-byte vector of the output where the row width
// allows (W = 16: four threads per 64-byte row, so a warp writes 512
// contiguous bytes and reads eight whole rows; W = 8: two threads per
// row), one thread per float for W = 1. The threads of a row read its
// index once each, from L1. Indices are int32 or int64; they are not
// checked (the caller's indices lie in [0, N)).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Idx, int W>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ src, const Idx* __restrict__ idx,
                  float* __restrict__ out, int total) {
  constexpr int kVec = W % 4 == 0 ? 4 : 1;  // floats per thread
  constexpr int kVecs = W / kVec;           // threads per row
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int i = t / kVecs;
  const int v = t % kVecs;
  const size_t r = static_cast<size_t>(idx[i]);
  if constexpr (kVec == 4) {
    reinterpret_cast<float4*>(out)[t] =
        reinterpret_cast<const float4*>(src)[r * kVecs + v];
  } else {
    out[t] = src[r * W + v];
  }
}

template <typename Idx>
int launch(const float* src, const void* idx, float* out, int p, int width,
           cudaStream_t s) {
  const Idx* ix = static_cast<const Idx*>(idx);
  const int per_row = width % 4 == 0 ? width / 4 : width;
  const int total = p * per_row;
  const int blocks = (total + kThreads - 1) / kThreads;
  switch (width) {
    case 1:
      row_gather_kernel<Idx, 1><<<blocks, kThreads, 0, s>>>(src, ix, out, total);
      break;
    case 8:
      row_gather_kernel<Idx, 8><<<blocks, kThreads, 0, s>>>(src, ix, out, total);
      break;
    case 16:
      row_gather_kernel<Idx, 16><<<blocks, kThreads, 0, s>>>(src, ix, out, total);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (N, width) f32; idx: (p,) int32 (idx_bytes 4) or int64 (8);
// out: (p, width) f32, width 1, 8 or 16, p * width < 2^31.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another width or index size).
extern "C" int gsjt_row_gather(const float* src, const void* idx,
                               int idx_bytes, float* out, int p, int width,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0) return 0;
  if (idx_bytes == 4) return launch<int>(src, idx, out, p, width, s);
  if (idx_bytes == 8) return launch<long long>(src, idx, out, p, width, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
