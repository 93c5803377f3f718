// Row gather for Hopper (sm_90a): out[i] = src[idx[i]] for f32 rows.
//
// Replaces: tools/probe_prims.py::pallas_row_gather (_gather_kernel), the
// TPU probe's hand-written row gather (one DMA per row, 16 in flight). Its
// P % block restriction belonged to the DMA ring; this kernel takes any P.
// The render path gathers through it too: the depth permute of the (N, 12)
// fields and its backward, the (P, 16) instance stream and the backward's
// owner regroup (render/kernels.py row_gather).
//
// What bounds it on this card: bytes. Each output row is read once from a
// random source row and written once, with no arithmetic. Rows of 8 and
// 16 floats are whole 32-byte sectors; a 1-float row still costs its
// sector on the read.
//
// Design: one thread per 16-byte vector of the output where the row width
// allows (W = 16: four threads per 64-byte row, so a warp writes 512
// contiguous bytes and reads eight whole rows; W = 12: three threads per
// 48-byte row; W = 8: two threads per row), one thread per float for
// W = 1. A block takes whole rows, kThreads / kVecs of them (85 rows of
// width 12 use 255 of its threads), so the output it writes is
// contiguous. The threads of a row read its index once each, from L1.
// Row and element offsets are 64-bit: P and P * W may pass 2^31. Indices
// are int32 or int64; they are not checked (the caller's indices lie in
// [0, N)).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int W>
struct Shape {
  static constexpr int kVec = W % 4 == 0 ? 4 : 1;  // floats per thread
  static constexpr int kVecs = W / kVec;           // threads per row
  static constexpr int kRows = kThreads / kVecs;   // rows per block
};

template <typename Idx, int W>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ src, const Idx* __restrict__ idx,
                  float* __restrict__ out, long long p) {
  using S = Shape<W>;
  const int row = threadIdx.x / S::kVecs;
  const int v = threadIdx.x % S::kVecs;
  const long long i = static_cast<long long>(blockIdx.x) * S::kRows + row;
  if (row >= S::kRows || i >= p) return;
  const size_t r = static_cast<size_t>(idx[i]);
  const size_t o = static_cast<size_t>(i) * S::kVecs + v;
  if constexpr (S::kVec == 4) {
    reinterpret_cast<float4*>(out)[o] =
        reinterpret_cast<const float4*>(src)[r * S::kVecs + v];
  } else {
    out[o] = src[r * S::kVecs + v];
  }
}

template <typename Idx, int W>
void launch_width(const float* src, const Idx* idx, float* out, long long p,
                  cudaStream_t s) {
  const long long blocks = (p + Shape<W>::kRows - 1) / Shape<W>::kRows;
  row_gather_kernel<Idx, W><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      src, idx, out, p);
}

template <typename Idx>
int launch(const float* src, const void* idx, float* out, long long p,
           int width, cudaStream_t s) {
  const Idx* ix = static_cast<const Idx*>(idx);
  switch (width) {
    case 1: launch_width<Idx, 1>(src, ix, out, p, s); break;
    case 8: launch_width<Idx, 8>(src, ix, out, p, s); break;
    case 12: launch_width<Idx, 12>(src, ix, out, p, s); break;
    case 16: launch_width<Idx, 16>(src, ix, out, p, s); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (N, width) f32; idx: (p,) int32 (idx_bytes 4) or int64 (8);
// out: (p, width) f32, width 1, 8, 12 or 16; src and out 16-byte aligned
// for widths 8, 12 and 16; p of any size the grid's 2^31 - 1 blocks take.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another width or index size).
extern "C" int gsjt_row_gather(const float* src, const void* idx,
                               int idx_bytes, float* out, long long p,
                               int width, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0) return 0;
  if (idx_bytes == 4) return launch<int>(src, idx, out, p, width, s);
  if (idx_bytes == 8) return launch<long long>(src, idx, out, p, width, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
