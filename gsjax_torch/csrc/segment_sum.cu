// Per-owner segment sums for Hopper (sm_90a).
//
// Replaces: gsjax/render/pallas_kernels.py::segment_sum_pallas
// (_segsum_kernel): out[o] = sum of rows [gm_start[o], gm_start[o+1]) of an
// owner-grouped (P, 16) f32 stream, for each of N owners.
//
// What bounds it on this card: bytes. Each stream row is read once (64
// bytes) and each owner's row written once (64 bytes), with one add per
// element read: far below the card's balance point.
//
// Design: sixteen threads per owner, one column each; each sums its
// owner's run sequentially, so one 64-byte row is one coalesced read and
// the summation order is fixed (deterministic, bitwise reproducible). Runs
// are disjoint, so there are no carries and no write hazards, as on the
// TPU. The TPU kernel's position one-hot on the matrix unit (with bf16
// hi/lo splits) is not needed: a thread reads its own run.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;
constexpr int kThreads = 256;  // 16 owners per block

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals,
                   const int* __restrict__ gm_start, float* __restrict__ out,
                   int n_owners) {
  const int o = blockIdx.x * (kThreads / kCols) + threadIdx.x / kCols;
  const int j = threadIdx.x % kCols;
  if (o >= n_owners) return;
  const int lo = gm_start[o];
  const int hi = gm_start[o + 1];
  float acc = 0.0f;
  for (int i = lo; i < hi; ++i) {
    acc += vals[static_cast<size_t>(i) * kCols + j];
  }
  out[static_cast<size_t>(o) * kCols + j] = acc;
}

}  // namespace

// vals: (P, 16) f32 owner-grouped rows; gm_start: (n_owners + 1) i32,
// nondecreasing, within [0, P]; out: (n_owners, 16) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int gsjt_segment_sum(const float* vals, const int* gm_start,
                                float* out, int n_owners, void* stream) {
  const int owners_per_block = kThreads / kCols;
  const int blocks = (n_owners + owners_per_block - 1) / owners_per_block;
  segment_sum_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(vals, gm_start,
                                                             out, n_owners);
  return static_cast<int>(cudaGetLastError());
}
