// Sorted-run rank expansion for Hopper (sm_90a).
//
// Replaces: gsjax/render/pallas_kernels.py::rank_prefix_pallas
// (_rank_prefix_kernel): for every slot s < budget,
//   out[s] = init + (s if plus_iota) + sum_{r: start_r <= s} delta_r  (mod 2^32)
// with `start` sorted ascending.
//
// What bounds it on this card: memory. Each slot writes 4 bytes and the
// runs' starts and prefix sums are read once (~12 bytes per slot at the
// render's shapes), with a handful of integer operations per slot.
//
// Design: the TPU kernel contracts a (runs x slots) compare one-hot against
// the deltas' 8-bit limbs on the matrix unit. Here the prefix sum of the
// deltas (dcum, computed outside as the reference wrapper does) turns the
// sum into one lookup: out[s] = init + (s if plus_iota) + dcum[k(s) - 1]
// with k(s) = #{r : start_r <= s}. Each block first bounds k over its own
// contiguous slot range (two binary searches over all runs), then every
// thread binary-searches only that short window. uint32 arithmetic wraps
// exactly as the reference's does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Number of entries of start[lo, hi) that are <= s (start sorted).
__device__ __forceinline__ int count_le(const int* __restrict__ start, int lo,
                                        int hi, int s) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
rank_prefix_kernel(const int* __restrict__ start, int r,
                   const unsigned* __restrict__ dcum, int budget,
                   unsigned init, int plus_iota, unsigned* __restrict__ out) {
  __shared__ int window[2];
  const int s0 = blockIdx.x * kThreads;
  const int s_last = min(s0 + kThreads, budget) - 1;
  if (threadIdx.x == 0) window[0] = count_le(start, 0, r, s0 - 1);
  if (threadIdx.x == 32) window[1] = count_le(start, 0, r, s_last);
  __syncthreads();
  const int s = s0 + threadIdx.x;
  if (s >= budget) return;
  const int k = count_le(start, window[0], window[1], s);
  unsigned v = init + (k > 0 ? dcum[k - 1] : 0u);
  if (plus_iota) v += static_cast<unsigned>(s);
  out[s] = v;
}

}  // namespace

// start: (r,) i32 sorted; dcum: (r,) u32 cumsum of the deltas;
// out: (budget,) u32. Returns cudaGetLastError() after the launch.
extern "C" int gsjt_rank_prefix(const int* start, int r, const int* dcum,
                                int budget, int init, int plus_iota, int* out,
                                void* stream) {
  const int blocks = (budget + kThreads - 1) / kThreads;
  rank_prefix_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      start, r, reinterpret_cast<const unsigned*>(dcum), budget,
      static_cast<unsigned>(init), plus_iota, reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
