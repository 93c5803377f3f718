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
// with k(s) = #{r : start_r <= s}. Slots are expanded from the sorted
// starts by the load-balanced search of expand.cuh: each block takes a
// fixed span of 2048 slots plus runs, finds its two ends with one warp
// each, stages its runs' starts and prefix sums coalesced into shared
// memory, resolves each slot's k there (8 slots a thread, searches of
// fixed steps that overlap) and writes its slots with coalesced stores.
// Slots before the first start (k = 0), equal starts (empty runs: the last
// one wins), starts at or past the budget and the slots past the last
// start all come out of the same partition. uint32 arithmetic wraps
// exactly as the reference's does.

#include <cuda_runtime.h>

#include "expand.cuh"

namespace {

namespace ex = gsjt::expand;

constexpr int kThreads = 256;
constexpr int kSpan = 2048;  // slots + runs per block
constexpr int kPerThread = kSpan / kThreads;

__global__ void __launch_bounds__(kThreads)
rank_prefix_kernel(const int* __restrict__ start, int r,
                   const unsigned* __restrict__ dcum, int budget,
                   unsigned init, int plus_iota, unsigned* __restrict__ out) {
  __shared__ int s_start[kSpan];
  __shared__ unsigned s_dcum[kSpan + 1];
  __shared__ int s_b[2];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_diag = budget + r;
  const int d0 = blockIdx.x * kSpan;
  const int d1 = min(d0 + kSpan, n_diag);
  if (warp < 2) {
    const int b = ex::merge_path(start, r, budget, warp == 0 ? d0 : d1);
    if ((tid & 31) == 0) s_b[warp] = b;
  }
  __syncthreads();
  const int b0 = s_b[0], b1 = s_b[1];
  const int a0 = d0 - b0, a1 = d1 - b1;
  if (a0 >= a1) return;  // a span of runs only
  const int nw = b1 - b0;
  // s_dcum[i] = dcum[b0 - 1 + i]: the sum over the first b0 + i runs.
  for (int i = tid; i <= nw; i += kThreads) {
    if (i < nw) s_start[i] = __ldg(start + b0 + i);
    s_dcum[i] = b0 + i > 0 ? __ldg(dcum + b0 - 1 + i) : 0u;
  }
  __syncthreads();
  // Each thread's slots a0 + q * kThreads + tid: coalesced stores, and
  // searches of fixed steps that overlap.
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int s = a0 + q * kThreads + tid;
    const int k = ex::count_le_steps<kSpan>(s_start, nw, s);  // k(s) - b0
    unsigned v = init + s_dcum[k];
    if (plus_iota) v += static_cast<unsigned>(s);
    if (s < a1) out[s] = v;
  }
}

}  // namespace

// start: (r,) i32 sorted; dcum: (r,) u32 cumsum of the deltas;
// out: (budget,) u32; budget + r < 2^31. Returns cudaGetLastError() after
// the launch.
extern "C" int gsjt_rank_prefix(const int* start, int r, const int* dcum,
                                int budget, int init, int plus_iota, int* out,
                                void* stream) {
  const long long n_diag = static_cast<long long>(budget) + r;
  const int blocks = static_cast<int>((n_diag + kSpan - 1) / kSpan);
  rank_prefix_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      start, r, reinterpret_cast<const unsigned*>(dcum), budget,
      static_cast<unsigned>(init), plus_iota, reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
