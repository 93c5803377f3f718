// Load-balanced expansion of sorted segment starts into items, for Hopper
// (sm_90a): the primitive that both binning levels run.
//
// Items 0 .. n_items-1 and segments 0 .. r-1 with nondecreasing starts;
// item i belongs to the last segment whose start is <= i, so
//   k(i) = #{s : start_s <= i}
// and its segment is k(i) - 1 (none when k(i) = 0). Merging the items with
// the starts (a start before an item of equal value) gives a sequence of
// n_items + r entries; a block takes a fixed span of kSpan of them
// ("merge path", Green, McColl & Bader 2012; the load-balancing search of
// moderngpu). A stretch of empty segments, or one segment that covers
// many blocks' items, then costs a block what any other span costs.
//
// A block's span [d0, d1) holds items [d0 - b0, d1 - b1) and segments
// [b0, b1), where b = merge_path(d) is the number of starts among the
// first d entries. Every start before b0 is <= the block's first item and
// every start from b1 on is > its last item, so for an item i of the block
//   k(i) = b0 + #{s in [b0, b1) : start_s <= i},
// which the block resolves against its starts staged in shared memory.
//
// Integer code only: the row engine's file, which includes this header, is
// built without fused multiply-adds, and nothing here may depend on that.

#pragma once

#include <cuda_runtime.h>

namespace gsjt {
namespace expand {

constexpr unsigned kFullMask = 0xffffffffu;

// The first b in [lo, hi) at which the monotone predicate taken(b) (true,
// then false) is false; hi if it holds everywhere. Called by all 32 lanes
// of a warp, which probe 32 evenly spaced candidates a round, so that a
// range of a million entries takes five rounds of loads, each lane's one
// independent of the others'. Returns the same value in every lane.
template <class Taken>
__device__ __forceinline__ int warp_partition(int lo, int hi, Taken taken) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long len = hi - lo;
    const int b = lo + static_cast<int>((len * lane) >> 5);
    const unsigned vote = __ballot_sync(kFullMask, taken(b));
    const int c = __popc(vote);  // lanes 0 .. c-1 voted true
    if (c == 0) {
      hi = lo;
    } else {
      const int last_true = lo + static_cast<int>((len * (c - 1)) >> 5);
      if (c < 32) hi = lo + static_cast<int>((len * c) >> 5);
      lo = last_true + 1;
    }
  }
  return lo;
}

// Number of starts among the first d entries of the merge of items
// [0, n_items) and start[0, r) (a start before an item of equal value).
// Called by all 32 lanes of a warp.
__device__ __forceinline__ int merge_path(const int* __restrict__ start, int r,
                                          int n_items, int d) {
  return warp_partition(max(0, d - n_items), min(d, r), [&](int b) {
    return __ldg(start + b) <= d - 1 - b;
  });
}

// #{i in [0, n) : s[i] <= v} for s sorted and n < 2 * kTop, in fixed
// steps (kTop, kTop / 2, ..., 1): no data-dependent loop, so the searches
// of a thread's several items unroll and overlap.
template <int kTop>
__device__ __forceinline__ int count_le_steps(const int* s, int n, int v) {
  int pos = 0;
#pragma unroll
  for (int step = kTop; step > 0; step >>= 1) {
    if (pos + step <= n && s[pos + step - 1] <= v) pos += step;
  }
  return pos;
}

}  // namespace expand
}  // namespace gsjt
