// Fused binning level 1 for Hopper (sm_90a).
//
// Replaces: gsjax/render/pallas_kernels.py::row_engine_pallas
// (_row_engine_kernel). For each (gaussian, tile-row) run j < budget it
// finds the run's Gaussian, evaluates the exact tile x-interval of the
// alpha >= 1/255 ellipse inside the row's pixel strip (the closed form of
// binning._row_x_interval), and emits istart (exclusive cumsum of the
// instance counts), u = ((g << bits_tile) | tile_base) - istart and
// delta = u - u_prev (both mod 2^32, so u = cumsum(delta)), plus the
// total instance count.
//
// What bounds it on this card: latency and instruction issue, not bytes.
// It reads the 12 table columns it uses and writes 12 bytes per run, a few
// tens of MB at the render's shapes (microseconds of traffic), but each
// block's work is a dependent chain (ticket, partition search, staging,
// interval math, look-back, stores), and the interval math, IEEE
// divisions and square roots of a few hundred instructions a run, keeps
// the SM's issue slots full while every resident block runs it. The
// kernel's time is that chain times the waves of blocks, so the block
// keeps 32 registers a thread and 8 blocks an SM in flight; with 6 or 4
// an SM it is slower.
//
// Design: the TPU kernel walks the output blocks in order, carries the
// running instance count and the previous row's u across its sequential
// grid in scalar memory, and selects each row's Gaussian with a one-hot
// limb contraction on the matrix unit. Here it is one launch:
//   - runs are expanded from the sorted run starts by the load-balanced
//     search of expand.cuh: a block takes a fixed span of runs plus
//     Gaussians (2 runs a thread on average), finds its ends with one warp
//     each, and stages its Gaussians' 12 columns into shared memory with
//     coalesced asynchronous copies (cp.async), all in flight at once;
//   - the instance-count prefix crosses blocks by a single-pass scan with
//     decoupled look-back (Merrill & Garland 2016): a block publishes its
//     sum, then its inclusive prefix, in one 64-bit status word; blocks
//     take their spans in the order of an atomic ticket, so a block only
//     ever waits on blocks that are already running;
//   - delta = packed - packed_prev - count_prev needs no prefix; at a
//     block's first run, the previous run (a one-run halo) is computed by
//     the block itself. The block holding the last run writes the total.
// Counts and packed words never leave the block. The wrapper clears the
// status words and the ticket with one memset in the same C call.
// The interval math must agree bit for bit with the plain PyTorch version
// (a last-ulp difference moves an instance across a tile boundary), so
// this file is built with --fmad=false and IEEE division and square root,
// and its max/min propagate NaN as torch.maximum/minimum do. The one
// liberty: for a power-of-two tile width the two divisions by it are
// multiplications by its reciprocal, which round the same exact value
// x * 2^-k and so give the same bits.

#include <cuda_runtime.h>

#include "expand.cuh"

namespace {

namespace ex = gsjt::expand;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRunsPerThread = 2;
constexpr int kSpan = kThreads * kRunsPerThread;  // runs + Gaussians per block
constexpr int kPieces = kRunsPerThread * kWarps;  // (round, warp) scan pieces
constexpr unsigned kFull = 0xffffffffu;

// Table columns (kernels.py TAB_*): a (16, n) int32 array.
constexpr int kRstart = 0, kRend = 1, kY0 = 2, kX0 = 3, kX1 = 4, kMx = 5,
              kMy = 6, kCa = 7, kCb = 8, kCc = 9, kQmax = 10, kG = 11;
constexpr int kCols = 12;

// Look-back status words: the flag in the high half, the sum in the low.
constexpr unsigned long long kSumReady = 1ull << 32;
constexpr unsigned long long kPrefixReady = 2ull << 32;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
// f32 -> i32 truncating, saturating, NaN -> 0 (cvt.rzi.s32.f32).
__device__ __forceinline__ int f2i(float x) { return __float2int_rz(x); }

struct Run {
  unsigned count;
  unsigned packed;
};

// Run j's instance count and packed word (g << bits_tile) | tile_base.
// col(c) gives column c of the run's Gaussian.
// x / tsx; inv_tsx is 1 / tsx when tsx is a power of two (exact), else 0.
__device__ __forceinline__ float div_tile(float x, float tsx, float inv_tsx) {
  return inv_tsx != 0.0f ? x * inv_tsx : x / tsx;
}

template <class Col>
__device__ __forceinline__ Run run_of(int j, Col col, int lim, int tiles_x,
                                      float tsx, float inv_tsx, float tsy,
                                      int bits_tile) {
  const int ty = col(kY0) + (j - col(kRstart));
  const float mx = __int_as_float(col(kMx));
  const float my = __int_as_float(col(kMy));
  const float ca = __int_as_float(col(kCa));
  const float cb = __int_as_float(col(kCb));
  const float cc = __int_as_float(col(kCc));
  const float qmax = __int_as_float(col(kQmax));

  const float y0s = static_cast<float>(ty) * tsy - my;
  const float y1s = y0s + (tsy - 1.0f);
  const float eps = 1e-12f;
  const float safe_ca = max_nan(ca, eps);
  const float safe_cc = max_nan(cc, eps);
  const float det = max_nan(ca * cc - cb * cb, eps);
  const float y_span = sqrtf(max_nan(qmax * safe_ca / det, 0.0f));
  const float lo_y = max_nan(y0s, -y_span);
  const float hi_y = min_nan(y1s, y_span);
  const bool nonempty = lo_y <= hi_y;
  const float x_star = sqrtf(max_nan(qmax * safe_cc / det, 0.0f));
  const float ys_hi = min_nan(max_nan(-cb * x_star / safe_cc, lo_y), hi_y);
  const float ys_lo = min_nan(max_nan(cb * x_star / safe_cc, lo_y), hi_y);
  const float disc_hi = qmax * safe_ca - det * ys_hi * ys_hi;
  const float disc_lo = qmax * safe_ca - det * ys_lo * ys_lo;
  const float x_hi = (-cb * ys_hi + sqrtf(max_nan(disc_hi, 0.0f))) / safe_ca;
  const float x_lo = (-cb * ys_lo - sqrtf(max_nan(disc_lo, 0.0f))) / safe_ca;

  int rx0 = f2i(ceilf(div_tile(mx + x_lo - (tsx - 1.0f), tsx, inv_tsx)));
  int rx1 = static_cast<int>(
      static_cast<unsigned>(f2i(floorf(div_tile(mx + x_hi, tsx, inv_tsx)))) + 1u);
  rx0 = max(rx0, col(kX0));
  rx1 = min(rx1, col(kX1));
  const int width =
      static_cast<int>(static_cast<unsigned>(rx1) - static_cast<unsigned>(rx0));
  const unsigned tile_base =
      static_cast<unsigned>(ty) * static_cast<unsigned>(tiles_x) +
      static_cast<unsigned>(rx0);
  Run out;
  out.count = (j < lim && nonempty) ? static_cast<unsigned>(max(width, 0)) : 0u;
  out.packed = (static_cast<unsigned>(col(kG)) << bits_tile) | tile_base;
  return out;
}

// A run without a Gaussian (one past total_rows) reads every column as
// zero, and run_of then gives count 0 and tile_base = j * tiles_x exactly:
// the zero conic's x_lo is +-0, so rx0 = ceil(-(tsx - 1) / tsx) = 0, and
// rx1 <= x1 = 0. Such runs skip the interval math.
__device__ __forceinline__ Run unowned_run(int j, int tiles_x) {
  return Run{0u, static_cast<unsigned>(j) * static_cast<unsigned>(tiles_x)};
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The sum of the counts of all spans before `ticket`, by one warp: a
// window of 32 predecessors at a time, waiting until each has published,
// summing back to the nearest one that published its inclusive prefix.
__device__ unsigned look_back(const unsigned long long* status, int ticket) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0;
  for (int top = ticket - 1;; top -= 32) {
    const int t = top - lane;
    unsigned long long w;
    do {
      w = t >= 0 ? load_status(status + t) : kPrefixReady;
    } while (__any_sync(kFull, (w >> 32) == 0));
    const unsigned done = __ballot_sync(kFull, (w >> 32) == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    unsigned v = lane <= stop ? static_cast<unsigned>(w) : 0u;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    prefix += v;
    if (done) return prefix;
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

// 8 blocks of 256 threads an SM (32 registers a thread, 24.8 KB of shared
// memory a block): the most blocks in flight, so fewest waves of the
// block's dependent chain (ticket, partition, staging, math, look-back).
__global__ void __launch_bounds__(kThreads, 8)
row_engine_kernel(const int* __restrict__ table, int n,
                  const int* __restrict__ total_rows, int budget, int tiles_x,
                  float tsx, float inv_tsx, float tsy, int bits_tile,
                  unsigned long long* __restrict__ status,
                  unsigned* __restrict__ tickets, int* __restrict__ istart,
                  unsigned* __restrict__ delta, unsigned* __restrict__ u,
                  int* __restrict__ total) {
  __shared__ int s_cols[kCols][kSpan + 1];  // Gaussians b0 - 1 .. b1 - 1
  __shared__ unsigned s_edge[kRunsPerThread][kWarps][2];  // each piece's last run
  __shared__ unsigned s_piece[kPieces];
  __shared__ int s_ticket, s_b[2];
  __shared__ unsigned s_halo[2], s_total, s_prefix;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) s_ticket = static_cast<int>(atomicAdd(tickets, 1u));
  __syncthreads();
  const int ticket = s_ticket;
  const int d0 = ticket * kSpan;
  const int d1 = min(d0 + kSpan, budget + n);
  if (warp < 2) {
    const int b = ex::merge_path(table, n, budget, warp == 0 ? d0 : d1);
    if (lane == 0) s_b[warp] = b;
  }
  __syncthreads();
  const int b0 = s_b[0], b1 = s_b[1];
  const int a0 = d0 - b0, a1 = d1 - b1;  // this span's runs
  const int w_lo = max(b0 - 1, 0);       // Gaussian of s_cols[.][0]
  const int nw = b1 - w_lo;
  const int lim = min(__ldg(total_rows), budget);

  // Stage the span's Gaussians (and the one before it), every copy in
  // flight at once.
  for (int i = tid; i < nw; i += kThreads) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      cp_async4(&s_cols[c][i], table + static_cast<size_t>(c) * n + w_lo + i);
    }
  }
  if (warp == kWarps - 1) {
    // The halo, run a0 - 1: its Gaussian is the last with rstart < a0,
    // k - 1 for k = #{rstart < a0} <= b0. Starts equal to a0 end the first
    // b0: look 32 back, then search.
    Run h{0u, 0u};
    if (a0 > 0 && a0 < a1) {
      int k = b0;
      if (b0 > 0 && __ldg(table + b0 - 1) >= a0) {
        const int b = b0 - 1 - lane;
        const unsigned below = __ballot_sync(kFull, b < 0 || __ldg(table + b) < a0);
        k = below ? b0 - (__ffs(below) - 1)
                  : ex::warp_partition(0, b0 - 32, [&](int x) { return __ldg(table + x) < a0; });
      }
      const bool owned =
          k > 0 && a0 - 1 < __ldg(table + static_cast<size_t>(kRend) * n + k - 1);
      h = owned ? run_of(
                      a0 - 1,
                      [&](int c) { return __ldg(table + static_cast<size_t>(c) * n + k - 1); },
                      lim, tiles_x, tsx, inv_tsx, tsy, bits_tile)
                : unowned_run(a0 - 1, tiles_x);
    }
    if (lane == 0) {
      s_halo[0] = h.count;
      s_halo[1] = h.packed;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // Each thread's runs: a0 + q * kThreads + tid, for rounds q.
  const int off = b0 - w_lo;  // 1, or 0 when b0 == 0
  unsigned cnt[kRunsPerThread], pk[kRunsPerThread], incl[kRunsPerThread];
#pragma unroll
  for (int q = 0; q < kRunsPerThread; ++q) {
    const int j = a0 + q * kThreads + tid;
    cnt[q] = 0u;
    pk[q] = 0u;
    if (j < a1) {
      // Window index of the run's Gaussian (-1: none).
      const int li = off - 1 + ex::count_le_steps<kSpan>(
                                   s_cols[kRstart] + off, nw - off, j);
      const bool owned = li >= 0 && j < s_cols[kRend][li];
      const Run run =
          owned ? run_of(j, [&](int c) { return s_cols[c][li]; }, lim, tiles_x, tsx,
                         inv_tsx, tsy, bits_tile)
                : unowned_run(j, tiles_x);
      cnt[q] = run.count;
      pk[q] = run.packed;
    }
    incl[q] = warp_inclusive_scan(cnt[q]);
    if (lane == 31) {
      s_piece[q * kWarps + warp] = incl[q];
      s_edge[q][warp][0] = cnt[q];
      s_edge[q][warp][1] = pk[q];
    }
  }
  __syncthreads();

  if (warp == 0) {
    // Exclusive offsets of the (round, warp) pieces, in run order, and the
    // span's sum, published at once.
    const unsigned v = lane < kPieces ? s_piece[lane] : 0u;
    const unsigned scan = warp_inclusive_scan(v);
    if (lane < kPieces) s_piece[lane] = scan - v;
    const unsigned sum = __shfl_sync(kFull, scan, 31);
    unsigned prefix = 0u;
    if (ticket == 0) {
      if (lane == 0) store_status(status, kPrefixReady | sum);
    } else {
      if (lane == 0) store_status(status + ticket, kSumReady | sum);
      prefix = look_back(status, ticket);
      if (lane == 0) store_status(status + ticket, kPrefixReady | (prefix + sum));
    }
    if (lane == 0) {
      s_prefix = prefix;
      s_total = prefix + sum;
    }
  }
  __syncthreads();

  const unsigned prefix = s_prefix;
#pragma unroll
  for (int q = 0; q < kRunsPerThread; ++q) {
    const int j = a0 + q * kThreads + tid;
    const unsigned is = prefix + s_piece[q * kWarps + warp] + incl[q] - cnt[q];
    unsigned prev_count = __shfl_up_sync(kFull, cnt[q], 1);
    unsigned prev_packed = __shfl_up_sync(kFull, pk[q], 1);
    if (lane == 0) {
      // The run before a warp's first: the previous warp's last in this
      // round, the last warp's in the round before, or the halo.
      const int pq = warp > 0 ? q : q - 1, pw = warp > 0 ? warp - 1 : kWarps - 1;
      prev_count = pq >= 0 ? s_edge[pq][pw][0] : s_halo[0];
      prev_packed = pq >= 0 ? s_edge[pq][pw][1] : s_halo[1];
    }
    if (j < a1) {
      istart[j] = static_cast<int>(is);
      u[j] = pk[q] - is;
      delta[j] = pk[q] - prev_packed - prev_count;
      if (j == budget - 1) *total = static_cast<int>(s_total);
    }
  }
}

int n_blocks_of(int budget, int n) {
  return static_cast<int>((static_cast<long long>(budget) + n + kSpan - 1) / kSpan);
}

}  // namespace

// The scratch gsjt_row_engine takes, in 8-byte words: a look-back status
// word per block and the ticket counter.
extern "C" long long gsjt_row_engine_scratch_words(int budget, int n) {
  return static_cast<long long>(n_blocks_of(budget, n)) + 1;
}

// table: (16, n) i32; total_rows: [] i32; scratch: gsjt_row_engine_scratch_
// words 8-byte words, cleared here; outputs istart/delta/u: (budget,) and
// total: [] i32; budget + n < 2^31. One memset, one launch. Returns the
// first error, or 0.
extern "C" int gsjt_row_engine(const int* table, int n, const int* total_rows,
                               int budget, int tiles_x, int tile_w, int tile_h,
                               int bits_tile, void* scratch, int* istart,
                               int* delta, int* u, int* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = n_blocks_of(budget, n);
  auto* status = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      status, 0, (static_cast<size_t>(n_blocks) + 1) * sizeof(*status), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool pow2 = tile_w > 0 && (tile_w & (tile_w - 1)) == 0;
  row_engine_kernel<<<n_blocks, kThreads, 0, s>>>(
      table, n, total_rows, budget, tiles_x, static_cast<float>(tile_w),
      pow2 ? 1.0f / static_cast<float>(tile_w) : 0.0f,
      static_cast<float>(tile_h), bits_tile, status,
      reinterpret_cast<unsigned*>(status + n_blocks), istart,
      reinterpret_cast<unsigned*>(delta), reinterpret_cast<unsigned*>(u), total);
  return static_cast<int>(cudaGetLastError());
}
