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
// What bounds it on this card: memory and latency. It reads one 4-byte
// word of each of 12 table columns per run (a gather: a run reads its
// Gaussian's entries) and writes 12 bytes per run, with ~60 f32 operations
// per run; at the render's shapes that is a few tens of MB, microseconds
// of traffic, so the three short launches' latency is a visible share.
//
// Design: the TPU kernel walks the output blocks in order and carries the
// running instance count and the previous row's u across its sequential
// grid in scalar memory, and selects each row's Gaussian with a one-hot
// limb contraction on the matrix unit. Blocks of a GPU grid run in no
// order, so the carry becomes a scan across blocks, in three launches:
//   1. one thread per run: binary search of the run's Gaussian over the
//      sorted run starts, the interval math, the count and the packed
//      word (g << bits_tile) | tile_base; one sum per 1024-run block;
//   2. one block: exclusive scan of the block sums;
//   3. one thread per run: block-local scan plus the block's offset gives
//      istart, u and delta; u_prev at a block's first run is recomputed
//      from the previous run's count and word.
// The interval math must agree bit for bit with the plain PyTorch version
// (a last-ulp difference moves an instance across a tile boundary), so
// this file is built with --fmad=false and IEEE division and square root,
// and its max/min propagate NaN as torch.maximum/minimum do.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;  // runs per block (the host's ROW_BLOCK)
constexpr unsigned kFull = 0xffffffffu;

// Table columns (kernels.py TAB_*): a (16, n) int32 array.
constexpr int kRstart = 0, kRend = 1, kY0 = 2, kX0 = 3, kX1 = 4, kMx = 5,
              kMy = 6, kCa = 7, kCb = 8, kCc = 9, kQmax = 10, kG = 11;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
// f32 -> i32 truncating, saturating, NaN -> 0 (cvt.rzi.s32.f32).
__device__ __forceinline__ int f2i(float x) { return __float2int_rz(x); }

// Inclusive scan over the block (blockDim.x a multiple of 32, <= 1024).
__device__ int block_inclusive_scan(int v, int* warp_buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < (blockDim.x >> 5) ? warp_buf[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += t;
    }
    warp_buf[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_buf[warp - 1];
  __syncthreads();  // warp_buf is free again on return
  return v;
}

__global__ void __launch_bounds__(kBlock)
row_engine_rows(const int* __restrict__ table, int n,
                const int* __restrict__ total_rows, int budget, int tiles_x,
                float tsx, float tsy, int bits_tile, int* __restrict__ counts,
                unsigned* __restrict__ packed, int* __restrict__ block_sums) {
  __shared__ int warp_buf[32];
  const int j = blockIdx.x * kBlock + threadIdx.x;
  int count = 0;
  if (j < budget) {
    // The run's Gaussian: the last g with rstart_g <= j.
    const int* rstart = table + static_cast<size_t>(kRstart) * n;
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rstart[mid] <= j) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int gc = min(max(lo - 1, 0), n - 1);
    const bool owned = lo > 0 && rstart[gc] <= j &&
                       j < table[static_cast<size_t>(kRend) * n + gc];
    // A run past total_rows has no Gaussian: its columns read as zero.
    auto col = [&](int c) {
      return owned ? table[static_cast<size_t>(c) * n + gc] : 0;
    };
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

    int rx0 = f2i(ceilf((mx + x_lo - (tsx - 1.0f)) / tsx));
    int rx1 = static_cast<int>(
        static_cast<unsigned>(f2i(floorf((mx + x_hi) / tsx))) + 1u);
    rx0 = max(rx0, col(kX0));
    rx1 = min(rx1, col(kX1));
    const bool rvalid = j < min(*total_rows, budget);
    const int width =
        static_cast<int>(static_cast<unsigned>(rx1) - static_cast<unsigned>(rx0));
    count = (rvalid && nonempty) ? max(width, 0) : 0;
    const unsigned tile_base =
        static_cast<unsigned>(ty) * static_cast<unsigned>(tiles_x) +
        static_cast<unsigned>(rx0);
    counts[j] = count;
    packed[j] = (static_cast<unsigned>(col(kG)) << bits_tile) | tile_base;
  }
  const int sum = block_inclusive_scan(count, warp_buf);
  if (threadIdx.x == kBlock - 1) block_sums[blockIdx.x] = sum;
}

// In place: block_sums[b] <- sum of block_sums[0..b).
__global__ void __launch_bounds__(kBlock)
row_engine_scan(int* __restrict__ block_sums, int n_blocks) {
  __shared__ int warp_buf[32];
  __shared__ int chunk_total;
  int carry = 0;
  for (int base = 0; base < n_blocks; base += kBlock) {
    const int i = base + threadIdx.x;
    const int v = i < n_blocks ? block_sums[i] : 0;
    const int incl = block_inclusive_scan(v, warp_buf);
    if (i < n_blocks) block_sums[i] = carry + incl - v;
    if (threadIdx.x == kBlock - 1) chunk_total = incl;
    __syncthreads();
    carry += chunk_total;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kBlock)
row_engine_finish(const int* __restrict__ counts,
                  const unsigned* __restrict__ packed,
                  const int* __restrict__ block_offsets, int budget,
                  int* __restrict__ istart, unsigned* __restrict__ delta,
                  unsigned* __restrict__ u, int* __restrict__ total) {
  __shared__ int warp_buf[32];
  __shared__ unsigned s_u[kBlock];
  const int j = blockIdx.x * kBlock + threadIdx.x;
  const int offset = block_offsets[blockIdx.x];
  const int c = j < budget ? counts[j] : 0;
  const int icum = block_inclusive_scan(c, warp_buf) + offset;
  const int is = icum - c;
  const unsigned uj = j < budget ? packed[j] - static_cast<unsigned>(is) : 0u;
  s_u[threadIdx.x] = uj;
  __syncthreads();
  if (j >= budget) return;
  unsigned u_prev = 0u;
  if (threadIdx.x > 0) {
    u_prev = s_u[threadIdx.x - 1];
  } else if (j > 0) {
    // Run j-1 ends the previous block: its istart is offset - count.
    u_prev = packed[j - 1] - static_cast<unsigned>(offset - counts[j - 1]);
  }
  istart[j] = is;
  u[j] = uj;
  delta[j] = uj - u_prev;
  if (j == budget - 1) *total = icum;
}

}  // namespace

// table: (16, n) i32; total_rows: [] i32; scratch counts/packed: (budget,),
// block_sums: (ceil(budget / 1024),); outputs istart/delta/u: (budget,) and
// total: [] i32. Returns the first launch error, or 0.
extern "C" int gsjt_row_engine(const int* table, int n, const int* total_rows,
                               int budget, int tiles_x, int tile_w, int tile_h,
                               int bits_tile, int* counts, int* packed,
                               int* block_sums, int* istart, int* delta,
                               int* u, int* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = (budget + kBlock - 1) / kBlock;
  unsigned* packed_u = reinterpret_cast<unsigned*>(packed);
  row_engine_rows<<<n_blocks, kBlock, 0, s>>>(
      table, n, total_rows, budget, tiles_x, static_cast<float>(tile_w),
      static_cast<float>(tile_h), bits_tile, counts, packed_u, block_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_engine_scan<<<1, kBlock, 0, s>>>(block_sums, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_engine_finish<<<n_blocks, kBlock, 0, s>>>(
      counts, packed_u, block_sums, budget, istart,
      reinterpret_cast<unsigned*>(delta), reinterpret_cast<unsigned*>(u),
      total);
  return static_cast<int>(cudaGetLastError());
}
