// Probe kernels of the composite walk for Hopper (sm_90a): the port's
// counterparts of the JAX package's profiling kernels, which split a
// composite kernel's time into its parts.
//
// Replaces:
//   tools/probe_outpath.py::run (_fwd_kernel_var)        -> outpath_kernel
//   tools/ablate_kernels.py::run_blockout (_blockout_kernel)
//                                                        -> blockout_kernel
//   tools/ablate_kernels.py::run_variant (_variant_kernel)
//                                  -> variant_{dma,walk,bwd}_kernel
//
// What bounds them on this card: what bounds the kernel each one ablates,
// arithmetic for the walks (composite_forward.cu, composite_backward.cu),
// bytes for the load-only variant.
//
// Design: each probe is the main path's own walk (composite_walk.cuh:
// gsjt::forward_tile, gsjt::backward_tile) instantiated in another mode,
// so a probe differs from the kernel it ablates only in what it drops:
//   outpath ship     the forward, written as rows [r, g, b, T, 0...] of a
//                    (T, 8, PIX) block, the TPU kernel's transposed layout
//   outpath notrans  the forward, whose block holds only its sums: the same
//                    write traffic without the layout work
//   blockout         the forward with pixel-major outputs; on this card
//                    that is the forward kernel itself. The TPU grid's
//                    dimension semantics have no counterpart here.
//   dma_only         the staging of every chunk of the range, no walk
//   fwd_nodep        the walk restarted from T = 1 at every 128-instance
//                    chunk: no carried transmittance between chunks
//   fwd_nocond       the walk without its stops: no per-pixel break, no
//                    block exit
//   replay_fwd       the forward's walk with its stops, one float out
//   bwd_nowrite      the backward without its gradient write
// An ablation whose output reads one value keeps every dropped result
// live (gsjt::keep_live, with a run-time zero), so nvcc cannot delete the
// work it stands for.

#include <cuda_runtime.h>

#include "composite_walk.cuh"

namespace {

using gsjt::kChunk;
using gsjt::kRowFloats;

template <int PPT, int kMode>
__global__ void __launch_bounds__(1024)
outpath_kernel(const float* __restrict__ inst,
               const int* __restrict__ tile_start, float* __restrict__ out,
               int tiles_x, int tile_w, int tile_h) {
  gsjt::forward_tile<PPT, kMode>(inst, tile_start, out, nullptr, tiles_x,
                                 tile_w, tile_h, 0.0f);
}

template <int PPT>
__global__ void __launch_bounds__(1024)
blockout_kernel(const float* __restrict__ inst,
                const int* __restrict__ tile_start,
                float* __restrict__ out_color, float* __restrict__ out_t,
                int tiles_x, int tile_w, int tile_h) {
  gsjt::forward_tile<PPT, gsjt::kForward>(inst, tile_start, out_color, out_t,
                                          tiles_x, tile_w, tile_h, 0.0f);
}

template <int PPT, int kMode>
__global__ void __launch_bounds__(1024)
variant_walk_kernel(const float* __restrict__ inst,
                    const int* __restrict__ tile_start,
                    float* __restrict__ out, int tiles_x, int tile_w,
                    int tile_h, float keep) {
  gsjt::forward_tile<PPT, kMode>(inst, tile_start, out, nullptr, tiles_x,
                                 tile_w, tile_h, keep);
}

// Held to the backward's occupancy: at one pixel per thread
// composite_backward_kernel fits in 32 registers, two blocks per SM; without
// the write nvcc takes 47 and halves the blocks in flight.
template <int PPT>
__global__ void __launch_bounds__(1024, PPT == 1 ? 2 : 1)
variant_bwd_kernel(const float* __restrict__ inst,
                   const int* __restrict__ tile_start,
                   const float4* __restrict__ cot, float* __restrict__ out,
                   int tiles_x, int tile_w, int tile_h, float keep) {
  gsjt::backward_tile<PPT, false>(inst, tile_start, cot, out, tiles_x, tile_w,
                                  tile_h, keep);
}

// dma_only: the tile's chunks [c0, c0 + n) staged through shared memory as
// the forward stages rows (batches of blockDim.x rows, 36 bytes each, one
// row per thread), unmasked: the first chunk's rows before i0 too. Output
// 1e-20 * the sum of each chunk's first mean x, in chunk order.
__global__ void __launch_bounds__(1024)
variant_dma_kernel(const float* __restrict__ inst, int n_rows,
                   const int* __restrict__ tile_start,
                   float* __restrict__ out, float keep) {
  extern __shared__ float4 smem[];
  const int batch = blockDim.x;
  float4* s_geo = smem;
  float4* s_col = smem + batch;
  float* s_op = reinterpret_cast<float*>(smem + 2 * batch);

  const int tile = blockIdx.x;
  const int i0 = tile_start[tile];
  const int i1 = tile_start[tile + 1];
  const int c0 = i0 / kChunk;
  const int n = i1 > i0 ? (i1 + kChunk - 1) / kChunk - c0 : 0;
  const int lo = c0 * kChunk;
  const int hi = min((c0 + n) * kChunk, n_rows);
  float acc = 0.0f, fold = 0.0f;
  for (int base = lo; base < hi; base += batch) {
    __syncthreads();  // the previous batch has been read
    const int m = min(batch, hi - base);
    if (threadIdx.x < m) {
      const float4* row = reinterpret_cast<const float4*>(
          inst + static_cast<size_t>(base + threadIdx.x) * kRowFloats);
      s_geo[threadIdx.x] = row[0];
      s_col[threadIdx.x] = row[1];
      s_op[threadIdx.x] = row[2].x;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = (kChunk - base % kChunk) % kChunk; k < m; k += kChunk) {
        acc += s_geo[k].x;
      }
    }
    if (threadIdx.x < m) {  // a neighbour's staged row: the stores are read
      const int q = (threadIdx.x + 1) % m;
      const float4 g = s_geo[q];
      const float4 c = s_col[q];
      fold += g.y + g.z + g.w + c.x + c.y + c.z + c.w + s_op[q];
    }
  }
  if (threadIdx.x == 0) out[tile] = 1e-20f * acc;
  gsjt::keep_live(fold, keep, out + tile);
}

}  // namespace

// The variants of gsjt_variant, by number.
enum Variant : int {
  kDmaOnly = 0,
  kFwdNoDep = 1,
  kFwdNoCond = 2,
  kReplayFwd = 3,
  kBwdNoWrite = 4,
};

// inst: (P, 16) f32 rows; tile_start: (n_tiles + 1) i32;
// out: (n_tiles, 8, tile_w * tile_h) f32. notrans 0 writes the forward's
// rows [r, g, b, T, 0, 0, 0, 0], 1 its block sums.
extern "C" int gsjt_outpath(const float* inst, const int* tile_start,
                            float* out, int n_tiles, int tiles_x, int tile_w,
                            int tile_h, int notrans, void* stream) {
  const int pix = tile_w * tile_h;
  const int ppt = gsjt::pixels_per_thread(pix);
  const int threads = gsjt::block_threads(pix, ppt);
  const size_t smem = threads * (2 * sizeof(float4) + sizeof(float));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gsjt::launch_with_ppt(ppt, [&](auto kPpt) {
    constexpr int P = decltype(kPpt)::value;
    if (notrans) {
      outpath_kernel<P, gsjt::kOutNotrans><<<n_tiles, threads, smem, s>>>(
          inst, tile_start, out, tiles_x, tile_w, tile_h);
    } else {
      outpath_kernel<P, gsjt::kOutShip><<<n_tiles, threads, smem, s>>>(
          inst, tile_start, out, tiles_x, tile_w, tile_h);
    }
  });
}

// As gsjt_composite_forward: color (n_tiles, PIX, 3), trans (n_tiles, PIX).
extern "C" int gsjt_blockout(const float* inst, const int* tile_start,
                             float* color, float* trans, int n_tiles,
                             int tiles_x, int tile_w, int tile_h,
                             void* stream) {
  const int pix = tile_w * tile_h;
  const int ppt = gsjt::pixels_per_thread(pix);
  const int threads = gsjt::block_threads(pix, ppt);
  const size_t smem = threads * (2 * sizeof(float4) + sizeof(float));
  return gsjt::launch_with_ppt(ppt, [&](auto kPpt) {
    blockout_kernel<decltype(kPpt)::value>
        <<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
            inst, tile_start, color, trans, tiles_x, tile_w, tile_h);
  });
}

// inst: (n_rows, 16) f32; tile_start: (n_tiles + 1) i32; cot: (n_tiles,
// PIX, 4) f32, read by kBwdNoWrite only; out: (n_tiles,) f32. keep must be
// 0 (see gsjt::keep_live).
extern "C" int gsjt_variant(const float* inst, int n_rows,
                            const int* tile_start, const float* cot,
                            float* out, int n_tiles, int tiles_x, int tile_w,
                            int tile_h, int variant, float keep,
                            void* stream) {
  const int pix = tile_w * tile_h;
  const int ppt = gsjt::pixels_per_thread(pix);
  const int threads = gsjt::block_threads(pix, ppt);
  const size_t smem = threads * (2 * sizeof(float4) + sizeof(float));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gsjt::launch_with_ppt(ppt, [&](auto kPpt) {
    constexpr int P = decltype(kPpt)::value;
    switch (variant) {
      case kDmaOnly:
        variant_dma_kernel<<<n_tiles, threads, smem, s>>>(
            inst, n_rows, tile_start, out, keep);
        break;
      case kFwdNoDep:
        variant_walk_kernel<P, gsjt::kNoDep><<<n_tiles, threads, smem, s>>>(
            inst, tile_start, out, tiles_x, tile_w, tile_h, keep);
        break;
      case kFwdNoCond:
        variant_walk_kernel<P, gsjt::kNoCond><<<n_tiles, threads, smem, s>>>(
            inst, tile_start, out, tiles_x, tile_w, tile_h, keep);
        break;
      case kReplayFwd:
        variant_walk_kernel<P, gsjt::kReplay><<<n_tiles, threads, smem, s>>>(
            inst, tile_start, out, tiles_x, tile_w, tile_h, keep);
        break;
      default:
        variant_bwd_kernel<P><<<n_tiles, threads, 0, s>>>(
            inst, tile_start, reinterpret_cast<const float4*>(cot), out,
            tiles_x, tile_w, tile_h, keep);
    }
  });
}
