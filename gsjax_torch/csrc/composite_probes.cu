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
// and the main composite kernels' reference twins, which have no TPU
// counterpart: nocull_forward_kernel, nocull_backward_kernel.
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
//   bwd_noshfl       the main backward (warp map and cull) without its
//                    warp butterflies: lane 0's own terms as each warp's
//                    partial, the other lanes' folded into a kept-live sum
//                    (nine adds per walked row in place of 45 shuffles and
//                    45 adds)
// An ablation whose output reads one value keeps every dropped result
// live (gsjt::keep_live, with a run-time zero), so nvcc cannot delete the
// work it stands for. The probes above bwd_noshfl keep the walk they were
// first measured on, the row-major warp map without the cull, so that
// their times stay comparable.
// The twins are the main kernels with the cull off: the same warp map,
// arguments and outputs, every staged row walked by every warp. The main
// kernels must equal them bit for bit (chip_smoke.py, the card tests).

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
                                 tile_w, tile_h, 0, 1, 0.0f);
}

template <int PPT>
__global__ void __launch_bounds__(1024)
blockout_kernel(const float* __restrict__ inst,
                const int* __restrict__ tile_start,
                float* __restrict__ out_color, float* __restrict__ out_t,
                int tiles_x, int tile_w, int tile_h) {
  gsjt::forward_tile<PPT, gsjt::kForward>(inst, tile_start, out_color, out_t,
                                          tiles_x, tile_w, tile_h, 0, 1,
                                          0.0f);
}

// The main kernels' twins: composite_forward.cu's and
// composite_backward.cu's kernels with kCull off.
template <int PPT>
__global__ void __launch_bounds__(1024, PPT == 1 ? 2 : 1)
nocull_forward_kernel(const float* __restrict__ inst,
                      const int* __restrict__ tile_start,
                      float* __restrict__ out_color, float* __restrict__ out_t,
                      int tiles_x, int tile_w, int tile_h, int warp_w,
                      int strips) {
  gsjt::forward_tile<PPT, gsjt::kForward>(inst, tile_start, out_color, out_t,
                                          tiles_x, tile_w, tile_h, warp_w,
                                          strips, 0.0f);
}

__global__ void __launch_bounds__(1024)
nocull_backward_kernel(const float* __restrict__ inst,
                       const int* __restrict__ tile_start,
                       const float4* __restrict__ cot,
                       float* __restrict__ grads, int tiles_x, int tile_w,
                       int tile_h, int warp_w) {
  gsjt::backward_tile<gsjt::kBackwardPpt, gsjt::kBackward>(
      inst, tile_start, cot, grads, tiles_x, tile_w, tile_h, warp_w, 0.0f);
}

template <int PPT, int kMode>
__global__ void __launch_bounds__(1024)
variant_walk_kernel(const float* __restrict__ inst,
                    const int* __restrict__ tile_start,
                    float* __restrict__ out, int tiles_x, int tile_w,
                    int tile_h, float keep) {
  gsjt::forward_tile<PPT, kMode>(inst, tile_start, out, nullptr, tiles_x,
                                 tile_w, tile_h, 0, 1, keep);
}

// bwd_nowrite (one pixel per thread at 32x32) is held to the occupancy of
// the row-major one-pixel backward it ablates, which fit in 32 registers,
// two blocks per SM; without the write nvcc takes 47 and halves the blocks
// in flight.
// bwd_noshfl launches at the main backward's four pixels per thread.
template <int PPT, int kMode, bool kCull>
__global__ void __launch_bounds__(1024, PPT == 1 ? 2 : 1)
variant_bwd_kernel(const float* __restrict__ inst,
                   const int* __restrict__ tile_start,
                   const float4* __restrict__ cot, float* __restrict__ out,
                   int tiles_x, int tile_w, int tile_h, int warp_w,
                   float keep) {
  gsjt::backward_tile<PPT, kMode, kCull>(inst, tile_start, cot, out, tiles_x,
                                         tile_w, tile_h, warp_w, keep);
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
  kBwdNoShfl = 5,
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
  const size_t smem = gsjt::forward_smem(threads, false);
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
  const size_t smem = gsjt::forward_smem(threads, false);
  return gsjt::launch_with_ppt(ppt, [&](auto kPpt) {
    blockout_kernel<decltype(kPpt)::value>
        <<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
            inst, tile_start, color, trans, tiles_x, tile_w, tile_h);
  });
}

// inst: (n_rows, 16) f32; tile_start: (n_tiles + 1) i32; cot: (n_tiles,
// PIX, 4) f32, read by the backward variants only; out: (n_tiles,) f32,
// or for kBwdNoShfl the (n_rows, 16) gradients, zero-filled by the caller.
// keep must be 0 (see gsjt::keep_live).
extern "C" int gsjt_variant(const float* inst, int n_rows,
                            const int* tile_start, const float* cot,
                            float* out, int n_tiles, int tiles_x, int tile_w,
                            int tile_h, int variant, float keep,
                            void* stream) {
  const int pix = tile_w * tile_h;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kBwdNoShfl) {  // the main backward's launch
    const int threads = gsjt::backward_threads(pix);
    if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
    variant_bwd_kernel<gsjt::kBackwardPpt, gsjt::kBwdNoShfl, true>
        <<<n_tiles, threads, gsjt::backward_smem(threads), s>>>(
            inst, tile_start, reinterpret_cast<const float4*>(cot), out,
            tiles_x, tile_w, tile_h, gsjt::warp_map(tile_w, tile_h), keep);
    return static_cast<int>(cudaGetLastError());
  }
  const int ppt = gsjt::pixels_per_thread(pix);
  const int threads = gsjt::block_threads(pix, ppt);
  const size_t smem = gsjt::forward_smem(threads, false);
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
        variant_bwd_kernel<P, gsjt::kBwdNoWrite, false>
            <<<n_tiles, threads, gsjt::backward_smem(threads), s>>>(
            inst, tile_start, reinterpret_cast<const float4*>(cot), out,
            tiles_x, tile_w, tile_h, 0, keep);
    }
  });
}

// The reference twins of gsjt_composite_forward and
// gsjt_composite_backward: the same arguments, outputs and warp map, the
// cull off.
extern "C" int gsjt_composite_forward_nocull(const float* inst,
                                             const int* tile_start,
                                             float* color, float* trans,
                                             int n_tiles, int tiles_x,
                                             int tile_w, int tile_h,
                                             void* stream) {
  const int warp_w = gsjt::warp_map(tile_w, tile_h);
  const int strips = gsjt::tile_strips(tile_w, tile_h, warp_w);
  const int pix = tile_w * tile_h / strips;
  const int ppt = gsjt::pixels_per_thread(pix);
  const int threads = gsjt::block_threads(pix, ppt);
  const size_t smem = gsjt::forward_smem(threads, false);
  return gsjt::launch_with_ppt(ppt, [&](auto kPpt) {
    nocull_forward_kernel<decltype(kPpt)::value>
        <<<n_tiles * strips, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
            inst, tile_start, color, trans, tiles_x, tile_w, tile_h, warp_w,
            strips);
  });
}

extern "C" int gsjt_composite_backward_nocull(const float* inst,
                                              const int* tile_start,
                                              const float* cot, float* grads,
                                              int n_tiles, int tiles_x,
                                              int tile_w, int tile_h,
                                              void* stream) {
  const int threads = gsjt::backward_threads(tile_w * tile_h);
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  nocull_backward_kernel<<<n_tiles, threads, gsjt::backward_smem(threads),
                           static_cast<cudaStream_t>(stream)>>>(
      inst, tile_start, reinterpret_cast<const float4*>(cot), grads, tiles_x,
      tile_w, tile_h, gsjt::warp_map(tile_w, tile_h));
  return static_cast<int>(cudaGetLastError());
}
