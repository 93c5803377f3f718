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
// so a probe differs from the kernel it ablates only in what it drops.
// The probes launch as the kernels that ship: outpath, blockout and the
// forward variants take the main forward's launch (gsjt::forward_launch:
// the warp map, one block per strip, the cull from 512-pixel tiles on),
// the backward variants the main backward's (four pixels per thread, the
// warp map, the cull):
//   outpath ship     the forward's colour and T as rows 0-3 of a (T, 8,
//                    PIX) block, rows 4-7 zero: the forward's bits
//   outpath notrans  the same walk, one sum a tile: each strip's block
//                    sums its pixels (gsjt::block_sum) into a partial; the
//                    tile's last block to arrive (a fence, then an atomic
//                    count) adds the partials in strip order, so every
//                    call gives the same bits
//   blockout         the forward with pixel-major outputs: the forward
//                    kernel itself, bit for bit. The TPU grid's dimension
//                    semantics have no counterpart here.
//   dma_only         the staging of every chunk of the tile's range, once
//                    per strip block, no walk
//   fwd_nodep        the walk restarted from T = 1 at every 128-instance
//                    chunk: no carried transmittance between chunks
//   fwd_nocond       the walk without its stops: no per-pixel break, no
//                    block exit
//   replay_fwd       the forward's walk with its stops, one float out: the
//                    forward's red at pixel 0, bit for bit
//   bwd_nowrite      the backward without its gradient write
//   bwd_noshfl       the backward without its warp butterflies: lane 0's
//                    own terms as each warp's partial, the other lanes'
//                    folded into a kept-live sum (nine adds per walked row
//                    in place of 45 shuffles and 45 adds)
// The one-float probes write out[t] from strip 0 (pixel 0 lies there);
// the cull drops only rows that every pixel of a warp skips (power > 0 or
// alpha < 1/255), a rule none of the modes changes, so it is exact for
// them. An ablation whose output reads one value keeps every dropped
// result live (gsjt::keep_live, with a run-time zero), so nvcc cannot
// delete the work it stands for.
// The twins are the main kernels with the cull off: the same warp map,
// arguments and outputs, every staged row walked by every warp. The main
// kernels must equal them bit for bit (chip_smoke.py, the card tests).

#include <cuda_runtime.h>

#include "composite_walk.cuh"

namespace {

using gsjt::kChunk;
using gsjt::kRowFloats;

// At the main forward's launch bounds. notrans: partials (n_tiles *
// strips) f32 and arrivals (n_tiles) i32, zero on entry.
template <int PPT, int kMode, bool kCull>
__global__ void __launch_bounds__(1024, PPT == 1 ? 2 : 1)
outpath_kernel(const float* __restrict__ inst,
               const int* __restrict__ tile_start, float* __restrict__ out,
               float* partials, int* __restrict__ arrivals, int tiles_x,
               int tile_w, int tile_h, int warp_w, int strips) {
  gsjt::forward_tile<PPT, kMode, kCull>(inst, tile_start, out, partials,
                                        tiles_x, tile_w, tile_h, warp_w,
                                        strips, 0.0f);
  if constexpr (kMode == gsjt::kOutNotrans) {
    if (threadIdx.x == 0) {  // the thread that stored this strip's partial
      const int tile = blockIdx.x / strips;
      __threadfence();
      if (atomicAdd(arrivals + tile, 1) == strips - 1) {
        __threadfence();
        const volatile float* part =
            partials + static_cast<size_t>(tile) * strips;
        float total = 0.0f;
        for (int s = 0; s < strips; ++s) total += part[s];
        out[static_cast<size_t>(tile) * 8 * tile_w * tile_h] = total;
      }
    }
  }
}

// composite_forward.cu's kernel under the probe's name.
template <int PPT, bool kCull>
__global__ void __launch_bounds__(1024, PPT == 1 ? 2 : 1)
blockout_kernel(const float* __restrict__ inst,
                const int* __restrict__ tile_start,
                float* __restrict__ out_color, float* __restrict__ out_t,
                int tiles_x, int tile_w, int tile_h, int warp_w, int strips) {
  gsjt::forward_tile<PPT, gsjt::kForward, kCull>(
      inst, tile_start, out_color, out_t, tiles_x, tile_w, tile_h, warp_w,
      strips, 0.0f);
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

// The forward variants, at the main forward's launch bounds.
template <int PPT, int kMode, bool kCull>
__global__ void __launch_bounds__(1024, PPT == 1 ? 2 : 1)
variant_walk_kernel(const float* __restrict__ inst,
                    const int* __restrict__ tile_start,
                    float* __restrict__ out, int tiles_x, int tile_w,
                    int tile_h, int warp_w, int strips, float keep) {
  gsjt::forward_tile<PPT, kMode, kCull>(inst, tile_start, out, nullptr,
                                        tiles_x, tile_w, tile_h, warp_w,
                                        strips, keep);
}

// The backward variants, at composite_backward.cu's launch and launch
// bounds (at most 64 registers a thread, which at 32x32 tiles' 256-thread
// blocks leaves four blocks on an SM): each is that kernel less one part,
// in the same occupancy.
template <int kMode>
__global__ void __launch_bounds__(1024)
variant_bwd_kernel(const float* __restrict__ inst,
                   const int* __restrict__ tile_start,
                   const float4* __restrict__ cot, float* __restrict__ out,
                   int tiles_x, int tile_w, int tile_h, int warp_w,
                   float keep) {
  gsjt::backward_tile<gsjt::kBackwardPpt, kMode, true>(
      inst, tile_start, cot, out, tiles_x, tile_w, tile_h, warp_w, keep);
}

// dma_only: the tile's chunks [c0, c0 + n) staged through shared memory as
// the forward stages rows (batches of blockDim.x rows, 36 bytes each, one
// row per thread), unmasked: the first chunk's rows before i0 too, by each
// of the tile's `strips` blocks. Output (strip 0) 1e-20 * the sum of each
// chunk's first mean x, in chunk order.
__global__ void __launch_bounds__(1024)
variant_dma_kernel(const float* __restrict__ inst, int n_rows,
                   const int* __restrict__ tile_start,
                   float* __restrict__ out, int strips, float keep) {
  extern __shared__ float4 smem[];
  const int batch = blockDim.x;
  float4* s_geo = smem;
  float4* s_col = smem + batch;
  float* s_op = reinterpret_cast<float*>(smem + 2 * batch);

  const int tile = blockIdx.x / strips;
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
  if (threadIdx.x == 0 && blockIdx.x % strips == 0) out[tile] = 1e-20f * acc;
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

namespace {

template <int P, int kMode>
void launch_outpath(const gsjt::ForwardLaunch& l, int n_tiles, cudaStream_t s,
                    const float* inst, const int* tile_start, float* out,
                    float* partials, int* arrivals, int tiles_x, int tile_w,
                    int tile_h) {
  if (l.cull) {
    outpath_kernel<P, kMode, true><<<n_tiles * l.strips, l.threads, l.smem, s>>>(
        inst, tile_start, out, partials, arrivals, tiles_x, tile_w, tile_h,
        l.warp_w, l.strips);
  } else {
    outpath_kernel<P, kMode, false><<<n_tiles * l.strips, l.threads, l.smem, s>>>(
        inst, tile_start, out, partials, arrivals, tiles_x, tile_w, tile_h,
        l.warp_w, l.strips);
  }
}

}  // namespace

// As gsjt_composite_forward, at its launch. inst: (P, 16) f32 rows;
// tile_start: (n_tiles + 1) i32; out: (n_tiles, 8, tile_w * tile_h) f32.
// notrans 0 writes the forward's rows [r, g, b, T, 0, 0, 0, 0], 1 the
// tiles' sums at [t, 0, 0] and zeros elsewhere; notrans needs partials,
// (n_tiles * gsjt::kMaxStrips) f32 scratch, and arrivals, (n_tiles) i32
// zeros, which ship ignores.
extern "C" int gsjt_outpath(const float* inst, const int* tile_start,
                            float* out, float* partials, int* arrivals,
                            int n_tiles, int tiles_x, int tile_w, int tile_h,
                            int notrans, void* stream) {
  const gsjt::ForwardLaunch l = gsjt::forward_launch(tile_w, tile_h);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gsjt::launch_with_ppt(l.ppt, [&](auto kPpt) {
    constexpr int P = decltype(kPpt)::value;
    if (notrans) {
      launch_outpath<P, gsjt::kOutNotrans>(l, n_tiles, s, inst, tile_start, out,
                                           partials, arrivals, tiles_x, tile_w,
                                           tile_h);
    } else {
      launch_outpath<P, gsjt::kOutShip>(l, n_tiles, s, inst, tile_start, out,
                                        partials, arrivals, tiles_x, tile_w,
                                        tile_h);
    }
  });
}

// As gsjt_composite_forward, at its launch: color (n_tiles, PIX, 3), trans
// (n_tiles, PIX).
extern "C" int gsjt_blockout(const float* inst, const int* tile_start,
                             float* color, float* trans, int n_tiles,
                             int tiles_x, int tile_w, int tile_h,
                             void* stream) {
  const gsjt::ForwardLaunch l = gsjt::forward_launch(tile_w, tile_h);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gsjt::launch_with_ppt(l.ppt, [&](auto kPpt) {
    constexpr int P = decltype(kPpt)::value;
    if (l.cull) {
      blockout_kernel<P, true><<<n_tiles * l.strips, l.threads, l.smem, s>>>(
          inst, tile_start, color, trans, tiles_x, tile_w, tile_h, l.warp_w,
          l.strips);
    } else {
      blockout_kernel<P, false><<<n_tiles * l.strips, l.threads, l.smem, s>>>(
          inst, tile_start, color, trans, tiles_x, tile_w, tile_h, l.warp_w,
          l.strips);
    }
  });
}

namespace {

template <int P, int kMode>
void launch_walk(const gsjt::ForwardLaunch& l, int n_tiles, cudaStream_t s,
                 const float* inst, const int* tile_start, float* out,
                 int tiles_x, int tile_w, int tile_h, float keep) {
  if (l.cull) {
    variant_walk_kernel<P, kMode, true><<<n_tiles * l.strips, l.threads, l.smem, s>>>(
        inst, tile_start, out, tiles_x, tile_w, tile_h, l.warp_w, l.strips, keep);
  } else {
    variant_walk_kernel<P, kMode, false><<<n_tiles * l.strips, l.threads, l.smem, s>>>(
        inst, tile_start, out, tiles_x, tile_w, tile_h, l.warp_w, l.strips, keep);
  }
}

}  // namespace

// inst: (n_rows, 16) f32; tile_start: (n_tiles + 1) i32; cot: (n_tiles,
// PIX, 4) f32, read by the backward variants only; out: (n_tiles,) f32,
// or for kBwdNoShfl the (n_rows, 16) gradients, zero-filled by the caller.
// keep must be 0 (see gsjt::keep_live). An unknown variant is
// cudaErrorInvalidValue.
extern "C" int gsjt_variant(const float* inst, int n_rows,
                            const int* tile_start, const float* cot,
                            float* out, int n_tiles, int tiles_x, int tile_w,
                            int tile_h, int variant, float keep,
                            void* stream) {
  if (variant < kDmaOnly || variant > kBwdNoShfl) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kBwdNoWrite || variant == kBwdNoShfl) {  // the main backward's launch
    const int threads = gsjt::backward_threads(tile_w * tile_h);
    if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = gsjt::backward_smem(threads);
    const float4* c = reinterpret_cast<const float4*>(cot);
    const int warp_w = gsjt::warp_map(tile_w, tile_h);
    if (variant == kBwdNoShfl) {
      variant_bwd_kernel<gsjt::kBwdNoShfl><<<n_tiles, threads, smem, s>>>(
          inst, tile_start, c, out, tiles_x, tile_w, tile_h, warp_w, keep);
    } else {
      variant_bwd_kernel<gsjt::kBwdNoWrite><<<n_tiles, threads, smem, s>>>(
          inst, tile_start, c, out, tiles_x, tile_w, tile_h, warp_w, keep);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const gsjt::ForwardLaunch l = gsjt::forward_launch(tile_w, tile_h);
  if (variant == kDmaOnly) {
    if (l.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
    // The rows alone: 36 bytes a staged row, no boxes.
    variant_dma_kernel<<<n_tiles * l.strips, l.threads,
                         gsjt::forward_smem(l.threads, false), s>>>(
        inst, n_rows, tile_start, out, l.strips, keep);
    return static_cast<int>(cudaGetLastError());
  }
  return gsjt::launch_with_ppt(l.ppt, [&](auto kPpt) {
    constexpr int P = decltype(kPpt)::value;
    switch (variant) {
      case kFwdNoDep:
        launch_walk<P, gsjt::kNoDep>(l, n_tiles, s, inst, tile_start, out,
                                     tiles_x, tile_w, tile_h, keep);
        break;
      case kFwdNoCond:
        launch_walk<P, gsjt::kNoCond>(l, n_tiles, s, inst, tile_start, out,
                                      tiles_x, tile_w, tile_h, keep);
        break;
      default:  // kReplayFwd
        launch_walk<P, gsjt::kReplay>(l, n_tiles, s, inst, tile_start, out,
                                      tiles_x, tile_w, tile_h, keep);
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
  const gsjt::ForwardLaunch l = gsjt::forward_launch(tile_w, tile_h);
  return gsjt::launch_with_ppt(l.ppt, [&](auto kPpt) {
    nocull_forward_kernel<decltype(kPpt)::value>
        <<<n_tiles * l.strips, l.threads, gsjt::forward_smem(l.threads, false),
           static_cast<cudaStream_t>(stream)>>>(
            inst, tile_start, color, trans, tiles_x, tile_w, tile_h, l.warp_w,
            l.strips);
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
