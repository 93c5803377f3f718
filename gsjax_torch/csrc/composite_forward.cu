// Forward tile compositing for Hopper (sm_90a).
//
// Replaces: gsjax/render/pallas_kernels.py::composite_forward_pallas
// (_fwd_kernel), the per-tile front-to-back alpha compositing of the
// depth-sorted instance stream. The TPU kernel's `fast` mode is served by
// this exact walk: on this card the exact walk is both faster and closer
// to the oracle (PERF.md).
//
// What bounds it on this card: arithmetic. Every (instance, pixel) pair of
// a tile costs ~20 f32 operations and one exp, against 64 bytes read per
// instance, shared by all of the tile's pixels: at 32x32 tiles that is
// ~20k operations per 64 bytes, far above the card's ~20 FLOP/byte f32
// balance point. Early termination makes the work data-dependent.
//
// Design: one thread block per strip of a tile (up to four strips of
// whole warp blocks and at least 256 pixels each, gsjt::tile_strips: a
// 32x32 tile runs as four 256-thread blocks), one thread per pixel (up
// to 1024; larger strips give each thread up to four pixels,
// composite_walk.cuh). Each block walks the whole tile range for its own
// pixels and stops once they are done.
// The block stages the tile's instance range through shared memory in
// batches of blockDim.x rows (three 16-byte loads per row, one row per
// thread), then every thread walks the batch sequentially in f32 with the
// exact skip/termination rule of the reference (common.py, oracle.py),
// with the arithmetic it shares with the backward (composite_walk.cuh):
//   power > 0 or alpha < 1/255  -> skip
//   T * (1 - alpha) < 1e-4      -> the pixel is done; that contribution
//                                  is not applied
// The TPU kernel's in-chunk log-space cumsums on the matrix unit are not
// needed: a GPU thread owns its pixel and runs the recurrence directly.
// The block leaves its walk once every pixel is done
// (__syncthreads_count), as the TPU kernel's strip skip does.
// Many (instance, warp) pairs are ones that none of the warp's pixels
// can take: a Gaussian reaches ~2.3 tiles, so it covers only some of a
// tile's warps (a third of the pairs at the bench view, PERF.md). Each warp covers an 8x4 block of pixels (the warp map), and
// before its walk it culls, 32 staged rows at a time, every row whose
// footprint box misses its block (one ballot): the walk then steps only
// the rows the ballot keeps, in order, and makes the same decisions bit
// for bit as the walk without the cull. The cull pays only on tiles of
// enough warp blocks: on the bench view (H100) it takes the forward from
// 0.510 to 0.434 ms at 32x32 tiles and from 0.439 to 0.420 at 32x16, but
// at 16x16, where footprints cover most of a tile's eight blocks, it cost
// 0.381 -> 0.404 ms (PERF.md). So a tile culls from kCullMinPixels on.
// The walk itself is gsjt::forward_tile (composite_walk.cuh), which the
// probes of composite_probes.cu instantiate in other modes, and without
// the cull as the reference twin gsjt_composite_forward_nocull.

#include <cuda_runtime.h>

#include "composite_walk.cuh"

namespace {

// Tiles of fewer pixels walk without the cull.
constexpr int kCullMinPixels = 512;

// Two blocks of 1024 threads per SM at one pixel per thread.
template <int PPT, bool kCull>
__global__ void __launch_bounds__(1024, PPT == 1 ? 2 : 1)
composite_forward_kernel(const float* __restrict__ inst,
                         const int* __restrict__ tile_start,
                         float* __restrict__ out_color,
                         float* __restrict__ out_t, int tiles_x, int tile_w,
                         int tile_h, int warp_w, int strips) {
  gsjt::forward_tile<PPT, gsjt::kForward, kCull>(
      inst, tile_start, out_color, out_t, tiles_x, tile_w, tile_h, warp_w,
      strips, 0.0f);
}

}  // namespace

// inst: (P, 16) f32 rows; tile_start: (n_tiles + 1) i32;
// color: (n_tiles, tile_w * tile_h, 3) f32; trans: (n_tiles, tile_w * tile_h).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// tile above 4096 pixels).
extern "C" int gsjt_composite_forward(const float* inst, const int* tile_start,
                                      float* color, float* trans, int n_tiles,
                                      int tiles_x, int tile_w, int tile_h,
                                      void* stream) {
  const int warp_w = gsjt::warp_map(tile_w, tile_h);
  const int strips = gsjt::tile_strips(tile_w, tile_h, warp_w);
  const int pix = tile_w * tile_h / strips;
  const int ppt = gsjt::pixels_per_thread(pix);
  const int threads = gsjt::block_threads(pix, ppt);
  const bool cull = tile_w * tile_h >= kCullMinPixels;
  const size_t smem = gsjt::forward_smem(threads, cull);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gsjt::launch_with_ppt(ppt, [&](auto kPpt) {
    constexpr int P = decltype(kPpt)::value;
    if (cull) {
      composite_forward_kernel<P, true><<<n_tiles * strips, threads, smem, s>>>(
          inst, tile_start, color, trans, tiles_x, tile_w, tile_h, warp_w,
          strips);
    } else {
      composite_forward_kernel<P, false><<<n_tiles * strips, threads, smem, s>>>(
          inst, tile_start, color, trans, tiles_x, tile_w, tile_h, warp_w,
          strips);
    }
  });
}
