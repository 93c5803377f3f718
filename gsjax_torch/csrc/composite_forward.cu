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
// Design: one thread block per tile, one thread per pixel (up to 1024;
// larger tiles give each thread up to four pixels, composite_walk.cuh).
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
// (__syncthreads_count), as the TPU kernel's strip skip does. The walk
// itself is gsjt::forward_tile, which the probes of composite_probes.cu
// instantiate in other modes.

#include <cuda_runtime.h>

#include "composite_walk.cuh"

namespace {

template <int PPT>
__global__ void __launch_bounds__(1024)
composite_forward_kernel(const float* __restrict__ inst,
                         const int* __restrict__ tile_start,
                         float* __restrict__ out_color,
                         float* __restrict__ out_t, int tiles_x, int tile_w,
                         int tile_h) {
  gsjt::forward_tile<PPT, gsjt::kForward>(inst, tile_start, out_color, out_t,
                                          tiles_x, tile_w, tile_h, 0.0f);
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
  const int pix = tile_w * tile_h;
  const int ppt = gsjt::pixels_per_thread(pix);
  const int threads = gsjt::block_threads(pix, ppt);
  const size_t smem = threads * (2 * sizeof(float4) + sizeof(float));
  return gsjt::launch_with_ppt(ppt, [&](auto kPpt) {
    composite_forward_kernel<decltype(kPpt)::value>
        <<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
            inst, tile_start, color, trans, tiles_x, tile_w, tile_h);
  });
}
