// Backward tile compositing for Hopper (sm_90a).
//
// Replaces: gsjax/render/pallas_kernels.py::composite_backward_pallas
// (_bwd_kernel), the forward-order replay that turns per-pixel cotangents
// into per-instance gradients by the suffix algebra of
// gsjax/render/common.py::chunk_backward.
//
// What bounds it on this card: arithmetic and the reduction across pixels.
// Each evaluated (instance, pixel) pair costs the forward's ~20 f32
// operations plus ~30 for its nine gradient terms, against 64 bytes read
// and 64 written per instance; far above the card's f32 balance point.
// Each instance's nine sums run over the tile's pixels, so every
// (instance, warp) pair with a contributing pixel adds a warp reduction.
//
// Design: one block per tile, one thread per pixel (up to 1024; larger
// tiles give each thread up to four pixels, summed in a fixed order before
// the warp reduction), as in the forward. The block stages the tile's
// instance range through shared memory in batches of kBatch rows. Each
// thread walks its pixel front to back with the forward's own arithmetic
// and rule order (composite_walk.cuh), so the replayed skip and
// termination decisions are the forward's bit for bit. It carries T and the scalar suffix A'
// (initially sum dC * C_total + dT * T_final). For each live instance,
// with w = alpha T and s = dC . color:
//   A'      <- A' - w s
//   d_alpha  = s T - A' / (1 - alpha)
//   q        = exp(power) d_alpha       (the 0.99 cap is straight-through)
//   d_op     = q,   d_rgb = w dC,   d_power = op q
// and d_power is chained through power = -0.5 (a dx^2 + c dy^2) - b dx dy
// per pixel. The TPU kernel's tile-centred moment basis on the matrix unit
// is not needed: a thread has its own dx, dy.
// Reduction: a warp skips an instance when __any_sync shows none of its
// pixels contributed (most pairs fail the 1/255 skip); otherwise a fixed
// xor-butterfly of shuffles sums the nine terms, and lane 0 writes the
// warp's partial to shared memory. After the batch, one thread per output
// element sums the warps' partials in warp order and writes the instance's
// 64-byte row; each instance belongs to exactly one tile, so no global
// atomics are needed. The reduction order is fixed: the gradients are
// bitwise reproducible run to run. Against the plain walk (f32 log-space
// cumsums, render/tiled.py::composite_backward_tiles) they agree within a
// per-row scaled 5e-3, the tolerance the JAX package holds its own
// backward to.
// The cull: each warp covers an 8x4 block of pixels (the warp map) and,
// before walking a batch, drops the rows whose footprint box misses its
// block (one ballot for the batch's 32 rows), so a Gaussian costs only the
// warps it can reach: their steps, votes, butterflies and partials. A warp
// stores a partial only for a row one of its pixels took, and marks it in
// a per-row warp mask; the after-batch pass sums only the marked partials,
// in warp order. The culled rows are ones every pixel of the warp skips,
// so the gradients are bitwise those of the walk without the cull.
// The block leaves once every pixel is done, as the forward does. Rows it
// never reaches, and every slot past the last tile's range, are left to
// the caller's zero-filled output. The walk itself is gsjt::backward_tile
// (composite_walk.cuh), which composite_probes.cu instantiates without the
// write (bwd_nowrite), without the butterflies (bwd_noshfl) and without
// the cull (the reference twin gsjt_composite_backward_nocull).

#include <cuda_runtime.h>

#include "composite_walk.cuh"

namespace {

__global__ void __launch_bounds__(1024)
composite_backward_kernel(const float* __restrict__ inst,
                          const int* __restrict__ tile_start,
                          const float4* __restrict__ cot,
                          float* __restrict__ grads, int tiles_x, int tile_w,
                          int tile_h, int warp_w) {
  gsjt::backward_tile<gsjt::kBackwardPpt, gsjt::kBackward, true>(
      inst, tile_start, cot, grads, tiles_x, tile_w, tile_h, warp_w, 0.0f);
}

}  // namespace

// inst: (P, 16) f32 rows; tile_start: (n_tiles + 1) i32;
// cot: (n_tiles, tile_w * tile_h, 4) f32 [dC_r, dC_g, dC_b, A'_0];
// grads: (P, 16) f32, zero-filled by the caller.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// tile above 4096 pixels).
extern "C" int gsjt_composite_backward(const float* inst,
                                       const int* tile_start,
                                       const float* cot, float* grads,
                                       int n_tiles, int tiles_x, int tile_w,
                                       int tile_h, void* stream) {
  const int threads = gsjt::backward_threads(tile_w * tile_h);
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  composite_backward_kernel<<<n_tiles, threads, gsjt::backward_smem(threads),
                              static_cast<cudaStream_t>(stream)>>>(
      inst, tile_start, reinterpret_cast<const float4*>(cot), grads, tiles_x,
      tile_w, tile_h, gsjt::warp_map(tile_w, tile_h));
  return static_cast<int>(cudaGetLastError());
}
