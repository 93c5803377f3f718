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
// Design: one thread block per tile, one thread per pixel (up to 1024).
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

#include <cuda_runtime.h>

#include "composite_walk.cuh"

namespace {

using gsjt::kRowFloats;

__global__ void __launch_bounds__(1024)
composite_forward_kernel(const float* __restrict__ inst,
                         const int* __restrict__ tile_start,
                         float* __restrict__ out_color,
                         float* __restrict__ out_t, int tiles_x, int tile_w,
                         int tile_h) {
  extern __shared__ float4 smem[];
  const int batch = blockDim.x;
  float4* s_geo = smem;          // (mx, my, ca, cb)
  float4* s_col = smem + batch;  // (cc, r, g, b)
  float* s_op = reinterpret_cast<float*>(smem + 2 * batch);

  const int tile = blockIdx.x;
  const int pix = tile_w * tile_h;
  const int p = threadIdx.x;
  const bool inside = p < pix;
  const float px = static_cast<float>((tile % tiles_x) * tile_w + p % tile_w);
  const float py = static_cast<float>((tile / tiles_x) * tile_h + p / tile_w);
  const int i0 = tile_start[tile];
  const int i1 = tile_start[tile + 1];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cbl = 0.0f;
  bool done = !inside;
  for (int base = i0; base < i1; base += batch) {
    // Also the barrier that keeps the previous batch's rows until every
    // thread has read them.
    if (__syncthreads_count(done) == batch) break;
    const int n = min(batch, i1 - base);
    if (p < n) {
      const float4* row = reinterpret_cast<const float4*>(
          inst + static_cast<size_t>(base + p) * kRowFloats);
      s_geo[p] = row[0];
      s_col[p] = row[1];
      s_op[p] = row[2].x;
    }
    __syncthreads();
    if (done) continue;
    for (int k = 0; k < n; ++k) {
      const float4 g = s_geo[k];
      const float4 c = s_col[k];
      const float power = gsjt::walk_power(gsjt::walk_delta(g.x, px),
                                           gsjt::walk_delta(g.y, py), g.z,
                                           g.w, c.x);
      if (power > 0.0f) continue;
      const float alpha = gsjt::walk_alpha(s_op[k], expf(power));
      if (alpha < gsjt::kAlphaSkip) continue;
      const float t_next = gsjt::walk_t_next(T, alpha);
      if (t_next < gsjt::kTEps) {
        done = true;
        break;
      }
      const float w = alpha * T;
      cr += c.y * w;
      cg += c.z * w;
      cbl += c.w * w;
      T = t_next;
    }
  }
  if (inside) {
    const size_t o = static_cast<size_t>(tile) * pix + p;
    out_color[3 * o + 0] = cr;
    out_color[3 * o + 1] = cg;
    out_color[3 * o + 2] = cbl;
    out_t[o] = T;
  }
}

}  // namespace

// inst: (P, 16) f32 rows; tile_start: (n_tiles + 1) i32;
// color: (n_tiles, tile_w * tile_h, 3) f32; trans: (n_tiles, tile_w * tile_h).
// Returns cudaGetLastError() after the launch.
extern "C" int gsjt_composite_forward(const float* inst, const int* tile_start,
                                      float* color, float* trans, int n_tiles,
                                      int tiles_x, int tile_w, int tile_h,
                                      void* stream) {
  const int pix = tile_w * tile_h;
  const int threads = (pix + 31) / 32 * 32;
  const size_t smem = threads * (2 * sizeof(float4) + sizeof(float));
  composite_forward_kernel<<<n_tiles, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      inst, tile_start, color, trans, tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}
