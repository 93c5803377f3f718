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
// Design: one block per tile, one thread per pixel (up to 1024), as in the
// forward. The block stages the tile's instance range through shared
// memory in batches of kBatch rows. Each thread walks its pixel front to
// back with the forward's own arithmetic and rule order
// (composite_walk.cuh), so the replayed skip and termination decisions are
// the forward's bit for bit. It carries T and the scalar suffix A'
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
// The block leaves once every pixel is done, as the forward does. Rows it
// never reaches, and every slot past the last tile's range, are left to
// the caller's zero-filled output.

#include <cuda_runtime.h>

#include "composite_walk.cuh"

namespace {

using gsjt::kRowFloats;

constexpr int kBatch = 32;     // instances staged per batch
constexpr int kMaxWarps = 32;  // 1024 pixels
constexpr int kGrads = 9;      // dmx, dmy, dca, dcb, dcc, dr, dg, db, dop
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(1024)
composite_backward_kernel(const float* __restrict__ inst,
                          const int* __restrict__ tile_start,
                          const float4* __restrict__ cot,
                          float* __restrict__ grads, int tiles_x, int tile_w,
                          int tile_h) {
  __shared__ float4 s_geo[kBatch];  // (mx, my, ca, cb)
  __shared__ float4 s_col[kBatch];  // (cc, r, g, b)
  __shared__ float s_op[kBatch];
  __shared__ float s_part[kMaxWarps][kBatch][kGrads];

  const int tile = blockIdx.x;
  const int pix = tile_w * tile_h;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool inside = p < pix;
  const float px = static_cast<float>((tile % tiles_x) * tile_w + p % tile_w);
  const float py = static_cast<float>((tile / tiles_x) * tile_h + p / tile_w);
  const int i0 = tile_start[tile];
  const int i1 = tile_start[tile + 1];

  // [dC_r, dC_g, dC_b, A'_0] for this pixel.
  const float4 ct = inside ? cot[static_cast<size_t>(tile) * pix + p]
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float T = 1.0f;
  float suffix = ct.w;
  bool done = !inside;

  for (int base = i0; base < i1; base += kBatch) {
    // Also the barrier that keeps the previous batch's rows and partials
    // until every thread has read them.
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    const int n = min(kBatch, i1 - base);
    if (p < n) {
      const float4* row = reinterpret_cast<const float4*>(
          inst + static_cast<size_t>(base + p) * kRowFloats);
      s_geo[p] = row[0];
      s_col[p] = row[1];
      s_op[p] = row[2].x;
    }
    __syncthreads();

    if (__all_sync(kFull, done)) {
      float* part = &s_part[warp][0][0];
      for (int i = lane; i < n * kGrads; i += 32) part[i] = 0.0f;
    } else {
#pragma unroll 2
      for (int k = 0; k < n; ++k) {
        float v[kGrads];
#pragma unroll
        for (int j = 0; j < kGrads; ++j) v[j] = 0.0f;
        bool live = false;
        if (!done) {
          const float4 g = s_geo[k];
          const float4 c = s_col[k];
          const float op = s_op[k];
          const float dx = gsjt::walk_delta(g.x, px);
          const float dy = gsjt::walk_delta(g.y, py);
          const float power = gsjt::walk_power(dx, dy, g.z, g.w, c.x);
          const float falloff = power > 0.0f ? 0.0f : expf(power);
          const float alpha = gsjt::walk_alpha(op, falloff);
          const float t_next = gsjt::walk_t_next(T, alpha);
          if (power > 0.0f || alpha < gsjt::kAlphaSkip) {
            // skipped: adds nothing
          } else if (t_next < gsjt::kTEps) {
            done = true;
          } else {
            live = true;
            const float w = alpha * T;
            const float s = ct.x * c.y + ct.y * c.z + ct.z * c.w;
            suffix -= w * s;
            const float d_alpha = s * T - suffix / (1.0f - alpha);
            const float q = falloff * d_alpha;
            const float d_power = op * q;
            v[0] = -d_power * (g.z * dx + g.w * dy);
            v[1] = -d_power * (c.x * dy + g.w * dx);
            v[2] = -0.5f * d_power * dx * dx;
            v[3] = -d_power * dx * dy;
            v[4] = -0.5f * d_power * dy * dy;
            v[5] = w * ct.x;
            v[6] = w * ct.y;
            v[7] = w * ct.z;
            v[8] = q;
            T = t_next;
          }
        }
        if (__any_sync(kFull, live)) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int j = 0; j < kGrads; ++j) {
              v[j] += __shfl_xor_sync(kFull, v[j], off);
            }
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < kGrads; ++j) s_part[warp][k][j] = v[j];
        }
      }
    }
    __syncthreads();

    // One thread per output element: the warps' partials in warp order,
    // then the row written whole (columns past the nine are zero).
    for (int e = p; e < n * kRowFloats; e += blockDim.x) {
      const int k = e / kRowFloats;
      const int j = e % kRowFloats;
      float sum = 0.0f;
      if (j < kGrads) {
        for (int w = 0; w < n_warps; ++w) sum += s_part[w][k][j];
      }
      grads[static_cast<size_t>(base) * kRowFloats + e] = sum;
    }
  }
}

}  // namespace

// inst: (P, 16) f32 rows; tile_start: (n_tiles + 1) i32;
// cot: (n_tiles, tile_w * tile_h, 4) f32 [dC_r, dC_g, dC_b, A'_0];
// grads: (P, 16) f32, zero-filled by the caller.
// Returns cudaGetLastError() after the launch.
extern "C" int gsjt_composite_backward(const float* inst,
                                       const int* tile_start,
                                       const float* cot, float* grads,
                                       int n_tiles, int tiles_x, int tile_w,
                                       int tile_h, void* stream) {
  const int pix = tile_w * tile_h;
  const int threads = (pix + 31) / 32 * 32;
  composite_backward_kernel<<<n_tiles, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      inst, tile_start, reinterpret_cast<const float4*>(cot), grads, tiles_x,
      tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}
