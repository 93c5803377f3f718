// The exact front-to-back walk of a tile, shared by composite_forward.cu,
// composite_backward.cu and the probe kernels of composite_probes.cu.
//
// The backward replays the forward's skip and termination decisions, and
// its suffix algebra is exact only if both walks make them bit for bit
// alike. Every value those decisions read comes from the step helpers
// below, and every multiply, add and fused multiply-add in them is an
// explicit round-to-nearest intrinsic, so neither translation unit can
// contract or split it differently from the other; expf is the precise
// libdevice function (no --use_fast_math). All three files are built with
// the same flags. The plain walk (render/tiled.py::_chunk_falloff) rounds
// each product, within the kernels' tolerance of it. The colour sums and
// the backward's gradient terms are explicit intrinsics too, so that a
// walk with the cull (below) and one without compute the same bits.
//
// Each kernel applies the rule in this order:
//   dx = walk_delta(mx, px), dy = walk_delta(my, py)
//   power = walk_power(dx, dy, ca, cb, cc);  power > 0         -> skip
//   alpha = walk_alpha(op, expf(power));     alpha < kAlphaSkip -> skip
//   t_next = walk_t_next(T, alpha);          t_next < kTEps     -> done
// The helpers return values only: an earlier form that returned the whole
// step through reference arguments compiled to a walk that nvcc did not
// unroll, ~18 % slower in the forward and ~16 % in the backward (PERF.md).
//
// Tiles: one block per tile (the main forward and its twin: one per strip
// of a tile, tile_strips). A tile of up to 1024 pixels takes one thread
// per pixel; a larger one, up to kMaxPixelsPerThread * 1024, gives each
// thread PPT pixels, held in register arrays that the unrolled loops index
// with constants. PPT is a template parameter, so the one-pixel kernels
// are the plain one-pixel walk. Slot i < PPT of a thread is the virtual
// thread v = threadIdx.x + i * blockDim.x, and v takes the tile pixel
// tile_pixel(v, ...): warp v / 32 of the virtual threads covers one
// compact block of the tile (the warp map, below).
//
// The cull (the main kernels; kCull): a warp skips, before its walk, every
// staged row that each of its pixels would skip. footprint_box gives each
// row a box about its mean outside of which the exact step skips it for
// certain; lane l of a warp tests row l of a group of 32 against the
// rectangle of the warp's pixels, and __ballot_sync gives the group's
// mask. The walk visits the set bits lowest first, so it takes the same
// rows in the same order as the walk without the cull: T, the colours, the
// suffix, the done flags and the early exit are bitwise the same.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace gsjt {

constexpr int kRowFloats = 16;  // instance row: 64 bytes
constexpr float kAlphaCap = 0.99f;
constexpr float kAlphaSkip = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPixelsPerThread = 4;  // tiles up to 4096 pixels (64x64)
constexpr int kChunk = 128;             // the TPU kernels' instance chunk
constexpr unsigned kFull = 0xffffffffu;
// The main kernels' warp map: a warp covers kWarpW x (32 / kWarpW) pixels
// (render/tiled.py::WARP_W; chip_smoke.py counts the shapes).
constexpr int kWarpW = 8;

__device__ __forceinline__ float walk_delta(float mean, float pixel) {
  return __fsub_rn(mean, pixel);
}

// power = -0.5 * (ca dx dx + cc dy dy) - cb dx dy
__device__ __forceinline__ float walk_power(float dx, float dy, float ca,
                                            float cb, float cc) {
  const float quad = __fmaf_rn(__fmul_rn(ca, dx), dx,
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fmaf_rn(-__fmul_rn(cb, dx), dy, __fmul_rn(-0.5f, quad));
}

// The capped alpha of opacity op at falloff g = expf(power).
__device__ __forceinline__ float walk_alpha(float op, float g) {
  return fminf(kAlphaCap, __fmul_rn(op, g));
}

// Transmittance after an instance of this alpha.
__device__ __forceinline__ float walk_t_next(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// --- the warp map ----------------------------------------------------------

// The main forward's strips: a block of at least kMinStripPixels pixels
// per strip, up to kMaxStrips strips a tile (composite_forward.cu).
constexpr int kMaxStrips = 4;
constexpr int kMinStripPixels = 256;

// The warp map of the main kernels and their twins: kWarpW when kWarpW x
// (32 / kWarpW) blocks tile a tile_w x tile_h tile exactly, else 0, the
// row-major map p = v (a warp is 32 consecutive pixels: the probes' map).
inline int warp_map(int tile_w, int tile_h) {
  return tile_w % kWarpW == 0 && tile_h % (32 / kWarpW) == 0 ? kWarpW : 0;
}

// The tile pixel (row-major index) of virtual thread v under warp map
// warp_w: warp b = v / 32 takes block b of the tile's warp_w x (32 /
// warp_w) blocks in row-major order, lane l its pixel (l % warp_w, l /
// warp_w). One-to-one from [0, tile_w * tile_h) onto the tile.
__device__ __forceinline__ int tile_pixel(int v, int tile_w, int warp_w) {
  if (warp_w == 0) return v;
  const int b = v >> 5;
  const int l = v & 31;
  const int blocks_x = tile_w / warp_w;
  const int x = (b % blocks_x) * warp_w + l % warp_w;
  const int y = (b / blocks_x) * (32 / warp_w) + l / warp_w;
  return y * tile_w + x;
}

// The strips the main forward cuts a tile into, one block each: the most
// (up to kMaxStrips, halving) whose rows hold whole warp blocks of the map
// and at least kMinStripPixels pixels.
inline int tile_strips(int tile_w, int tile_h, int warp_w) {
  const int warp_h = warp_w > 0 ? 32 / warp_w : 1;
  for (int strips = kMaxStrips; strips > 1; strips /= 2) {
    if (tile_h % (strips * warp_h) == 0 &&
        tile_w * tile_h / strips >= kMinStripPixels) {
      return strips;
    }
  }
  return 1;
}

// --- the cull --------------------------------------------------------------

// Bounds within which the walk's own arithmetic cannot overflow (pixel
// coordinates below 2^24): a row outside them is never culled.
constexpr float kBoxCoordMax = 16777216.0f;       // 2^24
constexpr float kBoxConicMax = 1099511627776.0f;  // 2^40
constexpr float kBoxConicMin = 1.0f / kBoxConicMax;
// The margin: the quadratic form is shrunk by kBoxShrink of its diagonal
// (the walk's rounding of power, dx and dy included, is below 24 ulps of
// the diagonal's terms, 1.4e-6 of them), the radius grows by kBoxEta of
// itself plus kBoxEta (expf's and logf's errors are ~1e-6), the
// half-widths by 2^-9 of themselves (the box's own f32 rounding, ~2^-12 at
// the det limit) plus kBoxEta.
constexpr float kBoxShrink = 1.0f / 65536.0f;
constexpr float kBoxEta = 1.0f / 1024.0f;
constexpr float kBoxGrow = 1.0f + 1.0f / 512.0f;
constexpr float kBoxDetMin = 1.0f / 1024.0f;  // of ca * cc

// The footprint box of a staged row (mx, my, ca, cb, cc, op): half-widths
// (hx, hy) such that the exact step skips the row at every pixel (px, py)
// with |mx - px| > hx or |my - py| > hy. The step takes a pair only if
// op expf(power) >= kAlphaSkip, i.e. only if Q = ca dx^2 + 2 cb dx dy +
// cc dy^2 <= r = 2 ln(op / kAlphaSkip); the ellipse Q <= r lies inside
// |dx| <= sqrt(r cc / det), |dy| <= sqrt(r ca / det), det = ca cc - cb^2.
// The box inflates that ellipse (kBoxShrink, kBoxEta, kBoxGrow) to cover
// the walk's f32 rounding, so it never excludes a pair the walk takes.
//   (-inf, -inf): the row is skipped everywhere (op so small that the
//                 radius is negative, or op <= 0: dead slots);
//   (+inf, +inf): never culled (the bounds above, ca or cc outside
//                 [2^-40, 2^40], det <= kBoxDetMin * ca * cc, NaN).
// A NaN anywhere fails every test, which keeps the row.
__device__ __forceinline__ float2 footprint_box(float mx, float my, float ca,
                                                float cb, float cc,
                                                float op) {
  const float2 keep = make_float2(INFINITY, INFINITY);
  if (!(fabsf(mx) <= kBoxCoordMax && fabsf(my) <= kBoxCoordMax &&
        fabsf(ca) <= kBoxConicMax && fabsf(cb) <= kBoxConicMax &&
        fabsf(cc) <= kBoxConicMax && fabsf(op) <= kBoxConicMax)) {
    return keep;
  }
  if (op <= 0.0f) return make_float2(-INFINITY, -INFINITY);
  const float r = 2.0f * logf(op / kAlphaSkip);
  const float rs = r + fabsf(r) * kBoxEta + kBoxEta;
  if (rs < 0.0f) return make_float2(-INFINITY, -INFINITY);
  if (!(ca >= kBoxConicMin && cc >= kBoxConicMin)) return keep;
  const float a = ca * (1.0f - kBoxShrink);
  const float c = cc * (1.0f - kBoxShrink);
  const float det = fmaf(a, c, -(cb * cb));
  if (!(det > kBoxDetMin * (ca * cc))) return keep;
  return make_float2(sqrtf(rs * c / det) * kBoxGrow + kBoxEta,
                     sqrtf(rs * a / det) * kBoxGrow + kBoxEta);
}

// Whether a row's box meets the pixel rectangle [x0, x1] x [y0, y1]
// (rect = (x0, x1, y0, y1)): false only if every pixel of it lies outside
// the box. Written as !(outside), so a NaN keeps the row.
__device__ __forceinline__ bool box_meets(float mx, float my, float2 h,
                                          float4 rect) {
  const bool outside = __fsub_rn(rect.x, mx) > h.x ||
                       __fsub_rn(mx, rect.y) > h.x ||
                       __fsub_rn(rect.z, my) > h.y ||
                       __fsub_rn(my, rect.w) > h.y;
  return !outside;
}

// The rectangle of the pixels (x, y) of this warp's lanes that hold one
// (`valid`), the same in every lane; every lane must call it. A warp with
// no such pixel gets an empty rectangle (x0 > x1).
__device__ __forceinline__ float4 warp_rect(int x, int y, bool valid) {
  const int x0 = __reduce_min_sync(kFull, valid ? x : INT_MAX);
  const int x1 = __reduce_max_sync(kFull, valid ? x : INT_MIN);
  const int y0 = __reduce_min_sync(kFull, valid ? y : INT_MAX);
  const int y1 = __reduce_max_sync(kFull, valid ? y : INT_MIN);
  return make_float4(static_cast<float>(x0), static_cast<float>(x1),
                     static_cast<float>(y0), static_cast<float>(y1));
}

// Pixels per thread for a tile of `pix` pixels; 0 if the tile is too large.
inline int pixels_per_thread(int pix) {
  const int ppt = (pix + kMaxThreads - 1) / kMaxThreads;
  return ppt <= kMaxPixelsPerThread ? ppt : 0;
}

// Threads per block: the tile's pixels over `ppt`, in whole warps.
inline int block_threads(int pix, int ppt) {
  return ((pix + ppt - 1) / ppt + 31) / 32 * 32;
}

// Pixels per thread of the main backward (and its twin and bwd_noshfl),
// whatever the tile's size: a warp's pixels lie in four warp blocks spread
// over the tile (slot i takes virtual warp warp + i * n_warps: at 32x32,
// blocks a quarter tile apart), which evens the warps' work at each
// batch's barrier and cuts the butterflies (one per row and warp, whatever
// its pixels per thread). At 32x32 tiles on an H100 the backward took
// 1.98, 1.70 and 1.52 ms at one, two and four pixels per thread (PERF.md).
constexpr int kBackwardPpt = kMaxPixelsPerThread;

// Threads per block of the main backward for a tile of `pix` pixels; 0 if
// the tile is too large.
inline int backward_threads(int pix) {
  return pixels_per_thread(pix) == 0 ? 0 : block_threads(pix, kBackwardPpt);
}

// Calls launch(std::integral_constant<int, PPT>()) for PPT = ppt and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a ppt outside
// 1..kMaxPixelsPerThread (a tile above 4096 pixels).
template <class F>
inline int launch_with_ppt(int ppt, F&& launch) {
  switch (ppt) {
    case 1: launch(std::integral_constant<int, 1>()); break;
    case 2: launch(std::integral_constant<int, 2>()); break;
    case 3: launch(std::integral_constant<int, 3>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of forward_tile: 36 bytes a staged row, 44 with
// the cull's boxes.
inline size_t forward_smem(int threads, bool cull) {
  return static_cast<size_t>(threads) *
         (2 * sizeof(float4) + sizeof(float) + (cull ? sizeof(float2) : 0));
}

// The sum of v over the block, the same in every thread: an xor butterfly
// in each warp, then the warps' sums in warp order (fixed: reproducible).
// Every thread of the block must call it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float s_warp[kMaxThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  __syncthreads();  // an earlier call's readers are done with s_warp
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += s_warp[w];
  return total;
}

// Keeps v live for the compiler: stores it only for a nonzero run-time
// `keep`, which the probes' wrappers never pass. An ablation whose output
// reads one sum folds every dropped result into v, so nvcc cannot delete
// the work the ablation stands for.
__device__ __forceinline__ void keep_live(float v, float keep, float* sink) {
  if (keep != 0.0f) *sink = v;
}

// What forward_tile computes and writes.
enum ForwardMode : int {
  kForward = 0,  // the exact forward: color (T, PIX, 3) and T (T, PIX)
  kOutShip,      // the exact forward as rows [r, g, b, T, 0, 0, 0, 0] of a
                 //   (T, 8, PIX) block
  kOutNotrans,   // a (T, 8, PIX) block of zeros, [t, 0, 0] =
                 //   sum_pix (r + g + b) + sum_pix T
  kReplay,       // out[t] = the exact forward's red at pixel 0
  kNoCond,       // out[t] = red at pixel 0 of the walk with no stop: every
                 //   pixel visits the whole range, its done flag masks
  kNoDep,        // out[t] = sum over the 128-instance chunks j of the range
                 //   of red_j + 1e-20 T_j at pixel 0, each chunk's in-range
                 //   instances walked from T = 1, done = 0
};

// The forward walk of one strip of a tile over the tile's range of the
// depth-sorted instance rows inst (P, 16). Block b takes strip b % strips
// (tile_h / strips rows of the tile) of tile b / strips; the probes take
// whole tiles (strips = 1). The block stages the range through shared
// memory (dynamic, forward_smem bytes) in batches of blockDim.x rows,
// three loads per row, one row per thread; then every thread walks the
// batch for each of its pixels. The block leaves once every pixel is done
// (__syncthreads_count), except in the modes without stops. Pixels by the
// warp map warp_w (0: row-major). With kCull (kForward only) the staging
// thread also stores its row's footprint box, and each warp walks, in
// every group of 32 rows, only the rows its ballot keeps.
template <int PPT, int kMode, bool kCull = false>
__device__ __forceinline__ void forward_tile(
    const float* __restrict__ inst, const int* __restrict__ tile_start,
    float* __restrict__ out, float* __restrict__ out_t, int tiles_x,
    int tile_w, int tile_h, int warp_w, int strips, float keep) {
  constexpr bool kStops = kMode != kNoCond && kMode != kNoDep;
  static_assert(!kCull || kMode == kForward, "the cull serves the forward");
  extern __shared__ float4 smem[];
  __shared__ float4 s_rect[kCull ? kMaxThreads / 32 * PPT : 1];
  const int batch = blockDim.x;
  float4* s_geo = smem;          // (mx, my, ca, cb)
  float4* s_col = smem + batch;  // (cc, r, g, b)
  float* s_op = reinterpret_cast<float*>(smem + 2 * batch);
  float2* s_box = reinterpret_cast<float2*>(s_op + batch);  // kCull

  const int tile = blockIdx.x / strips;
  const int strip = blockIdx.x % strips;
  const int strip_h = tile_h / strips;
  const int pix = tile_w * strip_h;  // the strip's pixels
  const int i0 = tile_start[tile];
  const int i1 = tile_start[tile + 1];
  const int x_base = (tile % tiles_x) * tile_w;
  const int y_base = (tile / tiles_x) * tile_h + strip * strip_h;
  const int lane = threadIdx.x & 31;

  float px[PPT], py[PPT], T[PPT], cr[PPT], cg[PPT], cbl[PPT], acc[PPT];
  bool done[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int v = threadIdx.x + i * batch;
    const int p = tile_pixel(v, tile_w, warp_w);
    const int x = x_base + p % tile_w;
    const int y = y_base + p / tile_w;
    px[i] = static_cast<float>(x);
    py[i] = static_cast<float>(y);
    T[i] = 1.0f;
    cr[i] = cg[i] = cbl[i] = acc[i] = 0.0f;
    done[i] = v >= pix;
    if constexpr (kCull) {
      const float4 rect = warp_rect(x, y, v < pix);
      if (lane == 0) s_rect[v >> 5] = rect;
    }
  }
  float fold = 0.0f;  // the probes' dropped results (keep_live)

  for (int base = i0; base < i1; base += batch) {
    // Also the barrier that keeps the previous batch's rows until every
    // thread has read them (and, the first time, publishes s_rect).
    if constexpr (kStops) {
      bool all_done = done[0];
#pragma unroll
      for (int i = 1; i < PPT; ++i) all_done = all_done && done[i];
      if (__syncthreads_count(all_done) == batch) break;
    } else {
      __syncthreads();
    }
    const int n = min(batch, i1 - base);
    if (threadIdx.x < n) {
      const float4* row = reinterpret_cast<const float4*>(
          inst + static_cast<size_t>(base + threadIdx.x) * kRowFloats);
      const float4 g = row[0];
      const float4 c = row[1];
      const float op = row[2].x;
      s_geo[threadIdx.x] = g;
      s_col[threadIdx.x] = c;
      s_op[threadIdx.x] = op;
      if constexpr (kCull) {
        s_box[threadIdx.x] = footprint_box(g.x, g.y, g.z, g.w, c.x, op);
      }
    }
    __syncthreads();
    if constexpr (kCull) {
      for (int g0 = 0; g0 < n; g0 += 32) {
        // Lane l tests row g0 + l; a row past the batch meets nothing.
        const int k = g0 + lane;
        const float2 h = k < n ? s_box[k] : make_float2(-INFINITY, -INFINITY);
        const float mx = k < n ? s_geo[k].x : 0.0f;
        const float my = k < n ? s_geo[k].y : 0.0f;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          // Bit l: row g0 + l meets the warp's pixels (lane l tests it
          // whatever its own pixel's state); none once all are done.
          const float4 rect = s_rect[(threadIdx.x >> 5) + i * (batch >> 5)];
          const unsigned m = __any_sync(kFull, !done[i])
                                 ? __ballot_sync(kFull, box_meets(mx, my, h, rect))
                                 : 0u;
          if (done[i]) continue;
          for (unsigned bits = m; bits != 0; bits &= bits - 1) {
            const int kk = g0 + __ffs(bits) - 1;
            const float4 g = s_geo[kk];
            const float4 c = s_col[kk];
            const float power = walk_power(walk_delta(g.x, px[i]),
                                           walk_delta(g.y, py[i]), g.z, g.w,
                                           c.x);
            if (power > 0.0f) continue;
            const float alpha = walk_alpha(s_op[kk], expf(power));
            if (alpha < kAlphaSkip) continue;
            const float t_next = walk_t_next(T[i], alpha);
            if (t_next < kTEps) {
              done[i] = true;
              break;
            }
            const float w = __fmul_rn(alpha, T[i]);
            cr[i] = __fmaf_rn(c.y, w, cr[i]);
            cg[i] = __fmaf_rn(c.z, w, cg[i]);
            cbl[i] = __fmaf_rn(c.w, w, cbl[i]);
            T[i] = t_next;
          }
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if constexpr (kStops) {
        if (done[i]) continue;
        for (int k = 0; k < n; ++k) {
          const float4 g = s_geo[k];
          const float4 c = s_col[k];
          const float power = walk_power(walk_delta(g.x, px[i]),
                                         walk_delta(g.y, py[i]), g.z, g.w,
                                         c.x);
          if (power > 0.0f) continue;
          const float alpha = walk_alpha(s_op[k], expf(power));
          if (alpha < kAlphaSkip) continue;
          const float t_next = walk_t_next(T[i], alpha);
          if (t_next < kTEps) {
            done[i] = true;
            break;
          }
          const float w = __fmul_rn(alpha, T[i]);
          cr[i] = __fmaf_rn(c.y, w, cr[i]);
          cg[i] = __fmaf_rn(c.z, w, cg[i]);
          cbl[i] = __fmaf_rn(c.w, w, cbl[i]);
          T[i] = t_next;
        }
      } else {
        for (int k = 0; k < n; ++k) {
          if constexpr (kMode == kNoDep) {
            const int idx = base + k;
            if (idx % kChunk == 0 && idx != i0) {  // chunk j ends: restart
              acc[i] += cr[i] + 1e-20f * T[i];
              fold += cg[i] + cbl[i];
              T[i] = 1.0f;
              cr[i] = cg[i] = cbl[i] = 0.0f;
              done[i] = threadIdx.x + i * batch >= pix;
            }
            if (done[i]) continue;
          }
          const float4 g = s_geo[k];
          const float4 c = s_col[k];
          const float power = walk_power(walk_delta(g.x, px[i]),
                                         walk_delta(g.y, py[i]), g.z, g.w,
                                         c.x);
          if (power > 0.0f) continue;
          const float alpha = walk_alpha(s_op[k], expf(power));
          if constexpr (kMode == kNoCond) {
            fold += alpha;  // a done pixel's step is work, not skipped
            if (done[i]) continue;
          }
          if (alpha < kAlphaSkip) continue;
          const float t_next = walk_t_next(T[i], alpha);
          if (t_next < kTEps) {
            done[i] = true;
            continue;
          }
          const float w = __fmul_rn(alpha, T[i]);
          cr[i] = __fmaf_rn(c.y, w, cr[i]);
          cg[i] = __fmaf_rn(c.z, w, cg[i]);
          cbl[i] = __fmaf_rn(c.w, w, cbl[i]);
          T[i] = t_next;
        }
      }
    }
  }

  // The strip's first pixel in the (T, PIX) outputs.
  const size_t tile_pix = static_cast<size_t>(tile) * tile_w * tile_h +
                          static_cast<size_t>(strip) * pix;
  if constexpr (kMode == kForward) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int v = threadIdx.x + i * batch;
      if (v < pix) {
        const size_t o = tile_pix + tile_pixel(v, tile_w, warp_w);
        out[3 * o + 0] = cr[i];
        out[3 * o + 1] = cg[i];
        out[3 * o + 2] = cbl[i];
        out_t[o] = T[i];
      }
    }
  } else if constexpr (kMode == kOutShip || kMode == kOutNotrans) {
    float total = 0.0f;
    if constexpr (kMode == kOutNotrans) {
      float s_color = 0.0f, s_t = 0.0f;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (threadIdx.x + i * batch < pix) {
          s_color += cr[i] + cg[i] + cbl[i];
          s_t += T[i];
        }
      }
      s_color = block_sum(s_color);
      total = s_color + block_sum(s_t);
    }
    float* block = out + 8 * tile_pix;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int v = threadIdx.x + i * batch;
      const int p = tile_pixel(v, tile_w, warp_w);
      if (v < pix) {
        float rows[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (kMode == kOutShip) {
          rows[0] = cr[i];
          rows[1] = cg[i];
          rows[2] = cbl[i];
          rows[3] = T[i];
        } else if (p == 0) {
          rows[0] = total;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) block[r * pix + p] = rows[r];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if constexpr (kMode == kNoDep) {
        if (i1 > i0) acc[i] += cr[i] + 1e-20f * T[i];  // the last chunk
        fold += cg[i] + cbl[i];
      }
      fold += cr[i] + cg[i] + cbl[i] + T[i] + acc[i];
    }
    if (threadIdx.x == 0) out[tile] = kMode == kNoDep ? acc[0] : cr[0];
    keep_live(fold, keep, out + tile);
  }
}

constexpr int kBatch = 32;     // backward: instances staged per batch
constexpr int kMaxWarps = 32;  // 1024 threads
constexpr int kGrads = 9;      // dmx, dmy, dca, dcb, dcc, dr, dg, db, dop

// Dynamic shared memory of backward_tile: the partials of the block's
// warps.
inline size_t backward_smem(int threads) {
  return static_cast<size_t>(threads / 32) * kBatch * kGrads * sizeof(float);
}

// What backward_tile computes and writes.
enum BackwardMode : int {
  kBackward = 0,  // each reached instance's 64-byte row of `grads`, whole
  kBwdNoWrite,    // nothing written but one float per tile, out[t] = the
                  //   sum of the dmx gradients of the tile's instances at
                  //   128-aligned stream positions; every other sum kept
                  //   live
  kBwdNoShfl,     // kBackward without the warp butterflies: each warp's
                  //   partial is its lane 0's own terms (the other lanes'
                  //   terms are kept live), so `grads` holds the gradients
                  //   of the pixels at lane 0 of their warps
};

// The backward replay of tile blockIdx.x: per-instance gradients by the
// suffix algebra, pixels by the warp map warp_w (0: row-major). The block
// stages kBatch rows at a time; for each row a warp walks, its pixels'
// terms are summed over the thread's pixels, then over the warp by an xor
// butterfly, and lane 0 stores the warp's partial; after the batch the
// partials are summed in warp order and each row is written whole.
// Without kCull every warp walks every row and stores a partial (zeros
// where none of its pixels contributed). With kCull each warp walks only
// the rows its ballot keeps, stores a partial only where a pixel
// contributed and marks it in s_rows[k], and the after-batch pass sums
// only the marked partials: the same nonzero terms in the same order, so
// the same gradients (a sum of the parent's zeros is +0 in both).
template <int PPT, int kMode, bool kCull = false>
__device__ __forceinline__ void backward_tile(
    const float* __restrict__ inst, const int* __restrict__ tile_start,
    const float4* __restrict__ cot, float* __restrict__ grads, int tiles_x,
    int tile_w, int tile_h, int warp_w, float keep) {
  constexpr bool kWrite = kMode != kBwdNoWrite;
  __shared__ float4 s_geo[kBatch];  // (mx, my, ca, cb)
  __shared__ float4 s_col[kBatch];  // (cc, r, g, b)
  __shared__ float s_op[kBatch];
  __shared__ float2 s_box[kCull ? kBatch : 1];
  __shared__ unsigned s_rows[kCull ? kBatch : 1];  // bit w: warp w's partial
  __shared__ float4 s_rect[kCull ? kMaxWarps * PPT : 1];
  // The warps' partials, [n_warps][kBatch][kGrads]: dynamic shared memory
  // (backward_smem), so a block of few warps holds only its own.
  extern __shared__ float s_dyn[];
  auto s_part = reinterpret_cast<float (*)[kBatch][kGrads]>(s_dyn);

  const int tile = blockIdx.x;
  const int pix = tile_w * tile_h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int i0 = tile_start[tile];
  const int i1 = tile_start[tile + 1];
  const int x_base = (tile % tiles_x) * tile_w;
  const int y_base = (tile / tiles_x) * tile_h;

  float px[PPT], py[PPT], T[PPT], suffix[PPT];
  float4 ct[PPT];  // [dC_r, dC_g, dC_b, A'_0] for each pixel
  bool done[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    const bool inside = v < pix;
    const int p = tile_pixel(v, tile_w, warp_w);
    const int x = x_base + p % tile_w;
    const int y = y_base + p / tile_w;
    px[i] = static_cast<float>(x);
    py[i] = static_cast<float>(y);
    ct[i] = inside ? cot[static_cast<size_t>(tile) * pix + p]
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    T[i] = 1.0f;
    suffix[i] = ct[i].w;
    done[i] = !inside;
    if constexpr (kCull) {
      const float4 rect = warp_rect(x, y, inside);
      if (lane == 0) s_rect[warp + i * n_warps] = rect;
    }
  }
  float probe = 0.0f, fold = 0.0f;  // kBwdNoWrite, kBwdNoShfl

  // The terms of row k at the thread's pixels (slots whose bit of `slots`
  // is set), summed in slot order into v; returns whether one was live.
  auto row_terms = [&](int k, unsigned slots, float* v) {
    bool any_live = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      float t[kGrads];
#pragma unroll
      for (int j = 0; j < kGrads; ++j) t[j] = 0.0f;
      bool live = false;
      if (!done[i] && (slots >> i & 1u)) {
        const float4 g = s_geo[k];
        const float4 c = s_col[k];
        const float op = s_op[k];
        const float dx = walk_delta(g.x, px[i]);
        const float dy = walk_delta(g.y, py[i]);
        const float power = walk_power(dx, dy, g.z, g.w, c.x);
        const float falloff = power > 0.0f ? 0.0f : expf(power);
        const float alpha = walk_alpha(op, falloff);
        const float t_next = walk_t_next(T[i], alpha);
        if (power > 0.0f || alpha < kAlphaSkip) {
          // skipped: adds nothing
        } else if (t_next < kTEps) {
          done[i] = true;
        } else {
          // The suffix algebra (composite_backward.cu).
          live = true;
          const float4 d = ct[i];
          const float w = __fmul_rn(alpha, T[i]);
          const float s = __fmaf_rn(d.z, c.w,
                                    __fmaf_rn(d.y, c.z, __fmul_rn(d.x, c.y)));
          suffix[i] = __fmaf_rn(-w, s, suffix[i]);
          const float d_alpha = __fmaf_rn(
              s, T[i], -__fdiv_rn(suffix[i], __fsub_rn(1.0f, alpha)));
          const float q = __fmul_rn(falloff, d_alpha);
          const float d_power = __fmul_rn(op, q);
          t[0] = __fmul_rn(-d_power, __fmaf_rn(g.z, dx, __fmul_rn(g.w, dy)));
          t[1] = __fmul_rn(-d_power, __fmaf_rn(c.x, dy, __fmul_rn(g.w, dx)));
          t[2] = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, d_power), dx), dx);
          t[3] = __fmul_rn(__fmul_rn(-d_power, dx), dy);
          t[4] = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, d_power), dy), dy);
          t[5] = __fmul_rn(w, d.x);
          t[6] = __fmul_rn(w, d.y);
          t[7] = __fmul_rn(w, d.z);
          t[8] = q;
          T[i] = t_next;
        }
      }
      // A thread's pixels in order i = 0, 1, ...: a fixed order.
#pragma unroll
      for (int j = 0; j < kGrads; ++j) {
        v[j] = i == 0 ? t[j] : __fadd_rn(v[j], t[j]);
      }
      any_live = any_live || live;
    }
    return any_live;
  };
  auto butterfly = [&](float* v) {
    if constexpr (kMode == kBwdNoShfl) {
#pragma unroll
      for (int j = 0; j < kGrads; ++j) fold += v[j];
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kGrads; ++j) {
          v[j] = __fadd_rn(v[j], __shfl_xor_sync(kFull, v[j], off));
        }
      }
    }
  };

  for (int base = i0; base < i1; base += kBatch) {
    bool all_done = done[0];
#pragma unroll
    for (int i = 1; i < PPT; ++i) all_done = all_done && done[i];
    // Also the barrier that keeps the previous batch's rows and partials
    // until every thread has read them (and, the first time, publishes
    // s_rect).
    if (__syncthreads_count(all_done) == static_cast<int>(blockDim.x)) break;
    const int n = min(kBatch, i1 - base);
    if (threadIdx.x < n) {
      const float4* row = reinterpret_cast<const float4*>(
          inst + static_cast<size_t>(base + threadIdx.x) * kRowFloats);
      const float4 g = row[0];
      const float4 c = row[1];
      const float op = row[2].x;
      s_geo[threadIdx.x] = g;
      s_col[threadIdx.x] = c;
      s_op[threadIdx.x] = op;
      if constexpr (kCull) {
        s_box[threadIdx.x] = footprint_box(g.x, g.y, g.z, g.w, c.x, op);
      }
    }
    if constexpr (kCull) {
      if (threadIdx.x < kBatch) s_rows[threadIdx.x] = 0u;
    }
    __syncthreads();

    if constexpr (kCull) {
      // Lane l tests row l against each of the warp's rectangles (whatever
      // its own pixels' state); a slot whose pixels are all done takes none.
      const float2 h =
          lane < n ? s_box[lane] : make_float2(-INFINITY, -INFINITY);
      const float mx = lane < n ? s_geo[lane].x : 0.0f;
      const float my = lane < n ? s_geo[lane].y : 0.0f;
      unsigned m[PPT];
      unsigned m_any = 0u;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float4 rect = s_rect[warp + i * n_warps];
        m[i] = __any_sync(kFull, !done[i])
                   ? __ballot_sync(kFull, box_meets(mx, my, h, rect))
                   : 0u;
        m_any |= m[i];
      }
      for (unsigned bits = m_any; bits != 0; bits &= bits - 1) {
        const int k = __ffs(bits) - 1;
        unsigned slots = 0u;
#pragma unroll
        for (int i = 0; i < PPT; ++i) slots |= (m[i] >> k & 1u) << i;
        float v[kGrads];
        if (__any_sync(kFull, row_terms(k, slots, v))) {
          butterfly(v);
          if (lane == 0) {
#pragma unroll
            for (int j = 0; j < kGrads; ++j) s_part[warp][k][j] = v[j];
            atomicOr(&s_rows[k], 1u << warp);
          }
        }
      }
    } else if (__all_sync(kFull, all_done)) {
      float* part = &s_part[warp][0][0];
      for (int e = lane; e < n * kGrads; e += 32) part[e] = 0.0f;
    } else {
#pragma unroll 2
      for (int k = 0; k < n; ++k) {
        float v[kGrads];
        if (__any_sync(kFull, row_terms(k, ~0u, v))) butterfly(v);
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < kGrads; ++j) s_part[warp][k][j] = v[j];
        }
      }
    }
    __syncthreads();

    // One thread per output element: the warps' partials in warp order,
    // then the row written whole (columns past the nine are zero).
    for (int e = threadIdx.x; e < n * kRowFloats; e += blockDim.x) {
      const int k = e / kRowFloats;
      const int j = e % kRowFloats;
      float sum = 0.0f;
      if (j < kGrads) {
        if constexpr (kCull) {
          for (unsigned w = s_rows[k]; w != 0; w &= w - 1) {
            sum = __fadd_rn(sum, s_part[__ffs(w) - 1][k][j]);
          }
        } else {
          for (int w = 0; w < n_warps; ++w) sum = __fadd_rn(sum, s_part[w][k][j]);
        }
      }
      if constexpr (kWrite) {
        grads[static_cast<size_t>(base) * kRowFloats + e] = sum;
      } else if (j == 0 && (base + k) % kChunk == 0) {
        probe += sum;
      } else {
        fold += sum;
      }
    }
  }
  if constexpr (kMode == kBwdNoWrite) {
    probe = block_sum(probe);
    if (threadIdx.x == 0) grads[tile] = probe;
    keep_live(fold, keep, grads + tile);
  } else if constexpr (kMode == kBwdNoShfl) {
    keep_live(fold, keep, grads);
  }
}

}  // namespace gsjt
