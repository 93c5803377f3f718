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
// each product, within the kernels' tolerance of it.
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
// Tiles: one block per tile. A tile of up to 1024 pixels takes one thread
// per pixel; a larger one, up to kMaxPixelsPerThread * 1024, gives each
// thread PPT pixels, p = threadIdx.x + i * blockDim.x for i < PPT, held in
// register arrays that the unrolled loops index with constants. PPT is a
// template parameter, so the one-pixel kernels are the plain one-pixel
// walk.

#pragma once

#include <cuda_runtime.h>

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

// Pixels per thread for a tile of `pix` pixels; 0 if the tile is too large.
inline int pixels_per_thread(int pix) {
  const int ppt = (pix + kMaxThreads - 1) / kMaxThreads;
  return ppt <= kMaxPixelsPerThread ? ppt : 0;
}

// Threads per block: the tile's pixels over `ppt`, in whole warps.
inline int block_threads(int pix, int ppt) {
  return ((pix + ppt - 1) / ppt + 31) / 32 * 32;
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

// The forward walk of tile blockIdx.x over its range of the depth-sorted
// instance rows inst (P, 16): the block stages the range through shared
// memory (dynamic, blockDim.x * 36 bytes) in batches of blockDim.x rows,
// three loads per row, one row per thread; then every thread walks the
// batch for each of its pixels. The block leaves once every pixel is done
// (__syncthreads_count), except in the modes without stops.
template <int PPT, int kMode>
__device__ __forceinline__ void forward_tile(
    const float* __restrict__ inst, const int* __restrict__ tile_start,
    float* __restrict__ out, float* __restrict__ out_t, int tiles_x,
    int tile_w, int tile_h, float keep) {
  constexpr bool kStops = kMode != kNoCond && kMode != kNoDep;
  extern __shared__ float4 smem[];
  const int batch = blockDim.x;
  float4* s_geo = smem;          // (mx, my, ca, cb)
  float4* s_col = smem + batch;  // (cc, r, g, b)
  float* s_op = reinterpret_cast<float*>(smem + 2 * batch);

  const int tile = blockIdx.x;
  const int pix = tile_w * tile_h;
  const int i0 = tile_start[tile];
  const int i1 = tile_start[tile + 1];

  float px[PPT], py[PPT], T[PPT], cr[PPT], cg[PPT], cbl[PPT], acc[PPT];
  bool done[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * batch;
    px[i] = static_cast<float>((tile % tiles_x) * tile_w + p % tile_w);
    py[i] = static_cast<float>((tile / tiles_x) * tile_h + p / tile_w);
    T[i] = 1.0f;
    cr[i] = cg[i] = cbl[i] = acc[i] = 0.0f;
    done[i] = p >= pix;
  }
  float fold = 0.0f;  // the probes' dropped results (keep_live)

  for (int base = i0; base < i1; base += batch) {
    // Also the barrier that keeps the previous batch's rows until every
    // thread has read them.
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
      s_geo[threadIdx.x] = row[0];
      s_col[threadIdx.x] = row[1];
      s_op[threadIdx.x] = row[2].x;
    }
    __syncthreads();
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
          const float w = alpha * T[i];
          cr[i] += c.y * w;
          cg[i] += c.z * w;
          cbl[i] += c.w * w;
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
          const float w = alpha * T[i];
          cr[i] += c.y * w;
          cg[i] += c.z * w;
          cbl[i] += c.w * w;
          T[i] = t_next;
        }
      }
    }
  }

  const size_t tile_pix = static_cast<size_t>(tile) * pix;
  if constexpr (kMode == kForward) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = threadIdx.x + i * batch;
      if (p < pix) {
        const size_t o = tile_pix + p;
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
      const int p = threadIdx.x + i * batch;
      if (p < pix) {
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

// The backward replay of tile blockIdx.x: per-instance gradients by the
// suffix algebra (composite_backward.cu has the derivation). With kWrite,
// each reached instance's 64-byte row of `grads` is written whole. Without
// it (the bwd_nowrite probe) nothing is written but one float per tile,
// out[t] = the sum of the dmx gradients of the tile's instances at
// 128-aligned stream positions; every other sum is kept live.
template <int PPT, bool kWrite>
__device__ __forceinline__ void backward_tile(
    const float* __restrict__ inst, const int* __restrict__ tile_start,
    const float4* __restrict__ cot, float* __restrict__ grads, int tiles_x,
    int tile_w, int tile_h, float keep) {
  __shared__ float4 s_geo[kBatch];  // (mx, my, ca, cb)
  __shared__ float4 s_col[kBatch];  // (cc, r, g, b)
  __shared__ float s_op[kBatch];
  __shared__ float s_part[kMaxWarps][kBatch][kGrads];

  const int tile = blockIdx.x;
  const int pix = tile_w * tile_h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int i0 = tile_start[tile];
  const int i1 = tile_start[tile + 1];

  float px[PPT], py[PPT], T[PPT], suffix[PPT];
  float4 ct[PPT];  // [dC_r, dC_g, dC_b, A'_0] for each pixel
  bool done[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    const bool inside = p < pix;
    px[i] = static_cast<float>((tile % tiles_x) * tile_w + p % tile_w);
    py[i] = static_cast<float>((tile / tiles_x) * tile_h + p / tile_w);
    ct[i] = inside ? cot[static_cast<size_t>(tile) * pix + p]
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    T[i] = 1.0f;
    suffix[i] = ct[i].w;
    done[i] = !inside;
  }
  float probe = 0.0f, fold = 0.0f;  // without kWrite

  for (int base = i0; base < i1; base += kBatch) {
    bool all_done = done[0];
#pragma unroll
    for (int i = 1; i < PPT; ++i) all_done = all_done && done[i];
    // Also the barrier that keeps the previous batch's rows and partials
    // until every thread has read them.
    if (__syncthreads_count(all_done) == static_cast<int>(blockDim.x)) break;
    const int n = min(kBatch, i1 - base);
    if (threadIdx.x < n) {
      const float4* row = reinterpret_cast<const float4*>(
          inst + static_cast<size_t>(base + threadIdx.x) * kRowFloats);
      s_geo[threadIdx.x] = row[0];
      s_col[threadIdx.x] = row[1];
      s_op[threadIdx.x] = row[2].x;
    }
    __syncthreads();

    if (__all_sync(kFull, all_done)) {
      float* part = &s_part[warp][0][0];
      for (int e = lane; e < n * kGrads; e += 32) part[e] = 0.0f;
    } else {
#pragma unroll 2
      for (int k = 0; k < n; ++k) {
        float v[kGrads];
        bool any_live = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          float t[kGrads];
#pragma unroll
          for (int j = 0; j < kGrads; ++j) t[j] = 0.0f;
          bool live = false;
          if (!done[i]) {
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
              live = true;
              const float4 d = ct[i];
              const float w = alpha * T[i];
              const float s = d.x * c.y + d.y * c.z + d.z * c.w;
              suffix[i] -= w * s;
              const float d_alpha = s * T[i] - suffix[i] / (1.0f - alpha);
              const float q = falloff * d_alpha;
              const float d_power = op * q;
              t[0] = -d_power * (g.z * dx + g.w * dy);
              t[1] = -d_power * (c.x * dy + g.w * dx);
              t[2] = -0.5f * d_power * dx * dx;
              t[3] = -d_power * dx * dy;
              t[4] = -0.5f * d_power * dy * dy;
              t[5] = w * d.x;
              t[6] = w * d.y;
              t[7] = w * d.z;
              t[8] = q;
              T[i] = t_next;
            }
          }
          // A thread's pixels in order i = 0, 1, ...: a fixed order.
#pragma unroll
          for (int j = 0; j < kGrads; ++j) v[j] = i == 0 ? t[j] : v[j] + t[j];
          any_live = any_live || live;
        }
        if (__any_sync(kFull, any_live)) {
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
    for (int e = threadIdx.x; e < n * kRowFloats; e += blockDim.x) {
      const int k = e / kRowFloats;
      const int j = e % kRowFloats;
      float sum = 0.0f;
      if (j < kGrads) {
        for (int w = 0; w < n_warps; ++w) sum += s_part[w][k][j];
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
  if constexpr (!kWrite) {
    probe = block_sum(probe);
    if (threadIdx.x == 0) grads[tile] = probe;
    keep_live(fold, keep, grads + tile);
  }
}

}  // namespace gsjt
