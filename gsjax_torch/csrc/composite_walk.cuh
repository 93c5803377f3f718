// The arithmetic of one (instance, pixel) step of the exact front-to-back
// walk, shared by composite_forward.cu and composite_backward.cu.
//
// The backward replays the forward's skip and termination decisions, and
// its suffix algebra is exact only if both walks make them bit for bit
// alike. Every value those decisions read comes from the helpers below,
// and every multiply, add and fused multiply-add in them is an explicit
// round-to-nearest intrinsic, so neither translation unit can contract or
// split it differently from the other; expf is the precise libdevice
// function (no --use_fast_math). Both files are built with the same flags.
// The plain walk (render/tiled.py::_chunk_falloff) rounds each product,
// within the kernels' tolerance of it.
//
// Each kernel applies the rule in this order:
//   dx = walk_delta(mx, px), dy = walk_delta(my, py)
//   power = walk_power(dx, dy, ca, cb, cc);  power > 0         -> skip
//   alpha = walk_alpha(op, expf(power));     alpha < kAlphaSkip -> skip
//   t_next = walk_t_next(T, alpha);          t_next < kTEps     -> done
// The helpers return values only: an earlier form that returned the whole
// step through reference arguments compiled to a walk that nvcc did not
// unroll, ~18 % slower in the forward and ~16 % in the backward (PERF.md).

#pragma once

#include <cuda_runtime.h>

namespace gsjt {

constexpr int kRowFloats = 16;  // instance row: 64 bytes
constexpr float kAlphaCap = 0.99f;
constexpr float kAlphaSkip = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

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

}  // namespace gsjt
