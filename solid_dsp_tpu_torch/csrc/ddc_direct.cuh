// The DDC bodies' direct-form dot, shared by the unrotated body's direct
// route (ddc_body.cu: K2/K3 at large decimations) and the fused DDC + FM
// kernel's (ddc_fm.cu: K1 at large decimations), so the two routes run one
// piece of arithmetic.
//
// One warp computes one output's sum over its n-sample window,
//
//   z = sum_i h[i] * x[s0 + i],
//
// lane l summing taps l, l + 32, ... in FP32 FMA, in tap order (round:
// every sample and tap rounded to bf16 first, to nearest even, the TPU
// kernels' mode="fast": products exact, f32 sums), the 32 partial sums then
// added by a butterfly of shuffles, so every lane holds the sum.  A warp's
// lanes read consecutive samples straight from device memory (the carried
// tail before the block, zeros before the tail and past the block): float32
// planes, or the interleaved int16 of a ci16 block as one 4-byte word a
// sample, converted in registers (ddc_tc.cuh's ci16_half: the planes'
// values bit for bit); the windows of neighbouring outputs overlap by
// n - M samples, which come from L1 and L2.  Needs no shared memory, so it
// takes every (n, M).

#pragma once

#include "ddc_tc.cuh"

namespace {

// Sample s of both planes of the block x (L samples) and its carried tail
// (2, D): planar float32 (2, L), or interleaved int16 (L, 2) words.
__device__ __forceinline__ float2 window_pair(const float* __restrict__ x,
                                              const float* __restrict__ tail,
                                              long long s, long long L, int D) {
  return make_float2(span_value(x, tail, s, L, D),
                     span_value(x + L, tail + D, s, L, D));
}
__device__ __forceinline__ float2 window_pair(const unsigned* __restrict__ x,
                                              const float* __restrict__ tail,
                                              long long s, long long L, int D) {
  return make_float2(span_value_i16<0>(x, tail, s, L, D),
                     span_value_i16<1>(x, tail + D, s, L, D));
}

// (zr, zi) of the window from sample s0 of the block x (float32 planes or
// int16 words) and the carried tail (2, D); taps (2, n) [re row; im row].
// Every lane of the warp calls it and gets the sum.
template <class X>
__device__ __forceinline__ void warp_dot(const X* __restrict__ x,
                                         const float* __restrict__ tail,
                                         const float* __restrict__ taps,
                                         long long L, int D, int n,
                                         long long s0, int lane, bool round,
                                         float& zr, float& zi) {
  zr = 0.f;
  zi = 0.f;
#pragma unroll 4
  for (int i = lane; i < n; i += 32) {
    const float2 v = window_pair(x, tail, s0 + i, L, D);
    float a = v.x, b = v.y;
    float hr = __ldg(taps + i), hi = __ldg(taps + n + i);
    if (round) {
      a = bf16_round(a);
      b = bf16_round(b);
      hr = bf16_round(hr);
      hi = bf16_round(hi);
    }
    zr = fmaf(hr, a, zr);
    zr = fmaf(-hi, b, zr);
    zi = fmaf(hr, b, zi);
    zi = fmaf(hi, a, zi);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    zr += __shfl_xor_sync(0xffffffffu, zr, off);
    zi += __shfl_xor_sync(0xffffffffu, zi, off);
  }
}

}  // namespace
