// The BP level of a value under a per-tensor scale, and the exact level
// boundaries that let a kernel find it by comparison instead of division.
//
// The level clip(rint(fl(fl(|v| / s) * 10)), 0, 9) never decreases as |v|
// grows, so for each scale there is, for each level t, a least f32 b_t
// whose level is t or more, and a value's level reaches t iff |v| >= b_t.
// level_boundary8 finds b_t on the card by a search on the f32 bit
// pattern of |v| that runs the level's own division; a boundary no f32
// reaches is NaN (no value passes it).
//
// Users: bp_mma.cuh (the plane boundaries of the fused kernels' encode)
// and bp_quantize.cu (the 9 level boundaries of the quantise).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace oisma_levels {

__device__ __forceinline__ float bp_level(float a, float s) {
  return fminf(fmaxf(rintf(a / s * 10.0f), 0.0f), 9.0f);
}

// Least f32 a >= 0 whose level under scale s is t or more (NaN if no f32
// reaches t), found by eight lanes together: one round of eight patterns
// next to the estimate (t - 0.5) / 10 * s, or else rounds in which they
// test eight evenly spaced bit patterns of [lo, hi] and keep the eighth
// before the first that passes (~11 rounds over all 2^31 patterns).  All
// 32 lanes of the warp call it (four searches a warp, lanes 8g..8g+7 for
// one).
static __device__ float level_boundary8(float s, int t) {
  const int lane = threadIdx.x & 31, j = lane & 7, sh = lane & 24;
  uint32_t lo = 0, hi = 0x7f800000u;           // pred(hi) assumed
  // First the eight patterns e-3 .. e+4 around e = (t - 0.5) / 10 * s,
  // within a few ulps of the boundary unless s or the boundary is
  // subnormal or out of range: if the first fails and one passes, the
  // first that passes is the boundary.  Otherwise the search spans every
  // pattern.
  const float e = ((float)t - 0.5f) * 0.1f * s;
  const uint32_t eb = __float_as_uint(e);
  const bool fits = e > 0.0f && eb > 3u && eb < 0x7f800000u - 4u;
  const uint32_t q0 = eb - 3u + (uint32_t)j;
  const bool ok0 = fits && bp_level(__uint_as_float(q0), s) >= (float)t;
  const uint32_t m0 = (__ballot_sync(0xffffffffu, ok0) >> sh) & 0xFFu;
  if (fits && (m0 & 1u) == 0u && m0 != 0u) lo = hi = eb - 3u + (__ffs(m0) - 1);
  while (__any_sync(0xffffffffu, lo < hi)) {
    const uint32_t q =
        lo + (uint32_t)(((unsigned long long)(hi - lo) * j) >> 3);
    const bool ok = lo < hi && bp_level(__uint_as_float(q), s) >= (float)t;
    const uint32_t m = (__ballot_sync(0xffffffffu, ok) >> sh) & 0xFFu;
    if (lo < hi) {
      // first passing point f (8: none, q_8 = hi): the answer lies in
      // (q_{f-1}, q_f], or is lo itself when f = 0
      const int f = m ? __ffs(m) - 1 : 8;
      const unsigned long long span = hi - lo;
      if (f == 0) {
        hi = lo;
      } else {
        hi = f == 8 ? hi : lo + (uint32_t)((span * f) >> 3);
        lo = lo + (uint32_t)((span * (f - 1)) >> 3) + 1;
      }
    }
  }
  const float b = __uint_as_float(hi);
  return bp_level(b, s) >= (float)t ? b : __uint_as_float(0x7fc00000u);
}

}  // namespace oisma_levels
