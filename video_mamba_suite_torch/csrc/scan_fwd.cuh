// Forward-only helpers of the selective-scan walks, shared by K1
// (short_bidir_fwd.cu) and K3 (chunked_scan_fwd.cu) on Hopper (sm_90a).
//
// Both walks take one exponential a state update on the special function
// unit (`scan_lanes::exp2_sfu` on A log2(e), scaled once a thread) and
// compute softplus and the gate once a (step, channel), with the same
// unit's exp2 and reciprocal in place of the accurate expf, log1pf and the
// IEEE division: at most a few ulp apart, and a masked step (softplus
// exactly 0) stays an exact identity, since 2^0 is exactly 1.

#pragma once

#include "scan_lanes.cuh"

namespace scan_fwd {

using scan_lanes::exp2_sfu;
using scan_lanes::kLog2e;

// softplus as torch computes it (threshold 20): max(x, 0) + log1p(t) with
// t = e^-|x| in (0, 1], and log1p(t) = 2 atanh(s), s = t / (2 + t) in
// [0, 1/3], by its odd series to s^13 (the rest below 2e-8 of the sum):
// one exp2 and one reciprocal on the special function unit and 9 FMA-pipe
// operations where log1pf took some 25. Exactly 0 where e^x underflows.
__device__ __forceinline__ float softplus(float x) {
  if (x > 20.f) return x;
  const float t = exp2_sfu(-fabsf(x) * kLog2e);
  const float s = __fdividef(t, 2.f + t);
  const float s2 = s * s;
  float r = fmaf(s2, 1.f / 13, 1.f / 11);
  r = fmaf(s2, r, 1.f / 9);
  r = fmaf(s2, r, 1.f / 7);
  r = fmaf(s2, r, 1.f / 5);
  r = fmaf(s2, r, 1.f / 3);
  r = fmaf(s2, r, 1.f);
  return fmaxf(x, 0.f) + 2.f * s * r;
}

// Wait until at most kPending of the block's latest cp.async groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// z sigmoid(z): __fdividef's 2-ulp quotient (0 where 1 + e^-z overflows,
// as the exact silu underflows there).
__device__ __forceinline__ float silu(float z) {
  return __fdividef(z, 1.f + exp2_sfu(-z * kLog2e));
}

}  // namespace scan_fwd
