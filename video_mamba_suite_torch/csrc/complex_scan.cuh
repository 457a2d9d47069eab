// The complex decay of the complex-A selective scan, shared by K7
// (complex_scan_fwd.cu) and K8 (complex_scan_bwd.cu) on Hopper (sm_90a).
//
// A state update multiplies by a = exp(dt (Ar + i Ai)) = mag (cos + i sin),
// mag = exp(dt Ar), angle dt Ai. Per (step, state) that is three results
// of the special function unit, the quantity that bounds both kernels once
// their walks are parallel (16 results a clock an SM, an eighth of the fp32
// rate): the modulus as exp2 of dt Ar log2(e) (`ex2.approx`, Ar scaled
// once a lane), and the rotation as `sin.approx` and `cos.approx` of the
// angle reduced to [-pi, pi] first, since they lose accuracy outside it and
// the angles reach some 10 radians a step. The reduction, r = x - 2 pi
// rint(x / 2 pi) with 2 pi in two parts, costs four FMA-pipe operations
// (rint by adding and taking away 1.5 2^23, where `rintf` would take the
// conversion unit, as slow as the special function unit); without it K7
// and K8 ran a few percent faster on an H100, with about twice the error.
// A step of dt 0
// stays an exact identity: 2^0, cos(0) and sin(0) are exactly 1, 1 and 0.
// The decay of a whole segment or chunk, exp(A sum dt), whose angle runs to
// hundreds of radians, takes the accurate sincosf: once a segment.

#pragma once

#include <cuda_runtime.h>

#include "scan_lanes.cuh"

namespace complex_scan {

using scan_lanes::exp2_sfu;

constexpr float kInv2Pi = 0.15915494309189535f;
constexpr float k2PiHi = 6.2831854820251465f;     // 2 pi rounded to float
constexpr float k2PiLo = -1.7484556025237907e-7f;  // 2 pi - k2PiHi
constexpr float kRound = 12582912.f;               // 1.5 2^23

// sin and cos of x (|x| / 2 pi below 2^22) on the special function unit,
// after reducing x to [-pi, pi].
__device__ __forceinline__ void rotation(float x, float& s, float& c) {
  const float n = fmaf(x, kInv2Pi, kRound) - kRound;   // rint(x / 2 pi)
  const float r = fmaf(-n, k2PiLo, fmaf(-n, k2PiHi, x));
  s = __sinf(r);
  c = __cosf(r);
}

// a = exp(dt (Ar + i Ai)) of one step as (car, cai); ar2 = Ar log2(e).
__device__ __forceinline__ void step_decay(float dt, float ar2, float ai,
                                           float& car, float& cai) {
  const float mag = exp2_sfu(dt * ar2);
  float s, c;
  rotation(dt * ai, s, c);
  car = mag * c;
  cai = mag * s;
}

// exp(S (Ar + i Ai)) of a segment or chunk whose steps' dt sum to S (the
// a_t of a channel commute, so their product is exactly this), with the
// accurate sincosf for an angle of hundreds of radians.
__device__ __forceinline__ void span_decay(float S, float ar2, float ai,
                                           float& car, float& cai) {
  const float mag = exp2_sfu(S * ar2);
  float s, c;
  sincosf(S * ai, &s, &c);
  car = mag * c;
  cai = mag * s;
}

}  // namespace complex_scan
