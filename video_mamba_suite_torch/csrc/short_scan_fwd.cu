// Short selective scan, forward, one direction, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_short_fwd_kernel` in
// video_mamba_suite_tpu/ops/selective_scan_pallas.py (launched from
// `_short_fwd_impl`, reached through `_short_core`; the anti-causal form
// there goes through flips). One direction of a selective scan for
// sequences of at most 64 steps with no initial state, returning the output
// and the last state. Per (row, channel, state), walking t = 0..L-1, or
// L-1..0 when `reverse`:
//
//     dt_t = softplus(dt_t + bias)                     (softplus optional)
//     h_t  = exp(dt_t * A) * h_prev + dt_t * u_t * B_t[group]
//     y_t  = (sum_n C_t[group] * h_t + D * u_t) * silu(z_t)
//
// h starts at zero; the last state is the state after the last step of the
// walk (t = L-1, or t = 0 when reverse), fp32 (batch, dim, dstate). Channel
// d reads B and C of group d / (dim / G). u, dt, z, B, C and the output
// share one type (fp32 or bf16); A, D and bias are fp32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores):
//   Mamba LM prefill (batch 8, seqlen 16, dim 1536, dstate 16, bf16):
//     u, dt, z in and y out, 4 x 0.39 MB, the fp32 last state 0.79 MB, A
//     0.1 MB: about 2.5 MB, so about 0.75 us; 3.1 M state updates at about
//     6 operations, 0.3 us. The launch and the walk's latency bound it:
//     16 dependent steps.
//   short anticipation call (batch 16, seqlen 64, dim 2048, dstate 16,
//     fp32): 4 x 8.4 MB of u, dt, z and y, 2.1 MB of last state: about 36
//     MB, 0.011 ms; 33.5 M state updates, 0.20 GFLOP, 0.003 ms. The bytes
//     bound it.
//   video-adapter shape (batch 1568, seqlen 16, dim 768, dstate 16, bf16):
//     4 x 38.5 MB of u, dt, z and y, 77 MB of last state, 1.6 MB of B and
//     C: about 233 MB, about 70 us; 308 M state updates, 1.85 GFLOP, about
//     28 us. The bytes bound it.
//
// What the walk needs at those shapes: a thread a (row, channel) would
// give the LM prefill 96 blocks of 128 threads (384 warps on 132 SMs),
// each thread walking 16 states a step in series. So:
//
// Design: K3's (chunked_scan_fwd.cu) on scan_fwd.cuh's pieces, with one
// segment from a zero state, never split, and no checkpoints. A block of
// 128 threads takes one (row, group, 32-channel tile), a channel's 16
// states over 4 lanes (4 a lane): at the LM prefill 8 x 48 = 384 blocks
// (1536 warps), at the anticipation shape 1024. It walks the row 16 steps
// at a time (`run_segment`), pipelined over three units with one block
// barrier a unit: a unit's u, dt, z (16 x 32) and B, C (16 x 16) arrive in
// shared memory by 16-byte cp.async (element copies where a pointer,
// stride or width does not allow them); softplus(dt + bias), dt u, D u and
// the gate are computed once a (step, channel) into fp32 working tiles,
// with exp2 and the reciprocal on the special function unit; the walk
// (`walk_unit`) takes one exp2 a state update, keeps each step's partial y
// in registers and sums it over the 4 lanes after the unit; y leaves
// through a shared tile as 16-byte stores, the last state as float4 stores
// (`store_state`). Rows past the walk's end are exact identities (dt =
// 0), so every unit walks its 16 rows with no branch a step. Nothing is
// padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_fwd.cuh"
#include "scan_lanes.cuh"

namespace {

using namespace scan_lanes;
using namespace scan_fwd;

struct Params {
  const void* u;      // (batch, seqlen, dim)
  const void* dt;     // (batch, seqlen, dim), before bias and softplus
  const void* z;      // (batch, seqlen, dim) or null
  const void* B;      // (batch, seqlen, ngroups, dstate)
  const void* C;      // (batch, seqlen, ngroups, dstate)
  const float* A;     // (dim, dstate)
  const float* D;     // (dim,) or null
  const float* bias;  // (dim,) or null
  void* out;          // (batch, seqlen, dim)
  float* last;        // (batch, dim, dstate)
  int seqlen, dim, dstate, ngroups;
  int width;     // channels a group
  int tiles;     // 32-channel tiles a group
  int reverse, softplus;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 5)
    short_scan_fwd_lanes(Params p) {
  extern __shared__ float4 smem4[];
  const FwdTiles<T> w(smem4);
  const UnitPlace q = unit_place(p, blockIdx.x);
  const Copies cp = copies<T>(q.valid, p.dstate);
  const FwdLane L = fwd_lane(p, q);
  const int left = p.dstate - L.q4;
  const bool vec = p.dstate % kStates == 0;
  float h[kStates] = {0.f, 0.f, 0.f, 0.f};
  float unused = 0.f;
  float* no_ck = nullptr;
  run_segment<T, kVec, true>(p, w, q, cp, 0, p.seqlen,
                             [&](int n, int, int) {
    walk_unit<T, true, false>(w, n, L, h, unused, 0u, no_ck, 0, left, vec);
  });
  if (L.active) {
    store_state(p.last + (q.row * p.dim + L.ch) * p.dstate + L.q4, h, left,
                vec);
  }
}

template <typename T, bool kVec>
int launch_vec(const Params& p, long long units, cudaStream_t s) {
  constexpr int smem = static_cast<int>(FwdTiles<T>::bytes());
  static_assert(smem <= 48 * 1024, "no opt-in to more shared memory");
  short_scan_fwd_lanes<T, kVec><<<static_cast<unsigned>(units), kThreads,
                                  smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, long long units, cudaStream_t s) {
  const bool vec = vec_ok({p.u, p.dt, p.z, p.B, p.C, p.out}, p.dim, p.width,
                          p.dstate, sizeof(T));
  return vec ? launch_vec<T, true>(p, units, s)
             : launch_vec<T, false>(p, units, s);
}

}  // namespace

extern "C" {

// Launches one direction on `stream`. dtype: 0 float32, 1 bfloat16 (u, dt,
// z, B, C and out share it; A, D, bias and last are float32). B and C are
// (batch, seqlen, ngroups, dstate) with dim divisible by ngroups; z, D and
// bias may be null. Returns the cudaError_t of the launch (0 on success).
int short_scan_fwd(int dtype, long long batch, int seqlen, int dim,
                   int dstate, int ngroups, int reverse, int softplus,
                   const void* u, const void* dt, const void* z,
                   const void* B, const void* C, const void* A,
                   const void* D, const void* bias, void* out, void* last,
                   void* stream) {
  if (batch < 1 || batch > 0x7fffffffLL || seqlen < 1 ||
      seqlen > kMaxSteps || dim < 1 || dstate < 1 ||
      dstate > kMaxDstate || ngroups < 1 || dim % ngroups != 0 ||
      (dtype != 0 && dtype != 1) || !last) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.u = u;
  p.dt = dt;
  p.z = z;
  p.B = B;
  p.C = C;
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.last = static_cast<float*>(last);
  p.seqlen = seqlen;
  p.dim = dim;
  p.dstate = dstate;
  p.ngroups = ngroups;
  p.width = dim / ngroups;
  p.tiles = (p.width + kChannels - 1) / kChannels;
  p.reverse = reverse;
  p.softplus = softplus;
  const long long units = batch * ngroups * static_cast<long long>(p.tiles);
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, units, s);
  return launch<__nv_bfloat16>(p, units, s);
}

const char* short_scan_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
