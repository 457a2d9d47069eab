// Selective scan with complex A, forward, for Hopper (sm_90a): kernel K7.
//
// Replaces the TPU kernel `_cfwd_kernel` in
// video_mamba_suite_tpu/ops/selective_scan_pallas.py, launched from
// `_complex_fwd_impl` (reached through `_complex_core` from
// `selective_scan_pallas` with complex A). The recurrence runs in two real
// channels; per (row, channel, state), walking t = 0..L-1, or L-1..0 when
// `reverse` (the JAX package's flip composition, walked directly):
//
//     dt_t = softplus(dt_t + bias)                      (softplus optional)
//     a_t  = exp(dt_t * Ar) * (cos(dt_t * Ai) + i sin(dt_t * Ai))
//     hr_t = Re(a_t) hr_{t-1} - Im(a_t) hi_{t-1} + dt_t u_t B_t[group]
//     hi_t = Im(a_t) hr_{t-1} + Re(a_t) hi_{t-1}
//     y_t  = (2 sum_n C_t[group] hr_t + D u_t) * silu(z_t)
//
// h starts at (h0r, h0i) (zeros when absent); the last state is the state
// after the last step of the walk. Channel d reads B and C of group
// d / (dim / G); B and C are real. u, dt, z, B, C and the output share one
// type (fp32 or bf16); Ar, Ai, D, bias and the states are fp32.
//
// Checkpoints (the `want_states` outputs of `_complex_fwd_impl`, for the
// backward, kernel K8 in complex_scan_bwd.cu): when `statesr` is not null,
// the state before walk step j * chunk goes to states{r,i}[row, j] for
// j = 0 .. ceil(L / chunk) - 1, fp32 (batch, nchunks, dim, dstate),
// whatever the segmentation below. The wrapper asks for them only when a
// backward will follow.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 outside the
// tensor cores; the special function unit 16 results a clock an SM), at the
// scan microbench shape (batch 8, L 2048, dim 1024, dstate 16, fp32 I/O):
// u, dt, z in and y out move 4 x 67 MB plus 2.1 MB of B and C, 270 MB,
// 81 us; each of the 268 M complex state updates takes some 17 fp32
// operations and three special-function results (an exp2, a sine and a
// cosine: complex_scan.cuh), 805 M results a walk, about 0.19 ms. So the
// special function unit, not the bytes, sets the floor.
//
// Design: K3's (chunked_scan_fwd.cu) on two real channels. A block is
// scan_lanes.cuh's unit shape, 128 threads on 32 channels of one group, a
// channel's 16 complex states split over 4 lanes (4 a lane: hr, hi,
// Ar log2(e), Ai), walking 16-step units staged by cp.async and prepared
// once a (step, channel) through scan_fwd.cuh's pipeline (`run_segment`);
// each step's partial y is kept in registers and summed over the 4 lanes
// after the unit; y leaves by 16-byte stores, the checkpoints as float4.
// A grid that leaves half the card idle splits the walk in time by K3's
// rule (`launch_split`: 4, 8 or 16 segments within 1.25 waves of resident
// blocks), the blocks of one (row, 32 channels) a thread block cluster:
//   pass 1:  every block but the last walks its segment from zero and
//            leaves the end state and the segment's sum of dt in its
//            shared memory;
//   combine: after a cluster barrier each block chains the segments before
//            it from the initial state through distributed shared memory,
//            H <- exp(A sum dt) H + end state: the a_t of a channel
//            commute, so a segment's decay is exactly exp(A sum dt), whose
//            rotation (hundreds of radians) takes the accurate sincosf;
//   pass 2:  every block walks its segment again from that state, writing
//            y and the checkpoints; the last block writes the last state.
// At the microbench shape (256 units of 32 channels, 4 resident blocks an
// SM at 128 registers) the rule does not split: two blocks an SM walk the
// whole length (4 segments, two walks of 3/4 of the steps, ran much
// slower on an H100), each lane's 12 special-function results a step
// independent of its states' chain.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "complex_scan.cuh"
#include "scan_fwd.cuh"
#include "scan_lanes.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace scan_lanes;
using namespace scan_fwd;
using complex_scan::span_decay;
using complex_scan::step_decay;

struct Params {
  const void* u;      // (batch, seqlen, dim)
  const void* dt;     // (batch, seqlen, dim), before bias and softplus
  const void* z;      // (batch, seqlen, dim) or null
  const void* B;      // (batch, seqlen, ngroups, dstate)
  const void* C;      // (batch, seqlen, ngroups, dstate)
  const float* Ar;    // (dim, dstate)
  const float* Ai;    // (dim, dstate)
  const float* D;     // (dim,) or null
  const float* bias;  // (dim,) or null
  const float* h0r;   // (batch, dim, dstate) or null
  const float* h0i;
  void* out;          // (batch, seqlen, dim)
  float* lastr;       // (batch, dim, dstate)
  float* lasti;
  float* statesr;     // (batch, nchunks, dim, dstate) or null
  float* statesi;
  int seqlen, dim, dstate, ngroups;
  int chunk;     // walk steps between checkpoints
  int nchunks;
  int width;     // channels a group
  int tiles;     // 32-channel tiles a group
  int nseg;      // segments (blocks of a cluster) a (row, tile)
  int seglen;    // walk steps a segment (a multiple of kUnit)
  int reverse, softplus;
};

// What one lane walks: its channel's 4 states of A as Ar log2(e) and Ai,
// and where its checkpoints go.
struct CLane {
  int cw, quarter, q4;   // cw: the channel in the tile (0..31)
  bool active;           // the channel lies inside the group
  int ch;                // the channel (clamped into the group)
  float Ar2[kStates];
  float Ai[kStates];
};

// The rows of one prepared unit (buffer n), every one (rows past its
// steps are identities): pass 2 (kOut) keeps each step's partial
// sum_n C hr (the lane's 4 states) in y, pass 1 adds each step's dt to
// dtsum; with kInner it stores the state before each row whose bit is set
// in `ckmask` to `ckr`, `cki` (then the next checkpoint, `ck_stride`
// further). A store inside the rows splits the unrolled walk at that row,
// which keeps the compiler from computing a row's decays during the row
// before (the walk with checkpoints every 16 steps ran markedly slower on
// an H100 that way), so only checkpoints off a unit's first row take it.
template <bool kOut, bool kInner>
__device__ __forceinline__ void walk_rows(const float2* dd, const float* Bt,
                                          const CLane& L,
                                          float (&hr)[kStates],
                                          float (&hi)[kStates],
                                          float (&y)[kUnit], float& dtsum,
                                          uint32_t ckmask, float*& ckr,
                                          float*& cki, int64_t ck_stride,
                                          int left, bool vec) {
  const float* Ct = Bt + kUnit * kMaxDstate;
#pragma unroll
  for (int i = 0; i < kUnit; ++i) {
    if constexpr (kInner) {
      if ((ckmask >> i) & 1u) {
        store_state(ckr, hr, left, vec);
        store_state(cki, hi, left, vec);
        ckr += ck_stride;
        cki += ck_stride;
      }
    }
    const float2 d = dd[i * kChannels + L.cw];
    const float4 b = ld4(Bt + i * kMaxDstate);
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kOut) c = ld4(Ct + i * kMaxDstate);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      float car, cai;
      step_decay(d.x, L.Ar2[k], L.Ai[k], car, cai);
      const float nr = fmaf(car, hr[k], fmaf(-cai, hi[k], d.y * at(b, k)));
      hi[k] = fmaf(cai, hr[k], car * hi[k]);
      hr[k] = nr;
      if constexpr (kOut) acc = fmaf(at(c, k), nr, acc);
    }
    if constexpr (kOut) {
      y[i] = acc;
    } else {
      dtsum += d.x;
    }
  }
}

// Walk one prepared unit (buffer n). Pass 1 (!kOut) adds the segment's
// sum of dt. Pass 2 sums each step's partial y over the channel's 4 lanes
// after the rows in 2 transposing stages, lane q ending with steps
// q kUnit/4 .. (q + 1) kUnit/4 - 1, whose outputs it writes to the output
// tile; with kCk it stores the state before each step whose bit is set in
// `ckmask` (the unit's first before its rows).
template <typename T, bool kOut, bool kCk>
__device__ __forceinline__ void walk_unit(const FwdTiles<T, 2>& w, int n,
                                          const CLane& L,
                                          float (&hr)[kStates],
                                          float (&hi)[kStates], float& dtsum,
                                          uint32_t ckmask, float*& ckr,
                                          float*& cki, int64_t ck_stride,
                                          int left, bool vec) {
  const float2* dd = w.dd(n);
  const float* Bt = w.B(n) + L.q4;
  float y[kUnit];
  if constexpr (kCk) {
    if (ckmask & 1u) {
      store_state(ckr, hr, left, vec);
      store_state(cki, hi, left, vec);
      ckr += ck_stride;
      cki += ck_stride;
    }
    ckmask &= ~1u;
  }
  if (kCk && ckmask) {
    walk_rows<kOut, true>(dd, Bt, L, hr, hi, y, dtsum, ckmask, ckr, cki,
                          ck_stride, left, vec);
  } else {
    walk_rows<kOut, false>(dd, Bt, L, hr, hi, y, dtsum, ckmask, ckr, cki,
                           ck_stride, left, vec);
  }
  if constexpr (kOut) {
    // lane bits 0-1 are the quarter
    butterfly_stage<2, kUnit / 2>(y, L.quarter);
    butterfly_stage<1, kUnit / 4>(y, L.quarter);
    const float2* gd = w.gd(n);
    T* out = w.out(n);
#pragma unroll
    for (int j = 0; j < kUnit / 4; ++j) {
      const int e = (L.quarter * (kUnit / 4) + j) * kChannels + L.cw;
      const float2 g = gd[e];
      out[e] = from_float<T>(fmaf(2.f, y[j], g.x) * g.y);
    }
  }
}

// Walk the segment of walk steps [seg0, seg1) from the state (hr, hi) (in
// and out) through scan_fwd.cuh's pipeline. Pass 1 (!kOut) leaves the end
// state and adds to dtsum; pass 2 writes y and, with kCk, the checkpoints.
template <typename T, bool kVec, bool kOut, bool kCk>
__device__ void walk_segment(const Params& p, const FwdTiles<T, 2>& w,
                             const UnitPlace& q, const CLane& L,
                             const Copies& cp, int seg0, int seg1,
                             float (&hr)[kStates], float (&hi)[kStates],
                             float& dtsum) {
  const int left = p.dstate - L.q4;
  const bool vec = p.dstate % kStates == 0;
  const int64_t ck_stride = static_cast<int64_t>(p.dim) * p.dstate;
  // the next checkpoint (walk step ck_next) and where the lane stores it
  int ck_next = 0;
  float* ckr = nullptr;
  float* cki = nullptr;
  if constexpr (kCk) {
    const int first = (seg0 + p.chunk - 1) / p.chunk;
    ck_next = first * p.chunk;
    const int64_t off =
        ((q.row * p.nchunks + first) * p.dim + L.ch) * p.dstate + L.q4;
    ckr = p.statesr + off;
    cki = p.statesi + off;
  }
  run_segment<T, kVec, kOut>(p, w, q, cp, seg0, seg1,
                             [&](int n, int i0, int i1) {
    uint32_t ckmask = 0;
    if constexpr (kCk) {
      ckmask = checkpoint_mask(ck_next, p.chunk, i0, i1);
      if (!L.active) ckmask = 0;
    }
    walk_unit<T, kOut, kCk>(w, n, L, hr, hi, dtsum, ckmask, ckr, cki,
                            ck_stride, left, vec);
  });
}

template <typename T, bool kVec, bool kCk>
__global__ void __launch_bounds__(kThreads, 4)
    complex_scan_fwd_lanes(Params p) {
  extern __shared__ float4 smem4[];
  const FwdTiles<T, 2> w(smem4);

  // block -> (row, group, tile, segment); the nseg blocks of a (row, tile)
  // are consecutive, one cluster
  const int seg = static_cast<int>(blockIdx.x % p.nseg);
  int64_t rest = blockIdx.x / p.nseg;
  const int tile = static_cast<int>(rest % p.tiles);
  rest /= p.tiles;
  UnitPlace q;
  q.group = static_cast<int>(rest % p.ngroups);
  q.row = rest / p.ngroups;
  q.ch0 = q.group * p.width + tile * kChannels;
  q.valid = min(kChannels, p.width - tile * kChannels);
  q.seqlen = p.seqlen;
  q.dim = p.dim;
  q.dstate = p.dstate;
  q.ngroups = p.ngroups;
  q.reverse = p.reverse;
  const Copies cp = copies<T>(q.valid, p.dstate);

  CLane L;
  const int lane = threadIdx.x & 31;
  L.cw = (threadIdx.x >> 5) * (32 / kLanes) + lane / kLanes;
  L.quarter = lane % kLanes;
  L.q4 = L.quarter * kStates;
  L.active = L.cw < q.valid;
  L.ch = q.ch0 + min(L.cw, q.valid - 1);
  const int64_t sidx = (q.row * p.dim + L.ch) * p.dstate + L.q4;
  float hr[kStates], hi[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const int n = L.q4 + k;
    const bool on = L.active && n < p.dstate;
    L.Ar2[k] = on ? p.Ar[L.ch * p.dstate + n] * kLog2e : 0.f;
    L.Ai[k] = on ? p.Ai[L.ch * p.dstate + n] : 0.f;
    hr[k] = on && p.h0r ? p.h0r[sidx + k] : 0.f;
    hi[k] = on && p.h0i ? p.h0i[sidx + k] : 0.f;
  }

  const int seg0 = seg * p.seglen;
  const int seg1 = min(p.seqlen, seg0 + p.seglen);
  if (p.nseg > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    float er[kStates] = {0.f, 0.f, 0.f, 0.f};
    float ei[kStates] = {0.f, 0.f, 0.f, 0.f};
    float dtsum = 0.f;
    if (seg + 1 < p.nseg) {
      walk_segment<T, kVec, false, false>(p, w, q, L, cp, seg0, seg1, er, ei,
                                          dtsum);
    }
    w.carry[threadIdx.x] = make_float4(er[0], er[1], er[2], er[3]);
    w.carry[kThreads + threadIdx.x] = make_float4(ei[0], ei[1], ei[2], ei[3]);
    if (L.quarter == 0) w.dtsum[L.cw] = dtsum;
    cluster.sync();  // every segment's end state is in its block
    // the state entering this segment: the initial state carried through
    // the segments before it (not unrolled: each step takes sincosf)
#pragma unroll 1
    for (int s = 0; s < seg; ++s) {
      const float4 Er = *cluster.map_shared_rank(w.carry + threadIdx.x, s);
      const float4 Ei =
          *cluster.map_shared_rank(w.carry + kThreads + threadIdx.x, s);
      const float S = *cluster.map_shared_rank(w.dtsum + L.cw, s);
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        float car, cai;
        span_decay(S, L.Ar2[k], L.Ai[k], car, cai);
        const float nr = fmaf(car, hr[k], fmaf(-cai, hi[k], at(Er, k)));
        hi[k] = fmaf(cai, hr[k], fmaf(car, hi[k], at(Ei, k)));
        hr[k] = nr;
      }
    }
    cluster.sync();  // no block leaves while another reads its carry
  }

  float unused = 0.f;
  walk_segment<T, kVec, true, kCk>(p, w, q, L, cp, seg0, seg1, hr, hi,
                                   unused);
  if (seg + 1 == p.nseg && L.active) {
    const int left = p.dstate - L.q4;
    const bool vec = p.dstate % kStates == 0;
    store_state(p.lastr + sidx, hr, left, vec);
    store_state(p.lasti + sidx, hi, left, vec);
  }
}

// Pick the segments a (row, tile) (`launch_split`, K3's rule) and launch,
// the nseg blocks of a (row, tile) as one cluster.
template <typename T, bool kVec, bool kCk>
int launch_kernel(const Params& p, long long batch, cudaStream_t s) {
  constexpr int smem = static_cast<int>(FwdTiles<T, 2>::bytes());
  static_assert(smem <= 48 * 1024, "no opt-in to more shared memory");
  static LaunchCache cache;
  const long long units = batch * p.ngroups * static_cast<long long>(p.tiles);
  return launch_split(complex_scan_fwd_lanes<T, kVec, kCk>, p, units, smem,
                      cache, s);
}

template <typename T>
int launch(const Params& p, long long batch, cudaStream_t s) {
  const bool vec = vec_ok({p.u, p.dt, p.z, p.B, p.C, p.out}, p.dim, p.width,
                          p.dstate, sizeof(T));
  if (p.statesr) {
    return vec ? launch_kernel<T, true, true>(p, batch, s)
               : launch_kernel<T, false, true>(p, batch, s);
  }
  return vec ? launch_kernel<T, true, false>(p, batch, s)
             : launch_kernel<T, false, false>(p, batch, s);
}

}  // namespace

extern "C" {

// Launches K7 on `stream`. dtype: 0 float32, 1 bfloat16 (u, dt, z, B, C and
// out share it; Ar, Ai, D, bias, h0r, h0i, lastr, lasti and the states are
// float32). B and C are (batch, seqlen, ngroups, dstate) with dim divisible
// by ngroups. z, D, bias, h0r/h0i (both or neither) and statesr/statesi
// (both or neither) may be null; with states, `chunk` >= 1 is the number
// of walk steps between checkpoints. Returns the cudaError_t of the launch
// (0 on success).
int complex_scan_fwd(int dtype, long long batch, int seqlen, int dim,
                     int dstate, int ngroups, int reverse, int softplus,
                     int chunk, const void* u, const void* dt, const void* z,
                     const void* B, const void* C, const void* Ar,
                     const void* Ai, const void* D, const void* bias,
                     const void* h0r, const void* h0i, void* out,
                     void* lastr, void* lasti, void* statesr, void* statesi,
                     void* stream) {
  if (batch < 1 || seqlen < 1 || dim < 1 || dstate < 1 ||
      dstate > kMaxDstate || ngroups < 1 || dim % ngroups != 0 ||
      (dtype != 0 && dtype != 1) || (!h0r) != (!h0i) ||
      (!statesr) != (!statesi) || (statesr && chunk < 1) || !lastr ||
      !lasti) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.u = u;
  p.dt = dt;
  p.z = z;
  p.B = B;
  p.C = C;
  p.Ar = static_cast<const float*>(Ar);
  p.Ai = static_cast<const float*>(Ai);
  p.D = static_cast<const float*>(D);
  p.bias = static_cast<const float*>(bias);
  p.h0r = static_cast<const float*>(h0r);
  p.h0i = static_cast<const float*>(h0i);
  p.out = out;
  p.lastr = static_cast<float*>(lastr);
  p.lasti = static_cast<float*>(lasti);
  p.statesr = static_cast<float*>(statesr);
  p.statesi = static_cast<float*>(statesi);
  p.chunk = statesr ? chunk : 1;
  p.nchunks = statesr ? (seqlen + chunk - 1) / chunk : 0;
  p.seqlen = seqlen;
  p.dim = dim;
  p.dstate = dstate;
  p.ngroups = ngroups;
  p.width = dim / ngroups;
  p.tiles = (p.width + kChannels - 1) / kChannels;
  p.nseg = 1;
  p.seglen = seqlen;
  p.reverse = reverse;
  p.softplus = softplus;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, batch, s);
  return launch<__nv_bfloat16>(p, batch, s);
}

const char* complex_scan_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
