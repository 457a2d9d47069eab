// Forward-only helpers of the selective-scan walks on Hopper (sm_90a):
// softplus, SiLU and the cp.async wait, shared by K1 (short_bidir_fwd.cu),
// K3 (chunked_scan_fwd.cu), K5 (short_scan_fwd.cu) and K7
// (complex_scan_fwd.cu); and the segmented walk that K3 and K7 share
// (`run_segment`, `launch_split`, below), which K5 runs as one segment
// from a zero state with K3's unit walk (`walk_unit`).
//
// The walks take one exponential a state update on the special function
// unit (`scan_lanes::exp2_sfu` on A log2(e), scaled once a thread) and
// compute softplus and the gate once a (step, channel), with the same
// unit's exp2 and reciprocal in place of the accurate expf, log1pf and the
// IEEE division: at most a few ulp apart, and a masked step (softplus
// exactly 0) stays an exact identity, since 2^0 is exactly 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "scan_lanes.cuh"

namespace scan_fwd {

using namespace scan_lanes;

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

// ---------------------------------------------------------------------------
// The segmented walk of K3 and K7 (and K5's single segment). A block is
// scan_lanes.cuh's unit shape: 128 threads, 32 channels of one group, a
// channel's states split over 4 lanes. It walks a segment of the sequence
// kUnit steps at a time, pipelined over three units with one block barrier a
// unit: unit n + 2's u, dt, z (kUnit x 32) and B, C (kUnit x 16) arrive in
// shared memory by 16-byte cp.async (element copies where a pointer, stride
// or width does not allow them), each thread's copies at offsets computed
// once a segment; unit n + 1 is prepared: softplus(dt + bias), dt u, D u and
// the gate once a (step, channel) into fp32 working tiles, B and C widened
// once; unit n is walked by the caller's `walk`; unit n's output tile leaves
// as 16-byte stores after the next barrier. Rows past the segment's end are
// exact identities (dt = 0), so every unit walks its kUnit rows with no
// branch a step. Nothing is padded in device memory. A launch splits the
// walk into segments, one block each, the blocks of one (row, 32 channels) a
// thread block cluster (`launch_split`).
//
// The kernels' parameter structs (P) share the field names used here: u,
// dt, z, B, C (the staged inputs), D, bias, out, seqlen, dim, dstate,
// ngroups, reverse, softplus, and seglen, nseg (the split).

constexpr int kUnit = 16;          // walk steps a staged unit
constexpr int kMaxSegments = 16;   // blocks a cluster (above 8: non-portable)
constexpr int kMinSegment = 64;    // fewest walk steps a segment of a split
static_assert(kUnit % kLanes == 0, "the lanes split a unit's sums evenly");

// Shared memory of one block (each offset a multiple of 16 bytes), every
// buffer twice (unit n uses buffer n % 2): raw buffers of the I/O type T
// (u, dt, z [kUnit][32], then B, C [kUnit][16]), fp32 working tiles, the
// output tile; then the segment's carry: kCarry float4 a thread (a lane's
// 4 states: K3 one, K7 two, the real and the imaginary parts).
template <typename T, int kCarry = 1>
struct FwdTiles {
  static constexpr int kTile = kUnit * kChannels;
  static constexpr int kRaw = 3 * kTile + 2 * kUnit * kMaxDstate;
  // one buffer of each: raw, (dt, dt u), (D u, gate), B and C, output
  static constexpr size_t kSet = sizeof(T) * kRaw +
                                 2 * sizeof(float2) * kTile +
                                 2 * sizeof(float) * kUnit * kMaxDstate +
                                 sizeof(T) * kTile;

  char* base;
  float4* carry;   // pass 1's end state, [kCarry][kThreads]
  float* dtsum;    // pass 1's sum of dt [32]

  static constexpr size_t bytes() {
    return 2 * kSet + sizeof(float4) * kCarry * kThreads +
           sizeof(float) * kChannels;
  }
  __device__ explicit FwdTiles(void* smem) : base(static_cast<char*>(smem)) {
    carry = reinterpret_cast<float4*>(base + 2 * kSet);
    dtsum = reinterpret_cast<float*>(carry + kCarry * kThreads);
  }
  __device__ T* raw(int n) const {
    return reinterpret_cast<T*>(base + (n & 1) * kSet);
  }
  __device__ float2* dd(int n) const {          // (dt, dt u)
    return reinterpret_cast<float2*>(raw(n) + kRaw);
  }
  __device__ float2* gd(int n) const {          // (D u, gate)
    return dd(n) + kTile;
  }
  __device__ float* B(int n) const {            // B [kUnit][16], then C
    return reinterpret_cast<float*>(gd(n) + kTile);
  }
  __device__ T* out(int n) const {              // y [kUnit][32]
    return reinterpret_cast<T*>(B(n) + 2 * kUnit * kMaxDstate);
  }
};

// A thread's 16-byte copies of every unit (kVec): row r, column c and the
// bytes n of a channel tile (n < 16 at the group's ragged edge), and row
// rs, first state ks of a B or C tile. Rows at or past kUnit: no copy.
struct Copies {
  int r, c, n, rs, ks;
};

template <typename T>
__device__ __forceinline__ Copies copies(int valid, int dstate) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kRowCopies = kChannels / kPer;
  const int per_row = max(1, dstate / kPer);   // vec: a multiple of kPer
  Copies cp;
  cp.r = threadIdx.x / kRowCopies;
  cp.c = (threadIdx.x % kRowCopies) * kPer;
  cp.n = max(0, min(kPer, valid - cp.c)) * static_cast<int>(sizeof(T));
  cp.rs = threadIdx.x / per_row;
  cp.ks = (threadIdx.x % per_row) * kPer;
  return cp;
}

// The element offsets of a thread's 16-byte copies in a segment's unit 0
// (kVec): its channel-tile row (also where its output row goes) and its
// B/C row, and their stride from one unit to the next (the anti-causal
// walk moves back in time). Computed once a segment, so a unit's copies
// cost a multiply-add each.
struct Cursor {
  int64_t co, bo, cstep, bstep;
};

template <typename P>
__device__ __forceinline__ Cursor cursor(const P& p, const UnitPlace& q,
                                         const Copies& cp, int seg0) {
  const int64_t rows = q.row * p.seqlen;
  const int tc = seg0 + cp.r, tb = seg0 + cp.rs;
  Cursor c;
  c.co = (rows + (p.reverse ? p.seqlen - 1 - tc : tc)) * p.dim + q.ch0 + cp.c;
  c.bo = ((rows + (p.reverse ? p.seqlen - 1 - tb : tb)) * p.ngroups +
          q.group) * p.dstate + cp.ks;
  const int64_t units = p.reverse ? -kUnit : kUnit;
  c.cstep = units * p.dim;
  c.bstep = units * p.ngroups * p.dstate;
  return c;
}

// Stage unit n (walk steps q.i0 .. q.i0 + q.nsteps - 1) into `raw` (kOut:
// pass 2, which also needs z and C): with kVec each thread's copies of
// `cp` at `cur`, else element copies (scan_lanes.cuh's).
template <typename T, bool kVec, bool kOut, typename P>
__device__ __forceinline__ void stage_unit(T* raw, int n, const UnitPlace& q,
                                           const P& p, const Copies& cp,
                                           const Cursor& cur) {
  constexpr int tile = FwdTiles<T>::kTile;
  const T* u = static_cast<const T*>(p.u);
  const T* dt = static_cast<const T*>(p.dt);
  const T* z = static_cast<const T*>(p.z);
  const T* B = static_cast<const T*>(p.B);
  const T* C = static_cast<const T*>(p.C);
  if constexpr (kVec) {
    if (cp.r < kUnit) {
      const int nb = cp.r < q.nsteps ? cp.n : 0;
      const int64_t o = nb ? cur.co + n * cur.cstep : 0;
      T* d = raw + cp.r * kChannels + cp.c;
      cp_async16(d, u + o, nb);
      cp_async16(d + tile, dt + o, nb);
      if (kOut && z) cp_async16(d + 2 * tile, z + o, nb);
    }
    if (cp.rs < kUnit) {
      const int nb = cp.rs < q.nsteps ? 16 : 0;
      const int64_t o = nb ? cur.bo + n * cur.bstep : 0;
      T* d = raw + 3 * tile + cp.rs * kMaxDstate + cp.ks;
      cp_async16(d, B + o, nb);
      if (kOut) cp_async16(d + kUnit * kMaxDstate, C + o, nb);
    }
  } else {
    stage_channels<T, false>(raw, kUnit, q, u);
    stage_channels<T, false>(raw + tile, kUnit, q, dt);
    if (kOut) stage_channels<T, false>(raw + 2 * tile, kUnit, q, z);
    stage_states<T, false>(raw + 3 * tile, kUnit, q, B);
    if (kOut) {
      stage_states<T, false>(raw + 3 * tile + kUnit * kMaxDstate, kUnit, q,
                             C);
    }
  }
}

// Unit n's output tile to device memory: with kVec each thread's 16-byte
// row of `cp` at `cur` (vec: the group's width is a multiple of the copy),
// else element stores.
template <typename T, bool kVec>
__device__ __forceinline__ void store_unit(T* out, const T* tile, int n,
                                           const UnitPlace& q,
                                           const Copies& cp,
                                           const Cursor& cur) {
  if constexpr (kVec) {
    if (cp.r < q.nsteps && cp.n) {
      *reinterpret_cast<uint4*>(out + cur.co + n * cur.cstep) =
          *reinterpret_cast<const uint4*>(tile + cp.r * kChannels + cp.c);
    }
  } else {
    store_channels<T, false>(out, tile, kUnit, q);
  }
}

// The fp32 working tiles of unit n from its staged tiles, each (step,
// channel) once; `bias` and `D` are those of the thread's channel (its
// column threadIdx.x % 32 in every row; 0 past the group's width). Rows at
// or past the unit's steps and channels past the group's width get dt = 0
// and dt u = 0: exact identities of the walk. B and C are zero past
// dstate.
template <typename T, bool kOut, int kCarry, typename P>
__device__ __forceinline__ void prep_unit(const FwdTiles<T, kCarry>& w,
                                          int n, const UnitPlace& q,
                                          const P& p, float bias, float D) {
  constexpr int tile = FwdTiles<T>::kTile;
  const T* raw = w.raw(n);
  float2* dd = w.dd(n);
  float2* gd = w.gd(n);
  float* bc = w.B(n);
  const bool cv = static_cast<int>(threadIdx.x % kChannels) < q.valid;
#pragma unroll
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    const bool on = cv && e / kChannels < q.nsteps;
    const float x = to_float(raw[tile + e]) + bias;
    const float dt = on ? (p.softplus ? softplus(x) : x) : 0.f;
    const float uv = to_float(raw[e]);
    dd[e] = make_float2(dt, dt * uv);
    if constexpr (kOut) {
      gd[e] = make_float2(D * uv,
                          p.z ? silu(to_float(raw[2 * tile + e])) : 1.f);
    }
  }
  for (int e = threadIdx.x; e < (kOut ? 2 : 1) * kUnit * kMaxDstate;
       e += kThreads) {   // B, then C (pass 2)
    bc[e] = e % kMaxDstate < q.dstate ? to_float(raw[3 * tile + e]) : 0.f;
  }
}

// Store the lane's states below dstate at `dst`: `left` = dstate - the
// lane's first state (nothing where it is <= 0), its 4 as one float4 where
// dstate is a multiple of 4 (`vec`: dst then 16-byte aligned). (A count
// clamped to [0, 4] with max/min and tested for 4 compiled to a branch
// that sent lanes with no state to the float4 store.)
__device__ __forceinline__ void store_state(float* dst,
                                            const float (&h)[kStates],
                                            int left, bool vec) {
  if (left >= kStates) {
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kStates; ++k) dst[k] = h[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kStates - 1; ++k) {
      if (k < left) dst[k] = h[k];
    }
  }
}

// The bits of the walk steps [i0, i1) of a unit that are checkpoints (every
// `chunk`-th walk step, from `next` on, which it advances).
__device__ __forceinline__ uint32_t checkpoint_mask(int& next, int chunk,
                                                    int i0, int i1) {
  uint32_t mask = 0;
  for (; next < i1; next += chunk) mask |= 1u << (next - i0);
  return mask;
}

// What one lane walks: its channel's 4 states of A as A2 = A log2(e), and
// where its checkpoints go.
struct FwdLane {
  int cw, quarter, q4;   // cw: the channel in the tile (0..31)
  bool active;           // the channel lies inside the group
  int ch;                // the channel (clamped into the group)
  float A2[kStates];
};

// The place of unit `idx` of a launch whose units are (row, group,
// 32-channel tile), the tiles of a row's group consecutive: its row and
// channels (the walk's steps, i0 and nsteps, are set unit by unit).
template <typename P>
__device__ __forceinline__ UnitPlace unit_place(const P& p, int64_t idx) {
  UnitPlace q;
  const int tile = static_cast<int>(idx % p.tiles);
  idx /= p.tiles;
  q.group = static_cast<int>(idx % p.ngroups);
  q.row = idx / p.ngroups;
  q.ch0 = q.group * p.width + tile * kChannels;
  q.valid = min(kChannels, p.width - tile * kChannels);
  q.seqlen = p.seqlen;
  q.dim = p.dim;
  q.dstate = p.dstate;
  q.ngroups = p.ngroups;
  q.reverse = p.reverse;
  return q;
}

// The thread's lane in unit q: its channel, its quarter of the states and
// their A2 = A log2(e) (0 past the group's width and past dstate).
template <typename P>
__device__ __forceinline__ FwdLane fwd_lane(const P& p, const UnitPlace& q) {
  FwdLane L;
  const int lane = threadIdx.x & 31;
  L.cw = (threadIdx.x >> 5) * (32 / kLanes) + lane / kLanes;
  L.quarter = lane % kLanes;
  L.q4 = L.quarter * kStates;
  L.active = L.cw < q.valid;
  L.ch = q.ch0 + min(L.cw, q.valid - 1);
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const int n = L.q4 + k;
    L.A2[k] = L.active && n < p.dstate ? p.A[L.ch * p.dstate + n] * kLog2e
                                       : 0.f;
  }
  return L;
}

// Walk one prepared unit (buffer n): every row (rows past its steps are
// identities). Pass 1 (!kOut) adds the segment's sum of dt. Pass 2 keeps
// each step's partial y (the lane's 4 states) in registers, then sums them
// over the channel's 4 lanes in 2 transposing stages (off the walk's
// dependent chain), lane q ending with steps q kUnit/4 .. (q + 1) kUnit/4
// - 1, whose outputs it writes to the output tile; with kCk it stores the
// state before each step whose bit is set in `ckmask` to `ck` (then the
// next checkpoint, `ck_stride` further).
template <typename T, bool kOut, bool kCk>
__device__ __forceinline__ void walk_unit(const FwdTiles<T>& w, int n,
                                          const FwdLane& L, float (&h)[kStates],
                                          float& dtsum, uint32_t ckmask,
                                          float*& ck, int64_t ck_stride,
                                          int left, bool vec) {
  const float2* dd = w.dd(n);
  const float* Bt = w.B(n) + L.q4;
  const float* Ct = Bt + kUnit * kMaxDstate;
  float y[kUnit];
#pragma unroll
  for (int i = 0; i < kUnit; ++i) {
    if constexpr (kCk) {
      if ((ckmask >> i) & 1u) {
        store_state(ck, h, left, vec);
        ck += ck_stride;
      }
    }
    const float2 d = dd[i * kChannels + L.cw];
    const float4 b = ld4(Bt + i * kMaxDstate);
    if constexpr (kOut) {
      const float4 c = ld4(Ct + i * kMaxDstate);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        h[k] = fmaf(exp2_sfu(d.x * L.A2[k]), h[k], d.y * at(b, k));
        acc = fmaf(at(c, k), h[k], acc);
      }
      y[i] = acc;
    } else {
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        h[k] = fmaf(exp2_sfu(d.x * L.A2[k]), h[k], d.y * at(b, k));
      }
      dtsum += d.x;
    }
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
      out[e] = from_float<T>((y[j] + g.x) * g.y);
    }
  }
}

// Walk the segment of walk steps [seg0, seg1), kUnit steps at a time,
// pipelined over three units with one block barrier a unit (see the note
// above): `walk(n, i0, i1)` walks prepared unit n (buffer n % 2; walk
// steps [i0, i1)) and, with kOut, fills its output tile, which leaves
// after the next barrier. Pass 1 (!kOut) stages and prepares no z and C.
template <typename T, bool kVec, bool kOut, int kCarry, typename P,
          typename Walk>
__device__ __forceinline__ void run_segment(const P& p,
                                            const FwdTiles<T, kCarry>& w,
                                            const UnitPlace& q,
                                            const Copies& cp, int seg0,
                                            int seg1, Walk&& walk) {
  const int nunits = (seg1 - seg0 + kUnit - 1) / kUnit;
  const Cursor cur = cursor(p, q, cp, seg0);
  const int c = threadIdx.x % kChannels;
  const bool cv = c < q.valid;
  const float bias = cv && p.bias ? p.bias[q.ch0 + c] : 0.f;
  const float D = cv && p.D ? p.D[q.ch0 + c] : 0.f;
  auto unit = [&](int n) {
    UnitPlace u = q;
    u.i0 = seg0 + n * kUnit;
    u.nsteps = min(kUnit, seg1 - u.i0);
    return u;
  };
  T* out = static_cast<T*>(p.out);
  stage_unit<T, kVec, kOut>(w.raw(0), 0, unit(0), p, cp, cur);
  cp_async_commit();
  if (nunits > 1) stage_unit<T, kVec, kOut>(w.raw(1), 1, unit(1), p, cp, cur);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // unit 0's tiles are in
  prep_unit<T, kOut>(w, 0, unit(0), p, bias, D);
  for (int n = 0; n < nunits; ++n) {
    cp_async_wait_all();
    // unit n is prepared and unit n + 1 staged; unit n - 1's walk is done,
    // so its output tile is complete and its raw and working buffers are
    // free
    __syncthreads();
    if (kOut && n > 0) {
      store_unit<T, kVec>(out, w.out(n - 1), n - 1, unit(n - 1), cp, cur);
    }
    if (n + 2 < nunits) {
      stage_unit<T, kVec, kOut>(w.raw(n), n + 2, unit(n + 2), p, cp, cur);
    }
    cp_async_commit();
    if (n + 1 < nunits) prep_unit<T, kOut>(w, n + 1, unit(n + 1), p, bias, D);
    const int i0 = seg0 + n * kUnit;
    walk(n, i0, min(i0 + kUnit, seg1));
  }
  __syncthreads();  // the last output tile is complete; every buffer free
  if (kOut) {
    store_unit<T, kVec>(out, w.out(nunits - 1), nunits - 1, unit(nunits - 1),
                        cp, cur);
  }
}

// What a kernel's launches ask the device once: its resident blocks an SM
// (one figure for every card the sm_90a build runs on; the query costs
// more host time than the launch) and whether it may form clusters above
// the portable size.
struct LaunchCache {
  std::atomic<int> per_sm{0};
  std::atomic<bool> non_portable{false};
};

// Launch `units` (row, 32-channel tile) walks of `kernel`, each split into
// p.nseg segments of p.seglen steps (a multiple of kUnit), the segments of
// a unit one cluster. Only a grid that leaves half the card idle is split,
// into the most segments (4 or more: 2 walk the whole length twice) that
// keep it within 1.25 waves of resident blocks, each at least kMinSegment
// steps.
template <typename P>
int launch_split(void (*kernel)(P), P p, long long units, int smem,
                 LaunchCache& cache, cudaStream_t s) {
  int device = 0, sms = 0, per_sm = cache.per_sm.load();
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess && per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    cache.per_sm.store(per_sm);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(sms) * per_sm;
  int g = 1;
  if (2 * units < resident) {
    for (int c = kMaxSegments; c >= 4; c /= 2) {
      if (4 * units * c <= 5 * resident && p.seqlen >= c * kMinSegment) {
        g = c;
        break;
      }
    }
  }
  const int per_seg = (p.seqlen + g - 1) / g;
  p.seglen = (per_seg + kUnit - 1) / kUnit * kUnit;
  p.nseg = (p.seqlen + p.seglen - 1) / p.seglen;  // no empty segment
  if (units * p.nseg > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.nseg > 8 && !cache.non_portable.load()) {   // above the portable size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    cache.non_portable.store(true);
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(units * p.nseg));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nseg;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.nseg > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scan_fwd
