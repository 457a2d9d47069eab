// Lane-split selective-scan adjoint, shared by K2 (short_bidir_bwd.cu), K4
// (chunked_scan_bwd.cu) and K6 (short_scan_bwd.cu) on Hopper (sm_90a); K6
// also walks its units forward alone first (`prep_forward`,
// `forward_piece`) to find each unit's start state.
//
// A "unit" is a tile of S walk steps (S a multiple of kPiece, at most 64)
// by kChannels = 32 channels of one row, worked by one block of kThreads =
// 128 threads. A channel's 16 states are split over a group of kLanes = 4
// neighbouring lanes, 4 states a lane (lane = 4 x channel-in-warp + quarter),
// so the fp32 state, its per-step copies and the adjoint fit in at most 128
// registers a thread (one lane a channel held all 16 and took 240, which
// left 8 warps an SM): at least 4 blocks, 16 warps, an SM.
//
// Per unit:
//   stage:  cp.async 16-byte copies bring the unit's u, dt, z and g (S x 32
//           in the I/O type) and B and C (S x dstate) into the raw buffer,
//           issued as soon as the unit before has read its tiles (after
//           that unit's prep), so the copy overlaps that unit's walk; one
//           raw buffer serves (two did not fit 64 fp32 steps in shared
//           memory). Rows at or past the walk's end and channels past the
//           group's width are zero-filled. Where a pointer, stride or width
//           does not allow 16-byte copies the same code copies element by
//           element.
//   prep:   each (step, channel) once: dt = softplus(dt + bias) (torch's
//           threshold 20) and its derivative, gy = g silu(z) and the
//           gate's factor g (s + silu (1 - s)) for dz, widened to fp32
//           working tiles; B and C widened and zero-padded to 16 states.
//           Steps past the walk's end get dt = 0 and u = gy = sg = 0, so
//           they are exact identities (a = 1, nothing added), as are
//           channels past the width: the walks run every row of the tile
//           with no branch a step.
//   walk:   `adjoint_walk` below; its outputs du, ddt and dz go to a shared
//           tile and leave as 16-byte stores, its dB and dC to a shared
//           reduction tile that the block sums over its 4 warps.
//
// The per-channel sums (y, sum_n dh B, sum_n dh h_{t-1} a A) take 2
// xor-shuffles inside the lane group; dB and dC, sums over channels, take a
// transposing butterfly over the 8 channels of a warp (7 shuffles for the 8
// values a lane holds), then the block's 4 warps in shared memory. No
// atomics: every partial is written by one thread.
//
// Exponentials: a = exp2(dt A') with A' = A log2(e) scaled once a lane, the
// special function unit's exp2 alone (`exp2_sfu`). The walk computes each
// a once per forward step and keeps it for the adjoint step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace scan_lanes {

constexpr int kMaxDstate = 16;
constexpr int kLanes = 4;                        // lanes a channel
constexpr int kStates = kMaxDstate / kLanes;     // states a lane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChannels = kThreads / kLanes;     // channels a unit
constexpr int kPiece = 4;        // steps whose states are held in registers
// a piece's start (kStates floats a lane) fills the warp's kPiece rows of
// the reduction tile exactly, which is where `adjoint_walk` keeps it
static_assert(kPiece == kStates, "piece starts live in the reduction tile");
constexpr int kMaxSteps = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 2^x on the special function unit alone (`ex2.approx.ftz`: at most 2 ulp,
// as exp2f, but a decay below 2^-126 flushes to 0 where exp2f adds a
// range fix-up of three instructions); 2^0 is exactly 1, so a masked step
// (dt = 0) stays an exact identity.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// softplus as torch computes it (threshold 20) and its derivative
// sigmoid(x) = e / (1 + e), from one exponential e = exp(x).
__device__ __forceinline__ float2 softplus_and_grad(float x) {
  if (x > 20.f) return make_float2(x, 1.f);
  const float e = expf(x);
  return make_float2(log1pf(e), e / (1.f + e));
}

// The sum over the 4 lanes of a channel's group.
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One stage of the transposing butterfly: lanes that differ in bit kMask
// swap halves of their first 2 kHalf values and add.
template <int kMask, int kHalf, int N>
__device__ __forceinline__ void butterfly_stage(float (&v)[N], int lane) {
  const bool upper = lane & kMask;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
  }
}

// v: the lane's dB (4 states) then dC (4 states). Returns the sum over the
// warp's 8 channels of v[lane >> 2] of the lanes of this lane's quarter
// (v is clobbered): value k = lane >> 2 is dB (k < 4) or dC of state
// 4 (lane & 3) + (k & 3).
__device__ __forceinline__ float channel_sum(float (&v)[8], int lane) {
  butterfly_stage<16, 4>(v, lane);
  butterfly_stage<8, 2>(v, lane);
  butterfly_stage<4, 1>(v, lane);
  return v[0];
}

// The slot (of 32: dB states 0-15, then dC) of channel_sum's result.
__device__ __forceinline__ int reduction_slot(int lane) {
  const int k = lane >> 2;
  return (k >> 2) * kMaxDstate + (lane & 3) * kStates + (k & 3);
}

// kBytes from global to shared memory, of which the first src_bytes are
// read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where a unit's data lies in device memory. The channel tensors (u, dt, z,
// g and the outputs du, ddt, dz) are (rows, seqlen, dim); B and C (rows,
// seqlen, ngroups, dstate). Walk step i of the unit is time t(i) =
// reverse ? seqlen - 1 - (i0 + i) : i0 + i.
struct UnitPlace {
  int64_t row;
  int i0;          // the unit's first walk step
  int nsteps;      // its steps (<= S)
  int ch0;         // its first channel
  int valid;       // its channels inside the group (<= kChannels)
  int group;       // B/C group
  int seqlen, dim, dstate, ngroups, reverse;

  __device__ __forceinline__ int time(int i) const {
    return reverse ? seqlen - 1 - (i0 + i) : i0 + i;
  }
  __device__ __forceinline__ int64_t chan_row(int i) const {
    return (row * seqlen + time(i)) * dim + ch0;
  }
  __device__ __forceinline__ int64_t bc_row(int i) const {
    return ((row * seqlen + time(i)) * ngroups + group) * dstate;
  }
};

// Shared memory of one block: the raw buffer of the I/O type T, the fp32
// working tiles, the output tile and the reduction tile (which holds the
// piece starts too), each offset a multiple of 16 bytes (S is a multiple of
// kPiece).
template <typename T>
struct Layout {
  __host__ __device__ static int raw_elems(int S) {
    return S * (4 * kChannels + 2 * kMaxDstate);
  }
  __host__ __device__ static size_t bytes(int S) {
    return sizeof(T) * raw_elems(S)                              // raw
           + sizeof(float) * S * (5 * kChannels + 2 * kMaxDstate)  // working
           + sizeof(T) * 3 * S * kChannels                       // outputs
           + sizeof(float) * kWarps * S * 32;                    // reduction
  }
};

// Pointers into the block's shared memory for a tile of S steps (no array
// member: one indexed at run time would put the whole struct in local
// memory and turn every shared access into a generic one).
template <typename T>
struct Tiles {
  T* raw;          // u, dt, z, g [S][32], then B, C [S][16]
  float *u, *dt, *sg, *gy, *dzf, *B, *C;   // working, fp32
  T *du, *ddt, *dz;                        // outputs [S][32]
  float* red;                              // [kWarps][S][32]
  int S;

  __device__ Tiles(void* smem, int S_) : S(S_) {
    raw = static_cast<T*>(smem);
    float* w = reinterpret_cast<float*>(raw + Layout<T>::raw_elems(S));
    u = w;
    dt = u + S * kChannels;
    sg = dt + S * kChannels;
    gy = sg + S * kChannels;
    dzf = gy + S * kChannels;
    B = dzf + S * kChannels;
    C = B + S * kMaxDstate;
    du = reinterpret_cast<T*>(C + S * kMaxDstate);
    ddt = du + S * kChannels;
    dz = ddt + S * kChannels;
    red = reinterpret_cast<float*>(dz + S * kChannels);
  }

  // Where the lane keeps the start of piece pc: a float4 in its warp's
  // rows pc kPiece .. of the reduction tile, which the adjoint step writes
  // only after it has read the start.
  __device__ float4* piece_start(int pc, int warp, int lane) const {
    return reinterpret_cast<float4*>(
        red + (warp * S + pc * kPiece + lane / 8) * 32 + (lane % 8) * 4);
  }
};

// One (S x 32) channel tile of `src` into `dst` (nothing without src):
// 16-byte cp.async copies with kVec (the caller commits them), else
// element copies; zeros at rows >= nsteps and channels >= valid.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_channels(T* dst, int S,
                                               const UnitPlace& q,
                                               const T* src) {
  if (!src) return;
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);             // elements a copy
    constexpr int kRowCopies = kChannels / kPer;
    for (int idx = threadIdx.x; idx < S * kRowCopies; idx += kThreads) {
      const int i = idx / kRowCopies;
      const int c = (idx - i * kRowCopies) * kPer;
      const int n = i < q.nsteps ? max(0, min(kPer, q.valid - c)) : 0;
      cp_async16(dst + i * kChannels + c, n ? src + q.chan_row(i) + c : src,
                 n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int idx = threadIdx.x; idx < S * kChannels; idx += kThreads) {
      const int i = idx / kChannels;
      const int c = idx - i * kChannels;
      dst[idx] = i < q.nsteps && c < q.valid ? src[q.chan_row(i) + c]
                                             : from_float<T>(0.f);
    }
  }
}

// One (S x 16) B or C tile, as `stage_channels`; zeros at states >=
// dstate.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_states(T* dst, int S,
                                             const UnitPlace& q,
                                             const T* src) {
  if (!src) return;
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    const int copies = (q.dstate * static_cast<int>(sizeof(T)) + 15) / 16;
    for (int idx = threadIdx.x; idx < S * copies; idx += kThreads) {
      const int i = idx / copies;
      const int k = (idx - i * copies) * kPer;
      const int n = i < q.nsteps ? max(0, min(kPer, q.dstate - k)) : 0;
      cp_async16(dst + i * kMaxDstate + k, n ? src + q.bc_row(i) + k : src,
                 n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int idx = threadIdx.x; idx < S * kMaxDstate; idx += kThreads) {
      const int i = idx / kMaxDstate;
      const int k = idx - i * kMaxDstate;
      dst[idx] = i < q.nsteps && k < q.dstate ? src[q.bc_row(i) + k]
                                              : from_float<T>(0.f);
    }
  }
}

// Stage one unit's inputs into `raw`: u, dt, z, g, then B, C (kLocal: K4's
// local pass, which needs no u and no B).
template <typename T, bool kVec, bool kLocal>
__device__ __forceinline__ void stage(T* raw, int S, const UnitPlace& q,
                                      const T* u, const T* dt, const T* z,
                                      const T* g, const T* B, const T* C) {
  const int tile = S * kChannels;
  if constexpr (!kLocal) stage_channels<T, kVec>(raw, S, q, u);
  stage_channels<T, kVec>(raw + tile, S, q, dt);
  stage_channels<T, kVec>(raw + 2 * tile, S, q, z);
  stage_channels<T, kVec>(raw + 3 * tile, S, q, g);
  if constexpr (!kLocal) stage_states<T, kVec>(raw + 4 * tile, S, q, B);
  stage_states<T, kVec>(raw + 4 * tile + S * kMaxDstate, S, q, C);
}

// The fp32 working tiles from a staged raw buffer (see the note at the
// top). bias: the unit's 32 channels' dt bias (null: 0).
template <typename T, bool kLocal>
__device__ __forceinline__ void prep(const Tiles<T>& w, const T* raw,
                                     const UnitPlace& q, const float* bias,
                                     bool has_z, bool softplus_dt) {
  const int S = w.S;
  const int c = threadIdx.x % kChannels;   // the thread's channel in every row
  const float bc = bias && c < q.valid ? bias[c] : 0.f;
  for (int e = threadIdx.x; e < S * kChannels; e += kThreads) {
    const int i = e / kChannels;
    const bool on = i < q.nsteps && c < q.valid;
    const float x = to_float(raw[S * kChannels + e]) + bc;
    float g = to_float(raw[3 * S * kChannels + e]);
    float f = 0.f;
    if (has_z) {
      const float zv = to_float(raw[2 * S * kChannels + e]);
      const float s = sigmoid(zv);
      const float silu = zv * s;
      f = g * (s + silu * (1.f - s));
      g *= silu;
    }
    const float2 sp = softplus_dt ? softplus_and_grad(x) : make_float2(x, 1.f);
    w.dt[e] = on ? sp.x : 0.f;
    w.gy[e] = on ? g : 0.f;
    if constexpr (!kLocal) {
      w.u[e] = on ? to_float(raw[e]) : 0.f;
      w.sg[e] = on ? sp.y : 0.f;
      w.dzf[e] = on ? f : 0.f;
    }
  }
  const T* rbc = raw + 4 * S * kChannels;
  for (int e = threadIdx.x; e < 2 * S * kMaxDstate; e += kThreads) {
    const int which = e / (S * kMaxDstate);
    if (kLocal && which == 0) continue;
    const int rem = e - which * S * kMaxDstate;
    const int i = rem / kMaxDstate;
    const int k = rem - i * kMaxDstate;
    const float v =
        i < q.nsteps && k < q.dstate ? to_float(rbc[e]) : 0.f;
    (which ? w.C : w.B)[rem] = v;
  }
}

// The working tiles of the forward pass of an adjoint that carries its
// unit starts (K6), from a unit staged with u, dt and B only (`stage` with
// null z, g and C): dt, u and B as `prep` computes them, so the forward
// pass and the adjoint's recompute walk the same values.
template <typename T>
__device__ __forceinline__ void prep_forward(const Tiles<T>& w, const T* raw,
                                             const UnitPlace& q,
                                             const float* bias,
                                             bool softplus_dt) {
  const int S = w.S;
  const int c = threadIdx.x % kChannels;
  const float bc = bias && c < q.valid ? bias[c] : 0.f;
  for (int e = threadIdx.x; e < S * kChannels; e += kThreads) {
    const bool on = e / kChannels < q.nsteps && c < q.valid;
    const float x = to_float(raw[S * kChannels + e]) + bc;
    w.dt[e] = on ? (softplus_dt ? softplus_and_grad(x).x : x) : 0.f;
    w.u[e] = on ? to_float(raw[e]) : 0.f;
  }
  const T* rb = raw + 4 * S * kChannels;
  for (int e = threadIdx.x; e < S * kMaxDstate; e += kThreads) {
    const int k = e % kMaxDstate;
    w.B[e] = e / kMaxDstate < q.nsteps && k < q.dstate ? to_float(rb[e])
                                                       : 0.f;
  }
}

// What one lane walks: its channel's 4 states of A, as A2 = A log2(e), D,
// and the running sums the walk adds to.
struct Lane {
  int lane, warp, cw, quarter;   // cw: the channel in the unit (0..31)
  float A2[kStates];
  float D;
  float dA[kStates];
  float dD, dbias;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The lane's 4 states h walked forward over piece pc (its kPiece rows) of
// a prepared tile: h_t = exp2(dt_t A') h_{t-1} + dt_t u_t B_t.
template <typename T>
__device__ __forceinline__ void forward_piece(const Tiles<T>& w, int pc,
                                              const Lane& L,
                                              float (&h)[kStates]) {
  const int q4 = L.quarter * kStates;
#pragma unroll
  for (int j = 0; j < kPiece; ++j) {
    const int i = pc * kPiece + j;
    const float dt = w.dt[i * kChannels + L.cw];
    const float dtu = dt * w.u[i * kChannels + L.cw];
    const float4 b = ld4(w.B + i * kMaxDstate + q4);
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      h[k] = exp2_sfu(dt * L.A2[k]) * h[k] + dtu * at(b, k);
    }
  }
}

// The adjoint walk of one unit for the lane's 4 states, from the state h
// before the unit's first step and the adjoint dh that enters after its
// last (both in and out: dh leaves as the adjoint before the first step).
// Per (step, channel), with a_t = exp(dt_t A) and h_t = a_t h_{t-1} +
// dt_t u_t B_t:
//
//     dz_t  = dzf_t y_t,   y_t = sum_n C_t h_t + D u_t      (with z)
//     dh   += C_t gy_t
//     dB_t  = sum_ch dh dt_t u_t,   dC_t = sum_ch gy_t h_t
//     dA   += dh h_{t-1} a_t dt_t
//     ddt_t = (sum_n dh h_{t-1} a_t A + u_t sum_n dh B_t) sg_t
//     du_t  = dt_t sum_n dh B_t + gy_t D,   dD += gy_t u_t,  dbias += ddt_t
//     dh   *= a_t
//
// The unit is walked forward once from h, its piece starts kept in shared
// memory (`Tiles::piece_start`), except the last piece's; then its pieces of kPiece steps, last
// first: each is walked forward from its start with h_t and a_t kept in
// registers (h_{t-1} is never rebuilt as (h_t - dt u B) / a_t, which fails
// where a_t underflows to 0), and the adjoint step runs over them. So a
// unit of S steps takes S + (S - kPiece) forward steps (1.75 a step at S
// 16), and each state update one exponential per forward step. Pieces of
// 8 steps (1.5 a step) held 64 registers of states and decays, spilled
// under the 128-register bound and ran slower on an H100.
template <typename T>
__device__ __forceinline__ void adjoint_walk(const Tiles<T>& w, int nsteps,
                                             Lane& L,
                                             float (&h)[kStates],
                                             float (&dh)[kStates]) {
  const int cw = L.cw;
  const int q4 = L.quarter * kStates;
  const int npieces = (nsteps + kPiece - 1) / kPiece;
  const int slot = reduction_slot(L.lane);

  // forward through every piece but the last, keeping the piece starts
  for (int pc = 0; pc + 1 < npieces; ++pc) {
    *w.piece_start(pc, L.warp, L.lane) = make_float4(h[0], h[1], h[2], h[3]);
    forward_piece(w, pc, L, h);
  }

  for (int pc = npieces - 1; pc >= 0; --pc) {
    float hp[kStates];                 // the state before the piece
    if (pc + 1 < npieces) {
      const float4 s = *w.piece_start(pc, L.warp, L.lane);
      hp[0] = s.x;
      hp[1] = s.y;
      hp[2] = s.z;
      hp[3] = s.w;
    } else {
#pragma unroll
      for (int k = 0; k < kStates; ++k) hp[k] = h[k];
    }
    float hs[kPiece][kStates];
    float as[kPiece][kStates];
#pragma unroll
    for (int j = 0; j < kPiece; ++j) {
      const int i = pc * kPiece + j;   // rows up to S exist: identities
      const float dt = w.dt[i * kChannels + cw];
      const float dtu = dt * w.u[i * kChannels + cw];
      const float4 b = ld4(w.B + i * kMaxDstate + q4);
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        as[j][k] = exp2_sfu(dt * L.A2[k]);
        hs[j][k] = as[j][k] * (j ? hs[j - 1][k] : hp[k]) + dtu * at(b, k);
      }
    }

#pragma unroll
    for (int j = kPiece - 1; j >= 0; --j) {
      const int i = pc * kPiece + j;   // rows up to S exist: identities
      const int e = i * kChannels + cw;
      const float uv = w.u[e];
      const float dt = w.dt[e];
      const float gy = w.gy[e];
      const float dtu = dt * uv;
      const float4 b = ld4(w.B + i * kMaxDstate + q4);
      const float4 c = ld4(w.C + i * kMaxDstate + q4);
      // the 4 lanes of a channel hold its sums alike and store alike
      float y = 0.f;
#pragma unroll
      for (int k = 0; k < kStates; ++k) y += at(c, k) * hs[j][k];
      y = group_sum(y) + L.D * uv;
      w.dz[e] = from_float<T>(w.dzf[e] * y);   // 0 without z
      float v[8];
      float s_ha = 0.f;   // sum_n dh h_{t-1} a A log2(e)
      float s_hb = 0.f;   // sum_n dh B
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        dh[k] += at(c, k) * gy;
        v[k] = dh[k] * dtu;
        v[kStates + k] = gy * hs[j][k];
        const float el = dh[k] * (j ? hs[j - 1][k] : hp[k]) * as[j][k];
        L.dA[k] += el * dt;
        s_ha += el * L.A2[k];
        s_hb += dh[k] * at(b, k);
        dh[k] *= as[j][k];
      }
      s_ha = group_sum(s_ha) * kLn2;
      s_hb = group_sum(s_hb);
      const float ddt = (s_ha + s_hb * uv) * w.sg[e];
      L.dD += gy * uv;
      L.dbias += ddt;
      w.du[e] = from_float<T>(s_hb * dt + gy * L.D);
      w.ddt[e] = from_float<T>(ddt);
      w.red[(L.warp * w.S + i) * 32 + slot] = channel_sum(v, L.lane);
    }
  }
}

// One output tile to device memory: rows < nsteps, channels < valid;
// 16-byte stores with kVec (nothing without dst).
template <typename T, bool kVec>
__device__ __forceinline__ void store_channels(T* dst, const T* tile, int S,
                                               const UnitPlace& q) {
  if (!dst) return;
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kRowCopies = kChannels / kPer;
    for (int idx = threadIdx.x; idx < S * kRowCopies; idx += kThreads) {
      const int i = idx / kRowCopies;
      const int c = (idx - i * kRowCopies) * kPer;
      if (i >= q.nsteps || c >= q.valid) continue;
      *reinterpret_cast<uint4*>(dst + q.chan_row(i) + c) =
          *reinterpret_cast<const uint4*>(tile + i * kChannels + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < S * kChannels; idx += kThreads) {
      const int i = idx / kChannels;
      const int c = idx - i * kChannels;
      if (i < q.nsteps && c < q.valid) dst[q.chan_row(i) + c] = tile[idx];
    }
  }
}

// The unit's output tiles (du, ddt, dz) to device memory.
template <typename T, bool kVec>
__device__ __forceinline__ void store_outputs(const Tiles<T>& w,
                                              const UnitPlace& q, T* du,
                                              T* ddt, T* dz) {
  store_channels<T, kVec>(du, w.du, w.S, q);
  store_channels<T, kVec>(ddt, w.ddt, w.S, q);
  store_channels<T, kVec>(dz, w.dz, w.S, q);
}

// Sum of the reduction tile over the block's warps at element e (step
// e / 32, slot e % 32).
__device__ __forceinline__ float warp_total(const float* red, int S, int e) {
  float s = 0.f;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) s += red[wi * S * 32 + e];
  return s;
}

// Whether 16-byte copies may stage and store a launch's tensors: every
// pointer (null ones too) on a 16-byte boundary, and every channel
// tensor's rows (dim), tiles (a group's width) and every B/C step (dstate)
// a multiple of 16 bytes (K3, K4, K7, K8).
inline bool vec_ok(std::initializer_list<const void*> ptrs, int dim,
                   int width, int dstate, int esize) {
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % 16) return false;
  }
  return (static_cast<int64_t>(dim) * esize) % 16 == 0 &&
         (static_cast<int64_t>(width) * esize) % 16 == 0 &&
         (dstate * esize) % 16 == 0;
}

// Where a block of a chunked adjoint's walking kernels works (K4's and K8's
// local and main passes): block (row, block of kChunks chunks, group,
// tile), and the channel of the lane whose channel in the unit is cw. The
// kernels' parameter structs (P) share the field names used here.
struct ChunkBlock {
  UnitPlace q;
  int cg, tile, c_first, c_last;
  int ch;        // the lane's channel (clamped into the group)
  bool active;   // the lane's channel lies inside the group
};

template <int kChunks, typename P>
__device__ __forceinline__ ChunkBlock chunk_block(const P& p, int cw) {
  ChunkBlock b;
  const int nwt = p.ngroups * p.tiles;
  const int wt = blockIdx.x % nwt;
  const int64_t rc = blockIdx.x / nwt;
  b.cg = static_cast<int>(rc % p.ncgroups);
  b.tile = wt % p.tiles;
  b.q.row = rc / p.ncgroups;
  b.q.group = wt / p.tiles;
  b.q.ch0 = b.q.group * p.width + b.tile * kChannels;
  b.q.valid = min(kChannels, p.width - b.tile * kChannels);
  b.q.seqlen = p.seqlen;
  b.q.dim = p.dim;
  b.q.dstate = p.dstate;
  b.q.ngroups = p.ngroups;
  b.q.reverse = p.reverse;
  b.c_first = b.cg * kChunks;
  b.c_last = min(p.nchunks, b.c_first + kChunks);
  b.active = cw < b.q.valid;
  b.ch = b.q.ch0 + min(cw, b.q.valid - 1);
  return b;
}

// Chunk c's walk steps: p.chunk from c p.chunk, the last one ragged.
template <typename P>
__device__ __forceinline__ void set_chunk(UnitPlace& q, const P& p, int c) {
  q.i0 = c * p.chunk;
  q.nsteps = min(p.chunk, p.seqlen - q.i0);
}

}  // namespace scan_lanes
