// Short selective scan, backward, one direction, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_short_bwd_kernel` in
// video_mamba_suite_tpu/ops/selective_scan_pallas.py (launched from
// `_short_core_bwd`, the VJP of `_short_core`; the anti-causal form there
// goes through flips). It is the adjoint of short_scan_fwd.cu: one
// direction of a selective scan over at most 64 steps from a zero state.
// It takes the forward inputs and the cotangent g of the output and returns
// du, ddt, dz, dA, dB, dC, dD and dbias; the last state's cotangent is not
// an input, because the JAX package stops that state's gradient. Per (row,
// channel), walking t = 0..L-1 (or L-1..0 when `reverse`), with
// dt_t = softplus(dt_pre_t + bias) (softplus optional), a_t = exp(dt_t A),
// h_t = a_t h_prev + dt_t u_t B_t, y_t = sum_n C_t h_t + D u_t and
// out_t = y_t silu(z_t):
//
//     dz_t  = g_t * y_t * s(z_t) * (1 + z_t * (1 - s(z_t)))     (s: sigmoid)
//     gy_t  = g_t * silu(z_t)                      (g_t without z)
//     dh   += C_t * gy_t                  (reverse walk, last step first)
//     dC_t  = sum_d gy_t * h_t,   dB_t = sum_d dh * dt_t * u_t
//     dA   += dh * h_prev * a_t * dt_t,   ddt_t = sum_n dh * h_prev * a_t * A
//                                                 + u_t * sum_n dh * B_t
//     du_t  = dt_t * sum_n dh * B_t + gy_t * D,   dD = sum gy_t * u_t
//     dh   *= a_t
//     ddt_t *= softplus'(dt_pre_t + bias),   dbias = sum ddt_t
//
// Channel d reads B and C of group d / (dim / G); dB and dC are summed over
// each group's channels.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores), at the short-memory anticipation train step's shape
// (batch 16, seqlen 64, dim 2048, dstate 16, fp32): it reads u, dt, z, g
// and writes du, ddt, dz, seven (b, l, d) fp32 tensors of 8.4 MB (59 MB,
// 0.018 ms), and does about 20 fp32 operations for each of 33.5 M state
// updates (0.67 GFLOP, 0.010 ms). So the bytes bound it; the walk's
// exponentials go to the special function units on top (16 results a clock
// an SM: 2.5 a state update below, 84 M, 0.020 ms). At TimeMamba-B's
// adapter shape (batch 1568, seqlen 16, dim 768, bf16) the bytes are 0.27
// GB (0.08 ms) and the operations 6.2 GFLOP (0.09 ms), so there the
// operations bound it.
//
// What the walk needs at that shape: a thread a (row, channel), holding
// its 16 states, would keep every thread's states every 4 of the 64 steps
// in shared memory (120 KB for 128 threads), so one block of 4 warps an
// SM, and would load u, dt, z and g inside its walks. So:
//
// Design: scan_lanes.cuh's units, as K2 and K4. A block of 128 threads
// takes 32 channels of one group (grid y: group and 32-channel tile) and a
// fixed set of rows (grid x: row group), a channel's 16 states over 4 lanes
// (4 a lane). A row's <= 64 steps are walked as units of at most kUnitSteps
// = 16 steps (shared memory 42 KB at fp32; 128 registers a thread, so 4
// blocks, 16 warps, an SM; at the anticipation shape 16 x 64 = 1024
// blocks):
//   forward: units 0 .. N-2, each staged (u, dt and B only), prepared and
//            walked forward (`forward_piece`); the state at each unit's
//            start is kept, one float4 a lane a unit in a 6 KB shared tile
//            (kept in registers instead, 12 more a thread at the
//            128-register bound of 4 blocks an SM, the kernel ran slower
//            on an H100);
//   adjoint: units N-1 .. 0, each staged again (its second read of u and
//            dt comes from L2), prepared (softplus and the gate once a
//            (step, channel)) and walked by `adjoint_walk` from its start
//            state, with dh carried from the unit after it: K4's main pass
//            with its checkpoints and carries computed inside the block.
// Every unit's copies are issued by 16-byte cp.async as soon as the unit
// before has read its staged tiles, so they overlap that unit's walk.
// Decays are exp2 on the special function unit (`exp2_sfu`): 2.5 a state
// update at 64 steps (the forward pass 0.75, `adjoint_walk` 1.75). du, ddt
// and dz leave through a shared tile as 16-byte stores. `reverse` maps
// walk step i to time L-1-i, so nothing is flipped. Reductions without
// atomics, so the result does not depend on the order in which blocks run:
// dB and dC are summed over the unit's 32 channels (a warp butterfly, then
// the 4 warps in shared memory) and written as one fp32 partial per
// (32-channel tile, row, step, group, state); dA, dD and dbias are summed
// in each lane's registers over the block's rows and written as one fp32
// partial per row group. The wrapper sums the partials with torch.sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_lanes.cuh"

namespace {

using namespace scan_lanes;

constexpr int kUnitSteps = 16;                      // walk steps a unit
constexpr int kMaxUnits = kMaxSteps / kUnitSteps;   // units a row
static_assert(kUnitSteps % kPiece == 0, "a unit is whole pieces");

struct Params {
  const void* u;      // (batch, seqlen, dim)
  const void* dt;     // (batch, seqlen, dim), before bias and softplus
  const void* z;      // (batch, seqlen, dim) or null
  const void* B;      // (batch, seqlen, ngroups, dstate)
  const void* C;      // (batch, seqlen, ngroups, dstate)
  const float* A;     // (dim, dstate)
  const float* D;     // (dim,) or null
  const float* bias;  // (dim,) or null
  const void* g;      // (batch, seqlen, dim), cotangent of the output
  void* du;           // (batch, seqlen, dim)
  void* ddt;          // (batch, seqlen, dim)
  void* dz;           // (batch, seqlen, dim), null without z
  float* dA;          // (row groups, dim, dstate) partials
  float* dB;          // (tiles, batch, seqlen, ngroups, dstate) partials
  float* dC;          // (tiles, batch, seqlen, ngroups, dstate) partials
  float* dD;          // (row groups, dim) partials, null without D
  float* dbias;       // (row groups, dim) partials, null without bias
  int batch, seqlen, dim, dstate, ngroups;
  int width;          // channels a group
  int tiles;          // 32-channel tiles a group
  int S;              // rows of a unit's tiles: the unit rounded to kPiece
  int nunits;         // units a row, ceil(seqlen / kUnitSteps)
  int reverse, softplus;
};

// Shared memory of a block: the units' tiles (scan_lanes.cuh's Layout),
// then the starts of units 1 .. N-1, [unit - 1][thread] float4 (unit 0
// starts at zero).
template <typename T>
size_t smem_bytes(int S) {
  return Layout<T>::bytes(S) + sizeof(float4) * (kMaxUnits - 1) * kThreads;
}

// The unit of the block's walk s, and whether the walk is the forward
// pass. A block walks, for each of its rows (blockIdx.x, + gridDim.x, ...),
// the forward pass over units 0 .. N-2, then the adjoint over units N-1 ..
// 0: 2N - 1 walks a row. Built from the parameters at each call, so that
// nothing of it stays live in registers across a walk.
__device__ __forceinline__ UnitPlace walk_place(const Params& p, int s,
                                                bool& forward) {
  const int per_row = 2 * p.nunits - 1;
  const int j = s % per_row;
  forward = j < p.nunits - 1;
  const int tile = blockIdx.y % p.tiles;
  UnitPlace q;
  q.row = blockIdx.x + static_cast<int64_t>(s / per_row) * gridDim.x;
  q.i0 = (forward ? j : per_row - 1 - j) * kUnitSteps;
  q.nsteps = min(kUnitSteps, p.seqlen - q.i0);
  q.group = blockIdx.y / p.tiles;
  q.ch0 = q.group * p.width + tile * kChannels;
  q.valid = min(kChannels, p.width - tile * kChannels);
  q.seqlen = p.seqlen;
  q.dim = p.dim;
  q.dstate = p.dstate;
  q.ngroups = p.ngroups;
  q.reverse = p.reverse;
  return q;
}

// Stage walk s's tiles: u, dt and B for the forward pass, everything for
// the adjoint.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_walk(const Params& p, T* raw, int s) {
  bool forward;
  const UnitPlace q = walk_place(p, s, forward);
  const T* none = nullptr;
  stage<T, kVec, false>(raw, p.S, q, static_cast<const T*>(p.u),
                        static_cast<const T*>(p.dt),
                        forward ? none : static_cast<const T*>(p.z),
                        forward ? none : static_cast<const T*>(p.g),
                        static_cast<const T*>(p.B),
                        forward ? none : static_cast<const T*>(p.C));
  cp_async_commit();
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    short_scan_bwd_lanes(Params p) {
  extern __shared__ float4 smem4[];
  const Tiles<T> w(smem4, p.S);
  float4* starts = reinterpret_cast<float4*>(
      reinterpret_cast<char*>(smem4) + Layout<T>::bytes(p.S)) + threadIdx.x;

  Lane L;
  L.lane = threadIdx.x & 31;
  L.warp = threadIdx.x >> 5;
  L.cw = L.warp * (32 / kLanes) + L.lane / kLanes;
  L.quarter = L.lane % kLanes;
  {
    bool forward;
    const UnitPlace q = walk_place(p, 0, forward);
    const bool active = L.cw < q.valid;
    const int ch = q.ch0 + min(L.cw, q.valid - 1);
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      const int n = L.quarter * kStates + k;
      L.A2[k] = active && n < p.dstate ? p.A[ch * p.dstate + n] * kLog2e
                                       : 0.f;
      L.dA[k] = 0.f;
    }
    L.D = active && p.D ? p.D[ch] : 0.f;
    L.dD = 0.f;
    L.dbias = 0.f;
  }

  const int rows = (p.batch - static_cast<int>(blockIdx.x) +
                    static_cast<int>(gridDim.x) - 1) / gridDim.x;
  const int nwalks = rows * (2 * p.nunits - 1);
  float h[kStates], dh[kStates];
  if (nwalks > 0) stage_walk<T, kVec>(p, w.raw, 0);
  for (int s = 0; s < nwalks; ++s) {
    bool forward;
    const UnitPlace q = walk_place(p, s, forward);
    const int unit = q.i0 / kUnitSteps;
    const float* bias = p.bias ? p.bias + q.ch0 : nullptr;
    cp_async_wait_all();
    __syncthreads();  // this unit's tiles are in; the last walk is done
    if (forward) {
      prep_forward<T>(w, w.raw, q, bias, p.softplus);
    } else {
      prep<T, false>(w, w.raw, q, bias, p.z != nullptr, p.softplus);
    }
    __syncthreads();  // the raw tiles are read: the next unit's copy
    if (s + 1 < nwalks) stage_walk<T, kVec>(p, w.raw, s + 1);

    if (forward) {
      if (unit == 0) {
#pragma unroll
        for (int k = 0; k < kStates; ++k) h[k] = 0.f;
      }
      for (int pc = 0; pc < p.S / kPiece; ++pc) forward_piece(w, pc, L, h);
      starts[unit * kThreads] = make_float4(h[0], h[1], h[2], h[3]);
      continue;
    }
    if (unit == p.nunits - 1) {   // the row's adjoint starts at its end
#pragma unroll
      for (int k = 0; k < kStates; ++k) dh[k] = 0.f;
    }
    const float4 h0 = unit ? starts[(unit - 1) * kThreads]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    h[0] = h0.x;
    h[1] = h0.y;
    h[2] = h0.z;
    h[3] = h0.w;
    adjoint_walk<T>(w, q.nsteps, L, h, dh);
    __syncthreads();  // the output and reduction tiles are complete

    store_outputs<T, kVec>(w, q, static_cast<T*>(p.du),
                           static_cast<T*>(p.ddt), static_cast<T*>(p.dz));
    // this unit's dB and dC over the tile's channels
    const int64_t part_row =
        (static_cast<int64_t>(blockIdx.y % p.tiles) * p.batch + q.row) *
        p.seqlen;
    for (int e = threadIdx.x; e < q.nsteps * 32; e += kThreads) {
      const int n = e % kMaxDstate;
      if (n >= p.dstate) continue;
      const int64_t off =
          ((part_row + q.time(e / 32)) * p.ngroups + q.group) * p.dstate + n;
      ((e % 32) < kMaxDstate ? p.dB : p.dC)[off] = warp_total(w.red, p.S, e);
    }
  }

  bool forward;
  const UnitPlace q = walk_place(p, 0, forward);
  if (L.cw < q.valid) {
    const int64_t prow =
        static_cast<int64_t>(blockIdx.x) * p.dim + q.ch0 + L.cw;
    const int q4 = L.quarter * kStates;
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      if (q4 + k < p.dstate) p.dA[prow * p.dstate + q4 + k] = L.dA[k];
    }
    if (L.quarter == 0) {
      if (p.dD) p.dD[prow] = L.dD;
      if (p.dbias) p.dbias[prow] = L.dbias;
    }
  }
}

template <typename T, bool kVec>
int launch_vec(const Params& p, int row_groups, cudaStream_t s) {
  const int smem = static_cast<int>(smem_bytes<T>(p.S));
  cudaError_t err = cudaFuncSetAttribute(
      short_scan_bwd_lanes<T, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(row_groups),
                  static_cast<unsigned>(p.ngroups * p.tiles));
  short_scan_bwd_lanes<T, kVec><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, int row_groups, cudaStream_t s) {
  const bool vec = vec_ok({p.u, p.dt, p.z, p.B, p.C, p.g, p.du, p.ddt, p.dz},
                          p.dim, p.width, p.dstate, sizeof(T));
  return vec ? launch_vec<T, true>(p, row_groups, s)
             : launch_vec<T, false>(p, row_groups, s);
}

}  // namespace

extern "C" {

// Launches one direction on `stream`. dtype: 0 float32, 1 bfloat16 (u, dt,
// z, B, C, g, du, ddt and dz share it; A, D, bias and every partial are
// float32). B and C are (batch, seqlen, ngroups, dstate) with dim divisible
// by ngroups. z and dz, D and dD, bias and dbias are null together.
// `row_groups` (1 <= row_groups <= batch) row groups each write one partial
// of dA, dD and dbias; every 32-channel tile of a group writes one partial
// of dB and dC, (tiles, batch, seqlen, ngroups, dstate), where tiles is
// ceil(dim / ngroups / 32). Returns the cudaError_t of the launch (0 on
// success).
int short_scan_bwd(int dtype, long long batch, int seqlen, int dim,
                   int dstate, int ngroups, int row_groups, int reverse,
                   int softplus, const void* u, const void* dt,
                   const void* z, const void* B, const void* C,
                   const void* A, const void* D, const void* bias,
                   const void* g, void* du, void* ddt, void* dz, void* dA,
                   void* dB, void* dC, void* dD, void* dbias, void* stream) {
  if (batch < 1 || batch > 0x7fffffffLL || seqlen < 1 ||
      seqlen > kMaxSteps || dim < 1 || dstate < 1 ||
      dstate > kMaxDstate || ngroups < 1 || dim % ngroups != 0 ||
      row_groups < 1 || row_groups > batch || (dtype != 0 && dtype != 1) ||
      !u || !dt || !B || !C || !A || !g || !du || !ddt || !dA || !dB ||
      !dC || (!z != !dz) || (!D != !dD) || (!bias != !dbias)) {
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
  p.g = g;
  p.du = du;
  p.ddt = ddt;
  p.dz = dz;
  p.dA = static_cast<float*>(dA);
  p.dB = static_cast<float*>(dB);
  p.dC = static_cast<float*>(dC);
  p.dD = static_cast<float*>(dD);
  p.dbias = static_cast<float*>(dbias);
  p.batch = static_cast<int>(batch);
  p.seqlen = seqlen;
  p.dim = dim;
  p.dstate = dstate;
  p.ngroups = ngroups;
  p.width = dim / ngroups;
  p.tiles = (p.width + kChannels - 1) / kChannels;
  p.nunits = (seqlen + kUnitSteps - 1) / kUnitSteps;
  p.S = p.nunits > 1 ? kUnitSteps : (seqlen + kPiece - 1) / kPiece * kPiece;
  p.reverse = reverse;
  p.softplus = softplus;
  if (static_cast<long long>(ngroups) * p.tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, row_groups, s);
  return launch<__nv_bfloat16>(p, row_groups, s);
}

const char* short_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
