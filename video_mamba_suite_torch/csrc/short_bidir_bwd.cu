// Fused bidirectional short selective scan, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_short_bidir_bwd_kernel` in
// video_mamba_suite_tpu/ops/selective_scan_pallas.py (launched from
// `_short_bidir_bwd_impl`, the VJP of `selective_scan_pallas_bidir`). It is
// the adjoint of short_bidir_fwd.cu: for both directions of a
// bidirectional mixer in one launch (direction f causal, direction b
// anti-causal, walked in place) it takes the forward inputs and the
// cotangents g of the two outputs and returns du, ddt, dA, dB, dC, dD, dz
// and dbias. Per (row, channel), with dt_t = softplus(dt_pre_t),
// a_t = exp(dt_t * A), h_t = a_t * h_{t-1} + dt_t * u_t * B_t,
// y_t = sum_n C_t * h_t + D * u_t and out_t = y_t * silu(z_t):
//
//     dz_t  = g_t * y_t * s(z_t) * (1 + z_t * (1 - s(z_t)))     (s: sigmoid)
//     gy_t  = g_t * silu(z_t)
//     dh   += C_t * gy_t                  (reverse walk, t = last .. first)
//     dC_t  = sum_d gy_t * h_t,   dB_t = sum_d dh * dt_t * u_t
//     dA   += dh * h_{t-1} * a_t * dt_t,  ddt_t = sum_n dh * h_{t-1} * a_t * A
//                                                + u_t * sum_n dh * B_t
//     du_t  = dt_t * sum_n dh * B_t + gy_t * D,   dD = sum gy_t * u_t
//     dh   *= a_t
//     ddt_t *= s(dt_pre_t),   dbias = sum ddt_t
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores), at TimeMamba-B's shape (batch 1568, seqlen 16, dim 768,
// dstate 16, bf16 I/O): it reads u, dt, z, g and writes du, ddt, dz, eight
// (b,l,d) bf16 tensors of 38.5 MB per direction (about 0.55 GB with B, C,
// dB, dC: 0.16 ms), and does about 20 fp32 operations for each of
// 2 x 308 M state updates (0.18 ms). So operations bound it; the
// exponentials go to the special function units (16 results a clock an
// SM) on top: 0.32 ms for the 1.75 a state update that the design below
// takes.
//
// Design: scan_lanes.cuh's units. A block of 128 threads takes 128
// channels of one direction (grid z) and a fixed set of rows (grid x), and
// walks each row's channels as 4 units of 32 channels, 4 lanes a channel (4
// states a lane). Each unit's u, dt, z and g (seqlen x 32) and its row's B
// and C are staged in shared memory by cp.async while the block walks the
// unit before it, widened to fp32 once (softplus and the gate computed once
// a (step, channel)), and walked by `adjoint_walk` from a zero state and a
// zero adjoint: forward once with its pieces' starts in shared memory;
// then each 4-step piece, last first, recomputed forward from its start
// with its states and decays in registers, and the adjoint over it. h_{t-1} is never rebuilt as
// (h_t - dt u B) / a_t, which blows up where a_t underflows. du, ddt and
// dz leave through a shared tile as 16-byte stores. dB and dC are sums
// over channels: per step the unit's 32 channels are summed by a warp
// butterfly and the 4 warps in shared memory, the 4 units of a row added
// in shared memory by the thread that owns the element, and the block
// writes one fp32 partial per (channel block, row, step, state). dA, dD
// and dbias are sums over rows: kept in shared memory per (unit, thread)
// over the block's rows and written as one fp32 partial per row group. The
// wrapper sums the partials with torch.sum, so the result does not depend
// on the order in which blocks run (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_lanes.cuh"

namespace {

using namespace scan_lanes;

constexpr int kMaxSeqlen = kMaxSteps;
constexpr int kUnits = 4;                          // units a channel block
constexpr int kBlockChannels = kUnits * kChannels;  // 128

struct Direction {
  const void* u;      // (batch, seqlen, dim)
  const void* dt;     // (batch, seqlen, dim), before bias and softplus
  const void* z;      // (batch, seqlen, dim) or null
  const void* B;      // (batch, seqlen, dstate)
  const void* C;      // (batch, seqlen, dstate)
  const float* A;     // (dim, dstate)
  const float* D;     // (dim,) or null
  const float* bias;  // (dim,) or null
  const void* g;      // (batch, seqlen, dim), cotangent of the output
  void* du;           // (batch, seqlen, dim)
  void* ddt;          // (batch, seqlen, dim)
  void* dz;           // (batch, seqlen, dim) or null (with z)
  float* dA;          // (groups, dim, dstate) partials
  float* dB;          // (channel blocks, batch, seqlen, dstate) partials
  float* dC;          // (channel blocks, batch, seqlen, dstate) partials
  float* dD;          // (groups, dim) partials
  float* dbias;       // (groups, dim) partials
};

// Both directions, read by the grid's z index (an array in the parameter
// space, not a struct copied by a runtime select).
struct Directions {
  Direction d[2];
};

// Shared memory past the units' tiles: a row's dB/dC sums over its units
// [S][32], and each thread's dA [kUnits][kThreads] (float4), dD and dbias
// [kUnits][32] over the block's rows.
template <typename T>
size_t smem_bytes(int S) {
  return Layout<T>::bytes(S) + sizeof(float) * S * 32 +
         sizeof(float4) * kUnits * kThreads +
         2 * sizeof(float) * kUnits * kChannels;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    short_bidir_bwd_lanes_kernel(Directions dirs, int batch, int seqlen,
                                 int dim, int dstate) {
  extern __shared__ float4 smem4[];
  const int S = (seqlen + kPiece - 1) / kPiece * kPiece;
  const Tiles<T> w(smem4, S);
  float* racc = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + Layout<T>::bytes(S));
  float4* sA = reinterpret_cast<float4*>(racc + S * 32);
  float* sD = reinterpret_cast<float*>(sA + kUnits * kThreads);
  float* sbias = sD + kUnits * kChannels;

  const bool reverse = blockIdx.z == 1;
  const Direction& p = dirs.d[blockIdx.z];
  const T* up = static_cast<const T*>(p.u);
  const T* dtp = static_cast<const T*>(p.dt);
  const T* zp = static_cast<const T*>(p.z);
  const T* gp = static_cast<const T*>(p.g);
  const T* Bp = static_cast<const T*>(p.B);
  const T* Cp = static_cast<const T*>(p.C);
  const int cb = blockIdx.y * kBlockChannels;

  Lane L;
  L.lane = threadIdx.x & 31;
  L.warp = threadIdx.x >> 5;
  L.cw = L.warp * (32 / kLanes) + L.lane / kLanes;
  L.quarter = L.lane % kLanes;
  const int q4 = L.quarter * kStates;
#pragma unroll
  for (int s = 0; s < kUnits; ++s) {
    sA[s * kThreads + threadIdx.x] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (L.quarter == 0) {
      sD[s * kChannels + L.cw] = 0.f;
      sbias[s * kChannels + L.cw] = 0.f;
    }
  }

  // the block's units: rows blockIdx.x, + gridDim.x, ..., 4 units a row
  const int rows = (batch - static_cast<int>(blockIdx.x) +
                    static_cast<int>(gridDim.x) - 1) / gridDim.x;
  const int nunits = rows * kUnits;
  auto unit = [&](int n) {
    UnitPlace q;
    q.row = blockIdx.x + static_cast<int64_t>(n / kUnits) * gridDim.x;
    q.i0 = 0;
    q.nsteps = seqlen;
    q.ch0 = cb + (n % kUnits) * kChannels;
    q.valid = max(0, min(kChannels, dim - q.ch0));
    q.group = 0;
    q.seqlen = seqlen;
    q.dim = dim;
    q.dstate = dstate;
    q.ngroups = 1;
    q.reverse = reverse;
    return q;
  };

  if (nunits > 0) {
    stage<T, kVec, false>(w.raw, S, unit(0), up, dtp, zp, gp, Bp, Cp);
    cp_async_commit();
  }
  for (int n = 0; n < nunits; ++n) {
    const UnitPlace q = unit(n);
    const int s = n % kUnits;
    // the lane's A and D, loaded while the tiles arrive
    const bool active = L.cw < q.valid;
    const int ch = q.ch0 + L.cw;
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      L.A2[k] = active && q4 + k < dstate
                    ? p.A[ch * dstate + q4 + k] * kLog2e : 0.f;
      L.dA[k] = 0.f;
    }
    L.D = active && p.D ? p.D[ch] : 0.f;
    L.dD = 0.f;
    L.dbias = 0.f;
    cp_async_wait_all();
    __syncthreads();  // this unit's tiles are in; the last unit is out
    prep<T, false>(w, w.raw, q, q.valid > 0 && p.bias ?
                   p.bias + q.ch0 : nullptr, zp != nullptr, true);
    __syncthreads();  // the raw tiles are read: the next unit's copy
    if (n + 1 < nunits) {
      stage<T, kVec, false>(w.raw, S, unit(n + 1), up, dtp, zp, gp, Bp, Cp);
      cp_async_commit();
    }

    float h[kStates] = {0.f, 0.f, 0.f, 0.f};
    float dh[kStates] = {0.f, 0.f, 0.f, 0.f};
    adjoint_walk<T>(w, seqlen, L, h, dh);
    float4& a = sA[s * kThreads + threadIdx.x];
    a = make_float4(a.x + L.dA[0], a.y + L.dA[1], a.z + L.dA[2],
                    a.w + L.dA[3]);
    if (L.quarter == 0) {
      sD[s * kChannels + L.cw] += L.dD;
      sbias[s * kChannels + L.cw] += L.dbias;
    }
    __syncthreads();

    store_outputs<T, kVec>(w, q, static_cast<T*>(p.du),
                           static_cast<T*>(p.ddt), static_cast<T*>(p.dz));
    // this row's dB and dC over the block's channels, each element summed
    // by the thread that owns it
    const int64_t part = (static_cast<int64_t>(blockIdx.y) * batch + q.row) *
                         seqlen * dstate;
    for (int e = threadIdx.x; e < seqlen * 32; e += kThreads) {
      const float v = (s ? racc[e] : 0.f) + warp_total(w.red, S, e);
      racc[e] = v;
      const int k = e % kMaxDstate;
      if (s == kUnits - 1 && k < dstate) {
        ((e % 32) < kMaxDstate ? p.dB : p.dC)[part + q.time(e / 32) *
                                                         dstate + k] = v;
      }
    }
  }

  // dA, dD and dbias of the block's rows (the thread's own slots)
  for (int s = 0; s < kUnits; ++s) {
    const int ch = cb + s * kChannels + L.cw;
    if (ch >= dim) continue;
    const int64_t prow = static_cast<int64_t>(blockIdx.x) * dim + ch;
    const float4 a = sA[s * kThreads + threadIdx.x];
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      if (q4 + k < dstate) p.dA[prow * dstate + q4 + k] = at(a, k);
    }
    if (L.quarter == 0) {
      p.dD[prow] = sD[s * kChannels + L.cw];
      p.dbias[prow] = sbias[s * kChannels + L.cw];
    }
  }
}

// 16-byte copies need every channel tensor's rows and B/C steps on
// 16-byte boundaries.
bool vec_ok(const Direction& d, int dim, int dstate, int esize) {
  const void* ptrs[] = {d.u, d.dt, d.z, d.B, d.C, d.g, d.du, d.ddt, d.dz};
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % 16) return false;
  }
  return (dim * esize) % 16 == 0 && (dstate * esize) % 16 == 0;
}

template <typename T, bool kVec>
int launch_vec(const Direction& f, const Direction& b, long long batch,
               int seqlen, int dim, int dstate, int groups, cudaStream_t s) {
  const int S = (seqlen + kPiece - 1) / kPiece * kPiece;
  const size_t smem = smem_bytes<T>(S);
  cudaError_t err = cudaFuncSetAttribute(
      short_bidir_bwd_lanes_kernel<T, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(groups),
                  static_cast<unsigned>((dim + kBlockChannels - 1) /
                                        kBlockChannels),
                  2);
  short_bidir_bwd_lanes_kernel<T, kVec><<<grid, kThreads, smem, s>>>(
      Directions{{f, b}}, static_cast<int>(batch), seqlen, dim, dstate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Direction& f, const Direction& b, long long batch,
           int seqlen, int dim, int dstate, int groups, cudaStream_t s) {
  const int esize = sizeof(T);
  if (vec_ok(f, dim, dstate, esize) && vec_ok(b, dim, dstate, esize)) {
    return launch_vec<T, true>(f, b, batch, seqlen, dim, dstate, groups, s);
  }
  return launch_vec<T, false>(f, b, batch, seqlen, dim, dstate, groups, s);
}

}  // namespace

extern "C" {

// Launches both directions on `stream`. dtype: 0 float32, 1 bfloat16 (u,
// dt, z, B, C, g, du, ddt and dz share it; A, D, bias and every partial are
// float32). `groups` row groups (1 <= groups <= batch) each write one
// partial of dA, dD and dbias; dB and dC have one partial per 128
// channels. Returns the cudaError_t of the launch (0 on success).
int short_bidir_bwd(int dtype, long long batch, int seqlen, int dim,
                    int dstate, int groups,
                    const void* uf, const void* dtf, const void* zf,
                    const void* Bf, const void* Cf, const void* Af,
                    const void* Df, const void* biasf, const void* gf,
                    const void* ub, const void* dtb, const void* zb,
                    const void* Bb, const void* Cb, const void* Ab,
                    const void* Db, const void* biasb, const void* gb,
                    void* duf, void* ddtf, void* dzf, void* dAf, void* dBf,
                    void* dCf, void* dDf, void* dbiasf,
                    void* dub, void* ddtb, void* dzb, void* dAb, void* dBb,
                    void* dCb, void* dDb, void* dbiasb, void* stream) {
  if (batch < 1 || batch > 0x7fffffffLL || seqlen < 1 ||
      seqlen > kMaxSeqlen || dim < 1 || dstate < 1 || dstate > kMaxDstate ||
      groups < 1 || groups > batch ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Direction f{uf, dtf, zf, Bf, Cf, static_cast<const float*>(Af),
                    static_cast<const float*>(Df),
                    static_cast<const float*>(biasf), gf, duf, ddtf,
                    zf ? dzf : nullptr,
                    static_cast<float*>(dAf), static_cast<float*>(dBf),
                    static_cast<float*>(dCf), static_cast<float*>(dDf),
                    static_cast<float*>(dbiasf)};
  const Direction b{ub, dtb, zb, Bb, Cb, static_cast<const float*>(Ab),
                    static_cast<const float*>(Db),
                    static_cast<const float*>(biasb), gb, dub, ddtb,
                    zb ? dzb : nullptr,
                    static_cast<float*>(dAb), static_cast<float*>(dBb),
                    static_cast<float*>(dCb), static_cast<float*>(dDb),
                    static_cast<float*>(dbiasb)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(f, b, batch, seqlen, dim, dstate, groups, s);
  }
  return launch<__nv_bfloat16>(f, b, batch, seqlen, dim, dstate, groups, s);
}

const char* short_bidir_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
