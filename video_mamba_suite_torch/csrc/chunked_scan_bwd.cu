// Chunked selective scan, backward, one direction, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_bwd_kernel` and `_bwd_kernel_hs` (its form for
// batch <= 4) in video_mamba_suite_tpu/ops/selective_scan_pallas.py,
// launched from `_scan_core_bwd` (the VJP of `_scan_core`; the anti-causal
// direction reaches it through flips in `_rev_core_bwd`). It is the adjoint
// of chunked_scan_fwd.cu, computed from that kernel's checkpoints: the state
// before every `chunk`-th step of the walk. Per (row, channel), walking
// t = 0..L-1, or L-1..0 when `reverse`, with dt_t = softplus(dt_t + bias),
// a_t = exp(dt_t * A), h_t = a_t * h_{t-1} + dt_t * u_t * B_t,
// y_t = sum_n C_t * h_t + D * u_t and out_t = y_t * silu(z_t), and with the
// cotangents g_t of the output and g_last of the last state:
//
//     dz_t  = g_t * y_t * (s + silu * (1 - s))      (s = sigmoid(z_t))
//     gy_t  = g_t * silu(z_t)
//     dh_t  = C_t * gy_t + a_{t+1} * dh_{t+1}       (the walk backwards;
//                                                    the last step adds g_last)
//     dC_t  = sum_d gy_t * h_t,   dB_t = sum_d dh_t * dt_t * u_t
//     dA   += dh_t * h_{t-1} * a_t * dt_t
//     ddt_t = (sum_n dh_t * h_{t-1} * a_t * A + u_t * sum_n dh_t * B_t)
//             * sigmoid(dt_t + bias)                (with softplus)
//     du_t  = dt_t * sum_n dh_t * B_t + gy_t * D,   dD = sum gy_t * u_t
//     dbias = sum ddt_t,   dh0 = a_first * dh_first
//
// dB and dC go to the group d / (dim / G) of their channel.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores), at ViViM-T's shape (batch 8, seqlen 3152, dim 384, dstate
// 16, fp32 I/O, a checkpoint every 16 steps): it reads u, dt, z and g and
// writes du, ddt and dz, seven (b, l, d) tensors of 38.7 MB, reads the
// 38.7 MB of checkpoints and 3.2 MB of B and C and writes 3.2 MB of dB and
// dC: about 316 MB, 94 us. The arithmetic (a forward recompute and the
// adjoint step, about 18 operations per state update) is about 2.8 GFLOP,
// 42 us; its exponentials go to the special function units (16 results a
// clock an SM), 155 M of them a pass, about 42 us a pass. So the bytes
// bound it; the partials below add about 50 MB.
//
// Design. There are only 8 x 384 recurrences, each 3152 steps long, so the
// walk is split in time at the checkpoints. Three kernels, in order on the
// stream:
//   local:   each chunk walked backwards from a zero adjoint; leaves the
//            adjoint that leaves the chunk at its first step (E) and the
//            chunk's sum of dt;
//   combine: one thread per (row, channel, state) chains the chunks from
//            the walk's end, M <- exp(A * sum dt) * M + E, starting from
//            g_last (the decay of a chunk is exactly exp(A * sum dt)), and
//            leaves each chunk's exact incoming adjoint; after the first
//            chunk M is dh0. The chain is serial, so it loads kCombineBatch
//            chunks' values at once (one memory latency per batch);
//   main:    each chunk walked backwards again from that adjoint and its
//            checkpoint (scan_lanes.cuh's `adjoint_walk`: the chunk walked
//            forward once with its pieces' starts in shared memory, then
//            each 4-step piece again with its states and decays in
//            registers for the adjoint step), writing du, ddt, dz and the
//            partials.
// The local and main passes run scan_lanes.cuh's units: one block of 128
// threads takes 32 channels of one group and row, 4 lanes a channel (4
// states a lane), and walks kChunksPerBlock chunks one after the other,
// each chunk's u, dt, z, g, B and C staged in shared memory by cp.async
// while the block walks the chunk before it. Exponentials per state
// update: 1 in the local pass, 1.75 in the main one (its forward walks).
// The note in scan_lanes.cuh has the rest.
// Reductions without atomics, so the result does not depend on the order
// in which blocks run: dB and dC are summed over the unit's 32 channels
// and written as one fp32 partial per 32-channel tile; dA, dD and dbias are
// summed in each lane's registers over the block's chunks and written as
// one fp32 partial per (row, block of chunks). The wrapper adds the
// partials with torch.sum. Channels past the group's width load zeros and
// store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_lanes.cuh"

namespace {

using namespace scan_lanes;

constexpr int kChunksPerBlock = 8;  // chunks a block of the walking kernels
constexpr int kMaxChunk = 64;
constexpr int kCombineThreads = 256;
constexpr int kCombineBatch = 16;  // chunks the combine loads at once

struct Params {
  const void* u;        // (batch, seqlen, dim)
  const void* dt;       // (batch, seqlen, dim), before bias and softplus
  const void* z;        // (batch, seqlen, dim) or null
  const void* B;        // (batch, seqlen, ngroups, dstate)
  const void* C;        // (batch, seqlen, ngroups, dstate)
  const float* A;       // (dim, dstate)
  const float* D;       // (dim,) or null
  const float* bias;    // (dim,) or null
  const float* states;  // (batch, nchunks, dim, dstate) checkpoints
  const void* g;        // (batch, seqlen, dim), cotangent of the output
  const float* glast;   // (batch, dim, dstate) or null (zeros)
  void* du;             // (batch, seqlen, dim)
  void* ddt;            // (batch, seqlen, dim)
  void* dz;             // (batch, seqlen, dim) or null (with z)
  float* dA;            // (batch * ncgroups, dim, dstate) partials
  float* dB;            // (tiles, batch, seqlen, ngroups, dstate) partials
  float* dC;            // (tiles, batch, seqlen, ngroups, dstate) partials
  float* dD;            // (batch * ncgroups, dim) partials or null
  float* dbias;         // (batch * ncgroups, dim) partials or null
  float* dh0;           // (batch, dim, dstate)
  float* carry;         // (batch, nchunks, dim, dstate): E, then M
  float* dtsum;         // (batch, nchunks, dim)
  int64_t batch;
  int seqlen, dim, dstate, ngroups;
  int chunk;     // walk steps per chunk (between checkpoints)
  int S;         // chunk rounded up to kPiece: the rows of a unit's tiles
  int nchunks;   // ceil(seqlen / chunk)
  int width;     // channels per group
  int tiles;     // 32-channel tiles per group
  int ncgroups;  // blocks of kChunksPerBlock chunks per row
  int reverse, softplus;
};

// Where a block of the walking kernels works (scan_lanes.cuh's
// `chunk_block`) and what its lane walks: lane -> (channel, quarter of its
// states).
__device__ __forceinline__ ChunkBlock place(const Params& p, Lane& L) {
  L.lane = threadIdx.x & 31;
  L.warp = threadIdx.x >> 5;
  L.cw = L.warp * (32 / kLanes) + L.lane / kLanes;
  L.quarter = L.lane % kLanes;
  const ChunkBlock b = chunk_block<kChunksPerBlock>(p, L.cw);
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const int n = L.quarter * kStates + k;
    L.A2[k] = b.active && n < p.dstate ? p.A[b.ch * p.dstate + n] * kLog2e
                                       : 0.f;
    L.dA[k] = 0.f;
  }
  L.D = b.active && p.D ? p.D[b.ch] : 0.f;
  L.dD = 0.f;
  L.dbias = 0.f;
  return b;
}

// Pass "local": each chunk's outgoing adjoint from a zero incoming one,
// and its sum of dt.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    chunked_scan_bwd_local_lanes(Params p) {
  extern __shared__ float4 smem4[];
  const Tiles<T> w(smem4, p.S);
  Lane L;
  ChunkBlock b = place(p, L);
  if (b.c_first >= b.c_last) return;  // the whole block
  const T* dtp = static_cast<const T*>(p.dt);
  const T* zp = static_cast<const T*>(p.z);
  const T* gp = static_cast<const T*>(p.g);
  const T* Cp = static_cast<const T*>(p.C);
  const float* bias = p.bias ? p.bias + b.q.ch0 : nullptr;
  const int q4 = L.quarter * kStates;

  UnitPlace next = b.q;
  set_chunk(next, p, b.c_first);
  stage<T, kVec, true>(w.raw, p.S, next, nullptr, dtp, zp, gp, nullptr, Cp);
  cp_async_commit();
  for (int c = b.c_first; c < b.c_last; ++c) {
    set_chunk(b.q, p, c);
    cp_async_wait_all();
    __syncthreads();  // this chunk's tiles are in; the last walk is done
    prep<T, true>(w, w.raw, b.q, bias, zp != nullptr, p.softplus);
    __syncthreads();  // the raw tiles are read: the next chunk's copy
    if (c + 1 < b.c_last) {
      set_chunk(next, p, c + 1);
      stage<T, kVec, true>(w.raw, p.S, next, nullptr, dtp, zp, gp, nullptr,
                           Cp);
      cp_async_commit();
    }

    // every row of the tile, last first (rows past the chunk are
    // identities), kPiece at a time with no branch
    float dh[kStates] = {0.f, 0.f, 0.f, 0.f};
    float dtsum = 0.f;
    for (int i0 = p.S - kPiece; i0 >= 0; i0 -= kPiece) {
#pragma unroll
      for (int j = kPiece - 1; j >= 0; --j) {
        const int i = i0 + j;
        const float gy = w.gy[i * kChannels + L.cw];
        const float dt = w.dt[i * kChannels + L.cw];
        const float4 cv = ld4(w.C + i * kMaxDstate + q4);
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          dh[k] = (dh[k] + at(cv, k) * gy) * exp2_sfu(dt * L.A2[k]);
        }
        dtsum += dt;
      }
    }
    if (b.active) {
      const int64_t cidx = (b.q.row * p.nchunks + c) * p.dim + b.ch;
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        if (q4 + k < p.dstate) p.carry[cidx * p.dstate + q4 + k] = dh[k];
      }
      if (L.quarter == 0) p.dtsum[cidx] = dtsum;
    }
  }
}

// Pass "combine": each chunk's exact incoming adjoint, and dh0.
__global__ void __launch_bounds__(kCombineThreads)
    chunked_scan_bwd_combine(Params p, int64_t total) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (idx >= total) return;
  const int k = static_cast<int>(idx % p.dstate);
  const int ch = static_cast<int>((idx / p.dstate) % p.dim);
  const int64_t row = idx / (static_cast<int64_t>(p.dim) * p.dstate);
  const float a = p.A[ch * p.dstate + k];
  float mu = p.glast ? p.glast[idx] : 0.f;
  // the chain is serial, so each batch's loads are issued together: one
  // memory latency per kCombineBatch chunks, not one per chunk
  for (int c0 = p.nchunks - 1; c0 >= 0; c0 -= kCombineBatch) {
    float e[kCombineBatch];
    float s[kCombineBatch];
#pragma unroll
    for (int j = 0; j < kCombineBatch; ++j) {
      const int64_t cidx = (row * p.nchunks + max(c0 - j, 0)) * p.dim + ch;
      e[j] = c0 - j >= 0 ? p.carry[cidx * p.dstate + k] : 0.f;
      s[j] = c0 - j >= 0 ? p.dtsum[cidx] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCombineBatch; ++j) {
      if (c0 - j >= 0) {
        const int64_t cidx = (row * p.nchunks + c0 - j) * p.dim + ch;
        p.carry[cidx * p.dstate + k] = mu;
        mu = expf(a * s[j]) * mu + e[j];
      }
    }
  }
  p.dh0[idx] = mu;
}

// Pass "main": the adjoint walk with the exact incoming adjoint. Five
// blocks an SM (96 registers a thread; its shared memory allows five at
// fp32) ran faster on an H100 than four at 128 registers, for a spill of
// 4 bytes; six (80 registers) spilled more and ran slower.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 5)
    chunked_scan_bwd_main_lanes(Params p) {
  extern __shared__ float4 smem4[];
  const Tiles<T> w(smem4, p.S);
  Lane L;
  ChunkBlock b = place(p, L);
  if (b.c_first >= b.c_last) return;  // the whole block
  const T* up = static_cast<const T*>(p.u);
  const T* dtp = static_cast<const T*>(p.dt);
  const T* zp = static_cast<const T*>(p.z);
  const T* gp = static_cast<const T*>(p.g);
  const T* Bp = static_cast<const T*>(p.B);
  const T* Cp = static_cast<const T*>(p.C);
  const float* bias = p.bias ? p.bias + b.q.ch0 : nullptr;
  const int q4 = L.quarter * kStates;
  // this tile's dB and dC partials of the row start at part_row * ngroups
  const int64_t part_row = (b.tile * p.batch + b.q.row) * p.seqlen;

  UnitPlace next = b.q;
  set_chunk(next, p, b.c_first);
  stage<T, kVec, false>(w.raw, p.S, next, up, dtp, zp, gp, Bp, Cp);
  cp_async_commit();
  for (int c = b.c_first; c < b.c_last; ++c) {
    set_chunk(b.q, p, c);
    // the chunk's checkpoint and incoming adjoint, loaded while the tiles
    // are prepared
    const int64_t cidx = (b.q.row * p.nchunks + c) * p.dim + b.ch;
    float h[kStates], dh[kStates];
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      const bool on = b.active && q4 + k < p.dstate;
      h[k] = on ? p.states[cidx * p.dstate + q4 + k] : 0.f;
      dh[k] = on ? p.carry[cidx * p.dstate + q4 + k] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();  // this chunk's tiles are in; the last unit is out
    prep<T, false>(w, w.raw, b.q, bias, zp != nullptr, p.softplus);
    __syncthreads();  // the raw tiles are read: the next chunk's copy
    if (c + 1 < b.c_last) {
      set_chunk(next, p, c + 1);
      stage<T, kVec, false>(w.raw, p.S, next, up, dtp, zp, gp, Bp, Cp);
      cp_async_commit();
    }

    adjoint_walk<T>(w, b.q.nsteps, L, h, dh);
    __syncthreads();

    store_outputs<T, kVec>(w, b.q, static_cast<T*>(p.du),
                           static_cast<T*>(p.ddt), static_cast<T*>(p.dz));
    for (int e = threadIdx.x; e < b.q.nsteps * 32; e += kThreads) {
      const int n = e % kMaxDstate;
      if (n >= p.dstate) continue;
      const int64_t o =
          ((part_row + b.q.time(e / 32)) * p.ngroups + b.q.group) *
              p.dstate + n;
      ((e % 32) < kMaxDstate ? p.dB : p.dC)[o] = warp_total(w.red, p.S, e);
    }
  }

  if (b.active) {
    const int64_t prow = (b.q.row * p.ncgroups + b.cg) * p.dim + b.ch;
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
int launch_walks(const Params& p, long long batch, cudaStream_t s) {
  const long long walk_blocks =
      batch * p.ncgroups * static_cast<long long>(p.ngroups) * p.tiles;
  const int64_t total = static_cast<int64_t>(batch) * p.dim * p.dstate;
  const long long combine_blocks =
      (total + kCombineThreads - 1) / kCombineThreads;
  if (walk_blocks > 0x7fffffffLL || combine_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(Layout<T>::bytes(p.S));
  cudaError_t err = cudaFuncSetAttribute(
      chunked_scan_bwd_local_lanes<T, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(chunked_scan_bwd_main_lanes<T, kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(walk_blocks));
  chunked_scan_bwd_local_lanes<T, kVec><<<grid, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunked_scan_bwd_combine<<<static_cast<unsigned>(combine_blocks),
                             kCombineThreads, 0, s>>>(p, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunked_scan_bwd_main_lanes<T, kVec><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, long long batch, cudaStream_t s) {
  const bool vec = vec_ok({p.u, p.dt, p.z, p.B, p.C, p.g, p.du, p.ddt, p.dz},
                          p.dim, p.width, p.dstate, sizeof(T));
  return vec ? launch_walks<T, true>(p, batch, s)
             : launch_walks<T, false>(p, batch, s);
}

}  // namespace

extern "C" {

// Launches the backward of one direction on `stream`. dtype: 0 float32,
// 1 bfloat16 (u, dt, z, B, C, g, du, ddt and dz share it; A, D, bias,
// states, glast, dh0, every partial and the scratch are float32). `chunk`
// is the forward's checkpoint interval (a multiple of 4, at most 64) and
// `states` its checkpoints, (batch, ceil(seqlen / chunk), dim, dstate).
// Partials: dA (batch * ceil(nchunks / 8), dim, dstate), dD and dbias
// (batch * ceil(nchunks / 8), dim), dB and dC (ceil(dim / ngroups / 32),
// batch, seqlen, ngroups, dstate). Scratch: carry (batch, nchunks, dim,
// dstate), dtsum (batch, nchunks, dim). z, D, bias and glast may be null;
// dz is read only with z, dD only with D, dbias only with bias. Returns
// the cudaError_t of the launches (0 on success).
int chunked_scan_bwd(int dtype, long long batch, int seqlen, int dim,
                     int dstate, int ngroups, int reverse, int softplus,
                     int chunk, const void* u, const void* dt, const void* z,
                     const void* B, const void* C, const void* A,
                     const void* D, const void* bias, const void* states,
                     const void* g, const void* glast, void* du, void* ddt,
                     void* dz, void* dA, void* dB, void* dC, void* dD,
                     void* dbias, void* dh0, void* carry, void* dtsum,
                     void* stream) {
  if (batch < 1 || seqlen < 1 || dim < 1 || dstate < 1 ||
      dstate > kMaxDstate || ngroups < 1 || dim % ngroups != 0 ||
      chunk < 4 || chunk > kMaxChunk || chunk % 4 != 0 ||
      (dtype != 0 && dtype != 1)) {
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
  p.states = static_cast<const float*>(states);
  p.g = g;
  p.glast = static_cast<const float*>(glast);
  p.du = du;
  p.ddt = ddt;
  p.dz = z ? dz : nullptr;
  p.dA = static_cast<float*>(dA);
  p.dB = static_cast<float*>(dB);
  p.dC = static_cast<float*>(dC);
  p.dD = D ? static_cast<float*>(dD) : nullptr;
  p.dbias = bias ? static_cast<float*>(dbias) : nullptr;
  p.dh0 = static_cast<float*>(dh0);
  p.carry = static_cast<float*>(carry);
  p.dtsum = static_cast<float*>(dtsum);
  p.batch = batch;
  p.seqlen = seqlen;
  p.dim = dim;
  p.dstate = dstate;
  p.ngroups = ngroups;
  p.chunk = chunk;
  p.S = (chunk + kPiece - 1) / kPiece * kPiece;
  p.nchunks = (seqlen + chunk - 1) / chunk;
  p.width = dim / ngroups;
  p.tiles = (p.width + kChannels - 1) / kChannels;
  p.ncgroups = (p.nchunks + kChunksPerBlock - 1) / kChunksPerBlock;
  p.reverse = reverse;
  p.softplus = softplus;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, batch, s);
  return launch<__nv_bfloat16>(p, batch, s);
}

const char* chunked_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
