// Selective scan with complex A, backward, for Hopper (sm_90a): kernel K8.
//
// Replaces the TPU kernel `_cbwd_kernel` in
// video_mamba_suite_tpu/ops/selective_scan_pallas.py, launched from
// `_complex_core_bwd` (the VJP of `_complex_core`). It is the adjoint of
// complex_scan_fwd.cu (K7), computed from K7's checkpoints: the two-channel
// state before every `chunk`-th step of the walk. Per (row, channel), with
// a_t = car + i cai = exp(dt_t Ar) (cos(dt_t Ai) + i sin(dt_t Ai)), the
// cotangent g_t of the output and (glastr, glasti) of the last state,
// walking the steps backwards:
//
//     dz_t  = g_t * y_t * (s + silu * (1 - s))     (s = sigmoid(z_t))
//     gy_t  = g_t * silu(z_t)
//     dhr  += 2 C_t gy_t                           (y reads the real channel)
//     dcar  = dhr hr_{t-1} + dhi hi_{t-1},  dcai = dhi hr_{t-1} - dhr hi_{t-1}
//     dmag  = dcar car + dcai cai,          dang = dcai car - dcar cai
//     dAr  += dmag dt_t,                    dAi += dang dt_t
//     dC_t  = sum_d 2 gy_t hr_t,            dB_t = sum_d dhr dt_t u_t
//     ddt_t = (sum_n dmag Ar + dang Ai + u_t sum_n dhr B_t)
//             * sigmoid(dt_t + bias)        (with softplus)
//     du_t  = dt_t sum_n dhr B_t + gy_t D,  dD = sum gy_t u_t, dbias = sum ddt
//     (dhr, dhi) <- conj(a_t) (dhr, dhi)    (dh_{t-1} = conj(a_t) dh_t)
//
// and (dh0r, dh0i) is the adjoint left after the first step. dB and dC go
// to the group d / (dim / G) of their channel.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 outside the
// tensor cores; the special function unit 16 results a clock an SM), at the
// scan microbench shape (batch 8, L 2048, dim 1024, dstate 16, fp32 I/O, a
// checkpoint every 16 steps): it reads u, dt, z and g and writes du, ddt
// and dz, seven tensors of 67 MB, and reads 2 x 67 MB of checkpoints: about
// 610 MB, 182 us. Its 268 M complex state updates take some 55 fp32
// operations each (14.8 GFLOP, 220 us) and, as designed below, 8.25
// special-function results each (3 a decay; the local pass one decay a
// update, the main pass 1.75), 2.2 G results, 0.53 ms. So the special
// function unit sets the floor.
//
// Design: K4's (chunked_scan_bwd.cu) on two real channels. The walk is
// split in time at the checkpoints; three kernels, in order on the stream:
//   local:   each chunk walked backwards from a zero adjoint; leaves the
//            adjoint that leaves the chunk at its first step (E) and the
//            chunk's sum of dt. The adjoint needs dt, z, g and C, not the
//            states;
//   combine: one thread per (row, channel, state) chains the chunks from
//            the walk's end, M <- conj(a_chunk) M + E, starting from
//            (glastr, glasti); a_chunk = exp(A sum dt) exactly (the a_t of
//            a channel commute), its rotation by the accurate sincosf. It
//            leaves each chunk's exact incoming adjoint; after the first
//            chunk M is (dh0r, dh0i). The chain is serial, so it loads
//            kCombineBatch chunks' values at once;
//   main:    each chunk walked again from its checkpoint with that adjoint:
//            forward once with its 4-step pieces' starts in shared memory,
//            then each piece again with its states and decays in registers
//            for the adjoint step (scan_lanes.cuh's `adjoint_walk` scheme),
//            so no state array sits in local memory and no decay of a step
//            is computed twice in one walk; h_{t-1} is never rebuilt by
//            dividing by a_t, which fails where a_t underflows.
// The local and main passes run scan_lanes.cuh's units: one block of 128
// threads takes 32 channels of one group and row, 4 lanes a channel (4
// complex states a lane), and walks kChunksPerBlock chunks one after the
// other, each chunk's u, dt, z, g, B and C staged in shared memory by
// cp.async while the block walks the chunk before it, and prepared once a
// (step, channel): softplus and its derivative, g silu(z) and the gate's
// factor for dz. Reductions without atomics, so the result does not depend
// on the order in which blocks run: dB and dC are summed over the unit's
// 32 channels after the unit and written as one fp32 partial per
// 32-channel tile; dAr, dAi, dD and dbias are summed in each lane's
// registers over the block's chunks and written as one fp32 partial per
// (row, block of chunks). The wrapper adds the partials with torch.sum.
// Channels past the group's width load zeros and store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "complex_scan.cuh"
#include "scan_lanes.cuh"

namespace {

using namespace scan_lanes;
using complex_scan::span_decay;
using complex_scan::step_decay;

constexpr int kChunksPerBlock = 8;  // chunks a block of the walking kernels
constexpr int kMaxChunk = 16;
constexpr int kMaxPieces = kMaxChunk / kPiece;
constexpr int kCombineThreads = 256;
constexpr int kCombineBatch = 8;   // chunks the combine loads at once

struct Params {
  const void* u;         // (batch, seqlen, dim)
  const void* dt;        // (batch, seqlen, dim), before bias and softplus
  const void* z;         // (batch, seqlen, dim) or null
  const void* B;         // (batch, seqlen, ngroups, dstate)
  const void* C;         // (batch, seqlen, ngroups, dstate)
  const float* Ar;       // (dim, dstate)
  const float* Ai;       // (dim, dstate)
  const float* D;        // (dim,) or null
  const float* bias;     // (dim,) or null
  const float* statesr;  // (batch, nchunks, dim, dstate) checkpoints
  const float* statesi;
  const void* g;         // (batch, seqlen, dim), cotangent of the output
  const float* glastr;   // (batch, dim, dstate) or null (zeros)
  const float* glasti;
  void* du;              // (batch, seqlen, dim)
  void* ddt;             // (batch, seqlen, dim)
  void* dz;              // (batch, seqlen, dim) or null (with z)
  float* dAr;            // (batch * ncgroups, dim, dstate) partials
  float* dAi;
  float* dB;             // (tiles, batch, seqlen, ngroups, dstate) partials
  float* dC;
  float* dD;             // (batch * ncgroups, dim) partials or null
  float* dbias;          // (batch * ncgroups, dim) partials or null
  float* dh0r;           // (batch, dim, dstate)
  float* dh0i;
  float* carryr;         // (batch, nchunks, dim, dstate): E, then M
  float* carryi;
  float* dtsum;          // (batch, nchunks, dim)
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

// What one lane walks: its channel's 4 complex states of A as Ar log2(e)
// and Ai, D, and the running sums the walk adds to.
struct CLane {
  int lane, warp, cw, quarter;   // cw: the channel in the unit (0..31)
  float Ar2[kStates];
  float Ai[kStates];
  float D;
  float dAr[kStates];
  float dAi[kStates];
  float dD, dbias;
};

// Where a block of the walking kernels works (scan_lanes.cuh's
// `chunk_block`) and what its lane walks: lane -> (channel, quarter of its
// states).
__device__ __forceinline__ ChunkBlock place(const Params& p, CLane& L) {
  L.lane = threadIdx.x & 31;
  L.warp = threadIdx.x >> 5;
  L.cw = L.warp * (32 / kLanes) + L.lane / kLanes;
  L.quarter = L.lane % kLanes;
  const ChunkBlock b = chunk_block<kChunksPerBlock>(p, L.cw);
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const int n = L.quarter * kStates + k;
    const bool on = b.active && n < p.dstate;
    L.Ar2[k] = on ? p.Ar[b.ch * p.dstate + n] * kLog2e : 0.f;
    L.Ai[k] = on ? p.Ai[b.ch * p.dstate + n] : 0.f;
    L.dAr[k] = 0.f;
    L.dAi[k] = 0.f;
  }
  L.D = b.active && p.D ? p.D[b.ch] : 0.f;
  L.dD = 0.f;
  L.dbias = 0.f;
  return b;
}

// Pass "local": each chunk's outgoing adjoint from a zero incoming one,
// and its sum of dt. It holds little state: six blocks an SM (80
// registers a thread, no spill).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 6)
    complex_scan_bwd_local_lanes(Params p) {
  extern __shared__ float4 smem4[];
  const Tiles<T> w(smem4, p.S);
  CLane L;
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
    float dr[kStates] = {0.f, 0.f, 0.f, 0.f};
    float di[kStates] = {0.f, 0.f, 0.f, 0.f};
    float dtsum = 0.f;
    for (int i0 = p.S - kPiece; i0 >= 0; i0 -= kPiece) {
#pragma unroll
      for (int j = kPiece - 1; j >= 0; --j) {
        const int i = i0 + j;
        const float gy2 = 2.f * w.gy[i * kChannels + L.cw];
        const float dt = w.dt[i * kChannels + L.cw];
        const float4 cv = ld4(w.C + i * kMaxDstate + q4);
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          float car, cai;
          step_decay(dt, L.Ar2[k], L.Ai[k], car, cai);
          const float r = fmaf(at(cv, k), gy2, dr[k]);
          dr[k] = fmaf(car, r, cai * di[k]);
          di[k] = fmaf(car, di[k], -cai * r);
        }
        dtsum += dt;
      }
    }
    if (b.active) {
      const int64_t cidx = (b.q.row * p.nchunks + c) * p.dim + b.ch;
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        if (q4 + k < p.dstate) {
          p.carryr[cidx * p.dstate + q4 + k] = dr[k];
          p.carryi[cidx * p.dstate + q4 + k] = di[k];
        }
      }
      if (L.quarter == 0) p.dtsum[cidx] = dtsum;
    }
  }
}

// Pass "combine": each chunk's exact incoming adjoint, and dh0.
__global__ void __launch_bounds__(kCombineThreads)
    complex_scan_bwd_combine(Params p, int64_t total) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (idx >= total) return;
  const int k = static_cast<int>(idx % p.dstate);
  const int ch = static_cast<int>((idx / p.dstate) % p.dim);
  const int64_t row = idx / (static_cast<int64_t>(p.dim) * p.dstate);
  const float ar2 = p.Ar[ch * p.dstate + k] * kLog2e;
  const float ai = p.Ai[ch * p.dstate + k];
  float mr = p.glastr ? p.glastr[idx] : 0.f;
  float mi = p.glasti ? p.glasti[idx] : 0.f;
  // the chain is serial, so each batch's loads are issued together: one
  // memory latency per kCombineBatch chunks, not one per chunk
  for (int c0 = p.nchunks - 1; c0 >= 0; c0 -= kCombineBatch) {
    float er[kCombineBatch], ei[kCombineBatch], s[kCombineBatch];
#pragma unroll
    for (int j = 0; j < kCombineBatch; ++j) {
      const int64_t cidx = (row * p.nchunks + max(c0 - j, 0)) * p.dim + ch;
      const bool on = c0 - j >= 0;
      er[j] = on ? p.carryr[cidx * p.dstate + k] : 0.f;
      ei[j] = on ? p.carryi[cidx * p.dstate + k] : 0.f;
      s[j] = on ? p.dtsum[cidx] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCombineBatch; ++j) {
      if (c0 - j >= 0) {
        const int64_t cidx = (row * p.nchunks + c0 - j) * p.dim + ch;
        p.carryr[cidx * p.dstate + k] = mr;
        p.carryi[cidx * p.dstate + k] = mi;
        float car, cai;
        span_decay(s[j], ar2, ai, car, cai);
        const float nr = fmaf(car, mr, fmaf(cai, mi, er[j]));
        mi = fmaf(car, mi, fmaf(-cai, mr, ei[j]));
        mr = nr;
      }
    }
  }
  p.dh0r[idx] = mr;
  p.dh0i[idx] = mi;
}

// Where the lane keeps the start of piece pc of its walk (real part, then
// imaginary): 2 (kMaxPieces - 1) float4 a thread after the block's tiles,
// laid out thread-fastest (no bank conflict).
__device__ __forceinline__ float4* piece_start(float4* starts, int pc,
                                               int part) {
  return starts + (2 * pc + part) * kThreads + threadIdx.x;
}

// The adjoint walk of one chunk for the lane's 4 complex states, from the
// state (hr, hi) before the chunk's first step and the adjoint (dr, di)
// that enters after its last (both in and out: the adjoint leaves as the
// one before the first step). The chunk is walked forward once from h, its
// piece starts kept in shared memory (`piece_start`) except the last
// piece's; then its pieces of kPiece steps, last first: each is walked
// forward from its start with h_t and a_t kept in registers, and the
// adjoint step (see the note at the top) runs over them. So a chunk of S
// steps takes S + (S - kPiece) forward steps (1.75 a step at S 16) and
// each step's decay once in each of them.
template <typename T>
__device__ __forceinline__ void adjoint_walk(const Tiles<T>& w,
                                             float4* starts, int nsteps,
                                             CLane& L, float (&hr)[kStates],
                                             float (&hi)[kStates],
                                             float (&dr)[kStates],
                                             float (&di)[kStates]) {
  const int cw = L.cw;
  const int q4 = L.quarter * kStates;
  const int npieces = (nsteps + kPiece - 1) / kPiece;
  const int slot = reduction_slot(L.lane);

  // forward through every piece but the last, keeping the piece starts
  for (int pc = 0; pc + 1 < npieces; ++pc) {
    *piece_start(starts, pc, 0) = make_float4(hr[0], hr[1], hr[2], hr[3]);
    *piece_start(starts, pc, 1) = make_float4(hi[0], hi[1], hi[2], hi[3]);
#pragma unroll
    for (int j = 0; j < kPiece; ++j) {
      const int i = pc * kPiece + j;
      const float dt = w.dt[i * kChannels + cw];
      const float dtu = dt * w.u[i * kChannels + cw];
      const float4 b = ld4(w.B + i * kMaxDstate + q4);
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        float car, cai;
        step_decay(dt, L.Ar2[k], L.Ai[k], car, cai);
        const float nr = fmaf(car, hr[k], fmaf(-cai, hi[k], dtu * at(b, k)));
        hi[k] = fmaf(cai, hr[k], car * hi[k]);
        hr[k] = nr;
      }
    }
  }

  for (int pc = npieces - 1; pc >= 0; --pc) {
    float pr[kStates], pi[kStates];   // the state before the piece
    if (pc + 1 < npieces) {
      const float4 sr = *piece_start(starts, pc, 0);
      const float4 si = *piece_start(starts, pc, 1);
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        pr[k] = at(sr, k);
        pi[k] = at(si, k);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        pr[k] = hr[k];
        pi[k] = hi[k];
      }
    }
    float hsr[kPiece][kStates], hsi[kPiece][kStates];
    float asr[kPiece][kStates], asi[kPiece][kStates];
#pragma unroll
    for (int j = 0; j < kPiece; ++j) {
      const int i = pc * kPiece + j;   // rows up to S exist: identities
      const float dt = w.dt[i * kChannels + cw];
      const float dtu = dt * w.u[i * kChannels + cw];
      const float4 b = ld4(w.B + i * kMaxDstate + q4);
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        step_decay(dt, L.Ar2[k], L.Ai[k], asr[j][k], asi[j][k]);
        const float xr = j ? hsr[j - 1][k] : pr[k];
        const float xi = j ? hsi[j - 1][k] : pi[k];
        hsr[j][k] = fmaf(asr[j][k], xr, fmaf(-asi[j][k], xi, dtu * at(b, k)));
        hsi[j][k] = fmaf(asi[j][k], xr, asr[j][k] * xi);
      }
    }

#pragma unroll
    for (int j = kPiece - 1; j >= 0; --j) {
      const int i = pc * kPiece + j;   // rows up to S exist: identities
      const int e = i * kChannels + cw;
      const float uv = w.u[e];
      const float dt = w.dt[e];
      const float gy = w.gy[e];
      const float gy2 = 2.f * gy;
      const float dtu = dt * uv;
      const float4 b = ld4(w.B + i * kMaxDstate + q4);
      const float4 c = ld4(w.C + i * kMaxDstate + q4);
      // the 4 lanes of a channel hold its sums alike and store alike
      float y = 0.f;
#pragma unroll
      for (int k = 0; k < kStates; ++k) y = fmaf(at(c, k), hsr[j][k], y);
      y = fmaf(2.f, group_sum(y), L.D * uv);
      w.dz[e] = from_float<T>(w.dzf[e] * y);   // 0 without z
      float v[8];
      float s_ar = 0.f;   // sum_n dmag Ar log2(e)
      float s_ai = 0.f;   // sum_n dang Ai
      float s_hb = 0.f;   // sum_n dhr B
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        dr[k] = fmaf(at(c, k), gy2, dr[k]);
        v[k] = dr[k] * dtu;
        v[kStates + k] = gy2 * hsr[j][k];
        const float xr = j ? hsr[j - 1][k] : pr[k];
        const float xi = j ? hsi[j - 1][k] : pi[k];
        const float dcar = fmaf(dr[k], xr, di[k] * xi);
        const float dcai = fmaf(di[k], xr, -dr[k] * xi);
        const float dmag = fmaf(dcar, asr[j][k], dcai * asi[j][k]);
        const float dang = fmaf(dcai, asr[j][k], -dcar * asi[j][k]);
        L.dAr[k] = fmaf(dmag, dt, L.dAr[k]);
        L.dAi[k] = fmaf(dang, dt, L.dAi[k]);
        s_ar = fmaf(dmag, L.Ar2[k], s_ar);
        s_ai = fmaf(dang, L.Ai[k], s_ai);
        s_hb = fmaf(dr[k], at(b, k), s_hb);
        const float nr = fmaf(asr[j][k], dr[k], asi[j][k] * di[k]);
        di[k] = fmaf(asr[j][k], di[k], -asi[j][k] * dr[k]);
        dr[k] = nr;
      }
      const float s_a = group_sum(fmaf(s_ar, kLn2, s_ai));
      s_hb = group_sum(s_hb);
      const float ddt = fmaf(s_hb, uv, s_a) * w.sg[e];
      L.dD = fmaf(gy, uv, L.dD);
      L.dbias += ddt;
      w.du[e] = from_float<T>(fmaf(s_hb, dt, gy * L.D));
      w.ddt[e] = from_float<T>(ddt);
      w.red[(L.warp * w.S + i) * 32 + slot] = channel_sum(v, L.lane);
    }
  }
}

// Pass "main": the adjoint walk with the exact incoming adjoint. Three
// blocks an SM: the piece's states and decays (64 floats) and the adjoint
// take 168 registers a thread with no spill; at four blocks (128
// registers) the walk spilled and ran slower on an H100, and so did two
// blocks an SM.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    complex_scan_bwd_main_lanes(Params p) {
  extern __shared__ float4 smem4[];
  const Tiles<T> w(smem4, p.S);
  float4* starts = smem4 + Layout<T>::bytes(p.S) / sizeof(float4);
  CLane L;
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
    const int64_t cidx = ((b.q.row * p.nchunks + c) * p.dim + b.ch) *
                         p.dstate + q4;
    float hr[kStates], hi[kStates], dr[kStates], di[kStates];
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      const bool on = b.active && q4 + k < p.dstate;
      hr[k] = on ? p.statesr[cidx + k] : 0.f;
      hi[k] = on ? p.statesi[cidx + k] : 0.f;
      dr[k] = on ? p.carryr[cidx + k] : 0.f;
      di[k] = on ? p.carryi[cidx + k] : 0.f;
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

    adjoint_walk<T>(w, starts, b.q.nsteps, L, hr, hi, dr, di);
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
      if (q4 + k < p.dstate) {
        p.dAr[prow * p.dstate + q4 + k] = L.dAr[k];
        p.dAi[prow * p.dstate + q4 + k] = L.dAi[k];
      }
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
  const int local_smem = static_cast<int>(Layout<T>::bytes(p.S));
  const int main_smem = local_smem + static_cast<int>(
      sizeof(float4) * 2 * (kMaxPieces - 1) * kThreads);
  cudaError_t err = cudaFuncSetAttribute(
      complex_scan_bwd_local_lanes<T, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, local_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(complex_scan_bwd_main_lanes<T, kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             main_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(walk_blocks));
  complex_scan_bwd_local_lanes<T, kVec><<<grid, kThreads, local_smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  complex_scan_bwd_combine<<<static_cast<unsigned>(combine_blocks),
                             kCombineThreads, 0, s>>>(p, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  complex_scan_bwd_main_lanes<T, kVec><<<grid, kThreads, main_smem, s>>>(p);
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

// Launches K8 on `stream`. dtype: 0 float32, 1 bfloat16 (u, dt, z, B, C, g,
// du, ddt and dz share it; everything else is float32). B and C are
// (batch, seqlen, ngroups, dstate) with dim divisible by ngroups; the
// checkpoints are K7's with the same `chunk` (1 to 16). z (with dz), D
// (with dD), bias (with dbias) and glastr/glasti (both or neither) may be
// null. Partials: dAr, dAi (batch * ceil(nchunks / 8), dim, dstate), dD
// and dbias (batch * ceil(nchunks / 8), dim), dB and dC
// (ceil(dim / ngroups / 32), batch, seqlen, ngroups, dstate). Scratch:
// carryr, carryi (batch, nchunks, dim, dstate), dtsum (batch, nchunks,
// dim). Returns the cudaError_t of the launches (0 on success).
int complex_scan_bwd(int dtype, long long batch, int seqlen, int dim,
                     int dstate, int ngroups, int reverse, int softplus,
                     int chunk, const void* u, const void* dt, const void* z,
                     const void* B, const void* C, const void* Ar,
                     const void* Ai, const void* D, const void* bias,
                     const void* statesr, const void* statesi, const void* g,
                     const void* glastr, const void* glasti, void* du,
                     void* ddt, void* dz, void* dAr, void* dAi, void* dB,
                     void* dC, void* dD, void* dbias, void* dh0r, void* dh0i,
                     void* carryr, void* carryi, void* dtsum, void* stream) {
  if (batch < 1 || seqlen < 1 || dim < 1 || dstate < 1 ||
      dstate > kMaxDstate || ngroups < 1 || dim % ngroups != 0 ||
      (dtype != 0 && dtype != 1) || chunk < 1 || chunk > kMaxChunk ||
      (!glastr) != (!glasti) || (!z) != (!dz) || (!D) != (!dD) ||
      (!bias) != (!dbias) || !statesr || !statesi || !g || !carryr ||
      !carryi || !dtsum) {
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
  p.statesr = static_cast<const float*>(statesr);
  p.statesi = static_cast<const float*>(statesi);
  p.g = g;
  p.glastr = static_cast<const float*>(glastr);
  p.glasti = static_cast<const float*>(glasti);
  p.du = du;
  p.ddt = ddt;
  p.dz = dz;
  p.dAr = static_cast<float*>(dAr);
  p.dAi = static_cast<float*>(dAi);
  p.dB = static_cast<float*>(dB);
  p.dC = static_cast<float*>(dC);
  p.dD = static_cast<float*>(dD);
  p.dbias = static_cast<float*>(dbias);
  p.dh0r = static_cast<float*>(dh0r);
  p.dh0i = static_cast<float*>(dh0i);
  p.carryr = static_cast<float*>(carryr);
  p.carryi = static_cast<float*>(carryi);
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

const char* complex_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
