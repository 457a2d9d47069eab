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
// 42 us. So the bytes bound it; the partials below add about 50 MB.
//
// Design. As in the forward, there are only 8 x 384 recurrences, each 3152
// steps long, so the walk is split in time, here at the checkpoints: one
// thread per (row, chunk, channel), the 16 states in registers, a warp on
// 32 channels of one group and one chunk. Three kernels, in order on the
// stream:
//   local:   each thread walks its chunk backwards from a zero adjoint and
//            leaves the adjoint that leaves the chunk at its first step
//            (E) and the chunk's sum of dt;
//   combine: one thread per (row, channel, state) chains the chunks from
//            the walk's end, M <- exp(A * sum dt) * M + E, starting from
//            g_last (the decay of a chunk is exactly exp(A * sum dt)), and
//            leaves each chunk's exact incoming adjoint; after the first
//            chunk M is dh0. The chain is serial, so it loads kCombineBatch
//            chunks' values at once (one memory latency per batch);
//   main:    each thread walks its chunk backwards again from that adjoint,
//            in pieces of kPiece steps, last piece first. A piece's states
//            are recomputed forward from the chunk's checkpoint into
//            registers (h_{t-1} is never rebuilt as (h_t - dt u B) / a_t,
//            which fails where a_t underflows to 0), then the adjoint step
//            above runs over them and writes du, ddt, dz.
// Reductions without atomics, so the result does not depend on the order
// in which blocks run: dB and dC are summed over the warp's 32 channels
// with a transposing butterfly (16 shuffles for 16 values) and written as
// one fp32 partial per 32-channel tile; dA, dD and dbias are summed over
// the block's kWarps chunks in shared memory and written as one fp32
// partial per (row, block of chunks). The wrapper adds the partials with
// torch.sum. Lanes past the group's width load zeros and store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDstate = 16;
constexpr int kWarps = 4;  // chunks per block of the walking kernels
constexpr int kThreads = 32 * kWarps;
constexpr int kPiece = 4;  // steps whose states are held in registers
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
  int nchunks;   // ceil(seqlen / chunk)
  int width;     // channels per group
  int tiles;     // 32-channel tiles per group
  int ncgroups;  // blocks of kWarps chunks per row
  int reverse, softplus;
};

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// softplus as torch computes it (threshold 20), and its derivative.
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}
__device__ __forceinline__ float softplus_grad(float x) {
  return x > 20.f ? 1.f : sigmoid(x);
}

// One stage of the transposing butterfly: lanes that differ in bit kOff
// swap halves of their first 2*kOff values and add.
template <int kOff>
__device__ __forceinline__ void butterfly_stage(float (&v)[kMaxDstate],
                                                int lane) {
  const bool upper = lane & kOff;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = upper ? v[i] : v[i + kOff];
    const float keep = upper ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// The sum over the warp's 32 lanes of v[lane % 16] (v is clobbered).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kMaxDstate],
                                                    int lane) {
  butterfly_stage<8>(v, lane);
  butterfly_stage<4>(v, lane);
  butterfly_stage<2>(v, lane);
  butterfly_stage<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
}

// Where a thread of the walking kernels works: block (row, block of chunks,
// group, tile), warp w -> chunk cg * kWarps + w, lane -> a channel.
struct Place {
  int64_t row;
  int cg, c, group, tile, cw, ch;
  bool chunk_ok;  // the warp's chunk exists (the same for the whole warp)
  bool active;    // ... and the lane's channel too
  int i_lo, i_hi;
};

__device__ __forceinline__ Place place(const Params& p) {
  Place q;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwt = p.ngroups * p.tiles;
  const int wt = blockIdx.x % nwt;
  const int64_t rc = blockIdx.x / nwt;
  q.cg = static_cast<int>(rc % p.ncgroups);
  q.row = rc / p.ncgroups;
  q.c = q.cg * kWarps + warp;
  q.group = wt / p.tiles;
  q.tile = wt % p.tiles;
  q.cw = q.tile * 32 + lane;
  q.chunk_ok = q.c < p.nchunks;
  q.active = q.chunk_ok && q.cw < p.width;
  q.ch = q.group * p.width + min(q.cw, p.width - 1);
  q.i_lo = q.c * p.chunk;
  q.i_hi = min(q.i_lo + p.chunk, p.seqlen);
  return q;
}

// Pass "local": each chunk's outgoing adjoint from a zero incoming one,
// and its sum of dt.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chunked_scan_bwd_local(Params p) {
  const Place q = place(p);
  if (!q.active) return;  // no shuffles or barriers in this kernel
  float A[kMaxDstate];
  float dh[kMaxDstate];
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    A[k] = k < p.dstate ? p.A[q.ch * p.dstate + k] : 0.f;
    dh[k] = 0.f;
  }
  const float bias = p.bias ? p.bias[q.ch] : 0.f;
  const T* dtp = static_cast<const T*>(p.dt);
  const T* gp = static_cast<const T*>(p.g);
  const T* z = static_cast<const T*>(p.z);
  const int64_t bc_step = static_cast<int64_t>(p.ngroups) * p.dstate;
  const T* Cp = static_cast<const T*>(p.C) + q.row * p.seqlen * bc_step +
                q.group * p.dstate;
  float dtsum = 0.f;
  for (int i = q.i_hi - 1; i >= q.i_lo; --i) {
    const int t = p.reverse ? p.seqlen - 1 - i : i;
    const int64_t off = (q.row * p.seqlen + t) * p.dim + q.ch;
    float gy = to_float(gp[off]);
    if (z) {
      const float zv = to_float(z[off]);
      gy *= zv * sigmoid(zv);
    }
    float dt = to_float(dtp[off]) + bias;
    if (p.softplus) dt = softplus(dt);
    const T* Ct = Cp + t * bc_step;
#pragma unroll
    for (int k = 0; k < kMaxDstate; ++k) {
      if (k < p.dstate) {
        dh[k] = (dh[k] + to_float(Ct[k]) * gy) * expf(dt * A[k]);
      }
    }
    dtsum += dt;
  }
  const int64_t cidx = (q.row * p.nchunks + q.c) * p.dim + q.ch;
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    if (k < p.dstate) p.carry[cidx * p.dstate + k] = dh[k];
  }
  p.dtsum[cidx] = dtsum;
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

// One step of the forward recompute at walk step i (zeros where the lane
// is not active).
template <typename T>
__device__ __forceinline__ void fwd_step(const Params& p, const Place& q,
                                         const float (&A)[kMaxDstate],
                                         float bias, int i,
                                         float (&h)[kMaxDstate]) {
  const int t = p.reverse ? p.seqlen - 1 - i : i;
  const int64_t off = (q.row * p.seqlen + t) * p.dim + q.ch;
  const float uv = q.active ? to_float(static_cast<const T*>(p.u)[off]) : 0.f;
  float dt =
      (q.active ? to_float(static_cast<const T*>(p.dt)[off]) : 0.f) + bias;
  if (p.softplus) dt = softplus(dt);
  const float dtu = dt * uv;
  const int64_t bc_step = static_cast<int64_t>(p.ngroups) * p.dstate;
  const T* Bt = static_cast<const T*>(p.B) +
                (q.row * p.seqlen + t) * bc_step + q.group * p.dstate;
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    if (k < p.dstate) h[k] = expf(dt * A[k]) * h[k] + dtu * to_float(Bt[k]);
  }
}

// Pass "main": the adjoint walk with the exact incoming adjoint.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chunked_scan_bwd_main(Params p) {
  __shared__ float s_dA[kWarps][kMaxDstate][32];
  __shared__ float s_dD[kWarps][32];
  __shared__ float s_dbias[kWarps][32];

  const Place q = place(p);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool act = q.active;

  float A[kMaxDstate];
  float dA[kMaxDstate];
  float dh[kMaxDstate];
  const int64_t cidx = (q.row * p.nchunks + q.c) * p.dim + q.ch;
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    A[k] = act && k < p.dstate ? p.A[q.ch * p.dstate + k] : 0.f;
    dh[k] = act && k < p.dstate ? p.carry[cidx * p.dstate + k] : 0.f;
    dA[k] = 0.f;
  }
  const float bias = act && p.bias ? p.bias[q.ch] : 0.f;
  const float D = act && p.D ? p.D[q.ch] : 0.f;
  float dD = 0.f;
  float dbias = 0.f;

  const T* u = static_cast<const T*>(p.u);
  const T* dtp = static_cast<const T*>(p.dt);
  const T* z = static_cast<const T*>(p.z);
  const T* gp = static_cast<const T*>(p.g);
  T* du = static_cast<T*>(p.du);
  T* ddtp = static_cast<T*>(p.ddt);
  T* dz = static_cast<T*>(p.dz);
  const int64_t bc_step = static_cast<int64_t>(p.ngroups) * p.dstate;
  const T* Bp = static_cast<const T*>(p.B) + q.row * p.seqlen * bc_step +
                q.group * p.dstate;
  const T* Cp = static_cast<const T*>(p.C) + q.row * p.seqlen * bc_step +
                q.group * p.dstate;
  const float* ck = p.states + cidx * p.dstate;
  // this tile's dB and dC partials of the row start at part_row * ngroups
  const int64_t part_row = (q.tile * p.batch + q.row) * p.seqlen;
  const int kk = lane & 15;

  if (q.chunk_ok) {  // the same for the whole warp
    const int npieces = (q.i_hi - q.i_lo + kPiece - 1) / kPiece;
    for (int pc = npieces - 1; pc >= 0; --pc) {
      // recompute the piece's states from the chunk's checkpoint
      float h[kMaxDstate];
#pragma unroll
      for (int k = 0; k < kMaxDstate; ++k) {
        h[k] = act && k < p.dstate ? ck[k] : 0.f;
      }
      for (int r = 0; r < pc; ++r) {
#pragma unroll
        for (int j = 0; j < kPiece; ++j) {
          fwd_step<T>(p, q, A, bias, q.i_lo + r * kPiece + j, h);
        }
      }
      float hp[kMaxDstate];  // the state before the piece
      float hs[kPiece][kMaxDstate];
#pragma unroll
      for (int k = 0; k < kMaxDstate; ++k) hp[k] = h[k];
#pragma unroll
      for (int j = 0; j < kPiece; ++j) {
        const int i = q.i_lo + pc * kPiece + j;
        if (i < q.i_hi) fwd_step<T>(p, q, A, bias, i, h);
#pragma unroll
        for (int k = 0; k < kMaxDstate; ++k) hs[j][k] = h[k];
      }

      // the adjoint walk over the piece, last step first
#pragma unroll
      for (int j = kPiece - 1; j >= 0; --j) {
        const int i = q.i_lo + pc * kPiece + j;
        if (i >= q.i_hi) continue;  // the same for the whole warp
        const int t = p.reverse ? p.seqlen - 1 - i : i;
        const int64_t off = (q.row * p.seqlen + t) * p.dim + q.ch;
        const float uv = act ? to_float(u[off]) : 0.f;
        const float x = (act ? to_float(dtp[off]) : 0.f) + bias;
        const float dt = p.softplus ? softplus(x) : x;
        const float g = act ? to_float(gp[off]) : 0.f;
        const T* Bt = Bp + t * bc_step;
        const T* Ct = Cp + t * bc_step;
        float Cv[kMaxDstate];
#pragma unroll
        for (int k = 0; k < kMaxDstate; ++k) {
          Cv[k] = k < p.dstate ? to_float(Ct[k]) : 0.f;
        }
        float gy = g;
        if (z) {
          float y = D * uv;
#pragma unroll
          for (int k = 0; k < kMaxDstate; ++k) y += Cv[k] * hs[j][k];
          const float zv = act ? to_float(z[off]) : 0.f;
          const float s = sigmoid(zv);
          const float silu = zv * s;
          if (act) dz[off] = from_float<T>(g * y * (s + silu * (1.f - s)));
          gy = g * silu;
        }
        const float dtu = dt * uv;
        float v[kMaxDstate];  // dB of the 16 states, then dC
        float ddt = 0.f;
        float dhB = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxDstate; ++k) {
          const float Bv = k < p.dstate ? to_float(Bt[k]) : 0.f;
          const float a = expf(dt * A[k]);
          const float h_prev = j > 0 ? hs[j - 1][k] : hp[k];
          dh[k] += Cv[k] * gy;
          v[k] = dh[k] * dtu;
          const float el = dh[k] * h_prev * a;
          dA[k] += el * dt;
          ddt += el * A[k];
          dhB += dh[k] * Bv;
          dh[k] *= a;
        }
        ddt += dhB * uv;
        if (p.softplus) ddt *= softplus_grad(x);
        dD += gy * uv;
        dbias += ddt;
        if (act) {
          du[off] = from_float<T>(dhB * dt + gy * D);
          ddtp[off] = from_float<T>(ddt);
        }
        const float sum_b = warp_transpose_sum(v, lane);
#pragma unroll
        for (int k = 0; k < kMaxDstate; ++k) v[k] = gy * hs[j][k];
        const float sum_c = warp_transpose_sum(v, lane);
        if (kk < p.dstate) {
          const int64_t o =
              ((part_row + t) * p.ngroups + q.group) * p.dstate + kk;
          if (lane < 16) {
            p.dB[o] = sum_b;
          } else {
            p.dC[o] = sum_c;
          }
        }
      }
    }
  }

  // dA, dD and dbias over the block's chunks (the same channels)
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) s_dA[warp][k][lane] = dA[k];
  s_dD[warp][lane] = dD;
  s_dbias[warp][lane] = dbias;
  __syncthreads();
  if (warp == 0 && q.cw < p.width) {
    const int64_t prow =
        (q.row * p.ncgroups + q.cg) * p.dim + q.ch;  // q.ch exact here
    for (int k = 0; k < p.dstate; ++k) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_dA[w][k][lane];
      p.dA[prow * p.dstate + k] = s;
    }
    float sd = 0.f;
    float sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sd += s_dD[w][lane];
      sb += s_dbias[w][lane];
    }
    if (p.dD) p.dD[prow] = sd;
    if (p.dbias) p.dbias[prow] = sb;
  }
}

template <typename T>
int launch(const Params& p, long long batch, cudaStream_t s) {
  const long long walk_blocks =
      batch * p.ncgroups * static_cast<long long>(p.ngroups) * p.tiles;
  const int64_t total = static_cast<int64_t>(batch) * p.dim * p.dstate;
  const long long combine_blocks =
      (total + kCombineThreads - 1) / kCombineThreads;
  if (walk_blocks > 0x7fffffffLL || combine_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(walk_blocks));
  chunked_scan_bwd_local<T><<<grid, kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunked_scan_bwd_combine<<<static_cast<unsigned>(combine_blocks),
                             kCombineThreads, 0, s>>>(p, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunked_scan_bwd_main<T><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the backward of one direction on `stream`. dtype: 0 float32,
// 1 bfloat16 (u, dt, z, B, C, g, du, ddt and dz share it; A, D, bias,
// states, glast, dh0, every partial and the scratch are float32). `chunk`
// is the forward's checkpoint interval (a multiple of 4, at most 64) and
// `states` its checkpoints, (batch, ceil(seqlen / chunk), dim, dstate).
// Partials: dA (batch * ceil(nchunks / 4), dim, dstate), dD and dbias
// (batch * ceil(nchunks / 4), dim), dB and dC (ceil(dim / ngroups / 32),
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
      chunk < kPiece || chunk > kMaxChunk || chunk % kPiece != 0 ||
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
  p.nchunks = (seqlen + chunk - 1) / chunk;
  p.width = dim / ngroups;
  p.tiles = (p.width + 31) / 32;
  p.ncgroups = (p.nchunks + kWarps - 1) / kWarps;
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
