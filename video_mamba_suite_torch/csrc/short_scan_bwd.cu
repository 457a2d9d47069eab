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
// 0.018 ms), and does about 20 fp32 operations for each of 2 x 33.5 M state
// updates (forward pass and adjoint walk; 1.3 GFLOP, 0.020 ms). So it is
// about as much operations as bytes, and the three exponentials per state
// update (forward pass, segment recompute, adjoint step) go to the
// special-function units on top. At the TimeMamba-B adapter shape (batch
// 1568, seqlen 16, dim 768, bf16) the bytes are 0.27 GB (0.08 ms) and the
// operations 12.3 GFLOP (0.18 ms).
//
// Design (right and simple first; K2's walk for one direction, K5's thread
// layout): one thread per (row, channel) with its 16 fp32 states in
// registers; a block takes up to 128 channels of one group (grid.y: group
// and channel tile) and loops over a fixed set of rows (grid.x: row
// group). Per row it stages the group's B and C for every step in shared
// memory, then
//   pass 1 walks forward, keeps the state in registers, stores it to
//          shared memory every kSeg steps (checkpoints), and computes the
//          gate's backward dz from y_t on the way;
//   pass 2 walks the segments backwards: it recomputes the kSeg states of
//          a segment from its checkpoint into registers, then runs the
//          adjoint walk over them. h_prev is never rebuilt as
//          (h_t - dt u B) / a_t, which blows up where a_t underflows.
// `reverse` maps walk step i to time L-1-i, so nothing is flipped. dB and
// dC are sums over channels: each step reduces its 32 values (dB and dC for
// 16 states) across the warp with one transposing butterfly (31 shuffles;
// lane l ends with value l), the warps' results go to shared memory, and
// the block writes one fp32 partial per (channel tile, row, step, group,
// state). dA, dD and dbias are sums over rows: each thread keeps them in
// registers over its block's rows and writes one fp32 partial per row
// group. The wrapper sums the partials with torch.sum, so the result does
// not depend on the order in which blocks run (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeqlen = 64;
constexpr int kMaxDstate = 16;
constexpr int kMaxThreads = 128;
constexpr int kSeg = 4;  // steps between state checkpoints

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
  long long batch;
  int seqlen, dim, dstate, ngroups;
  int group_dim;      // channels per group, dim / ngroups
  int tiles;          // blocks per group
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
__device__ __forceinline__ void butterfly_stage(float (&v)[32], int lane) {
  const bool upper = lane & kOff;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = upper ? v[i] : v[i + kOff];
    const float keep = upper ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// After this, v[0] on lane l is the sum of v[l] over the warp's 32 lanes.
__device__ __forceinline__ void warp_transpose_sum(float (&v)[32], int lane) {
  butterfly_stage<16>(v, lane);
  butterfly_stage<8>(v, lane);
  butterfly_stage<4>(v, lane);
  butterfly_stage<2>(v, lane);
  butterfly_stage<1>(v, lane);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    short_scan_bwd_kernel(Params p) {
  const int seqlen = p.seqlen;
  const int dim = p.dim;
  const int dstate = p.dstate;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads / 32;
  extern __shared__ float smem[];
  float* sB = smem;                              // [t][16], fp32, zero-padded
  float* sC = sB + seqlen * kMaxDstate;          // [t][16]
  float* red = sC + seqlen * kMaxDstate;         // [warp][t][32]
  float* ck = red + nwarps * seqlen * 32;        // [segment-1][16][thread]

  const int group = blockIdx.y / p.tiles;
  const int tile = blockIdx.y % p.tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = tile * nthreads + tid;
  // Threads past the group's last channel load zeros (their state and
  // cotangents stay 0) and store nothing, but take part in the shuffles.
  const bool active = c < p.group_dim;
  const int ch = group * p.group_dim + (active ? c : 0);
  const int nseg = (seqlen + kSeg - 1) / kSeg;

  float A[kMaxDstate];
  float dA[kMaxDstate];
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    A[k] = active && k < dstate ? p.A[ch * dstate + k] : 0.f;
    dA[k] = 0.f;
  }
  const float bias = active && p.bias ? p.bias[ch] : 0.f;
  const float D = active && p.D ? p.D[ch] : 0.f;
  float dD = 0.f;
  float dbias = 0.f;

  const T* u = static_cast<const T*>(p.u);
  const T* dtp = static_cast<const T*>(p.dt);
  const T* z = static_cast<const T*>(p.z);
  const T* gp = static_cast<const T*>(p.g);
  T* du = static_cast<T*>(p.du);
  T* ddtp = static_cast<T*>(p.ddt);
  T* dz = static_cast<T*>(p.dz);
  const int64_t bc_step = static_cast<int64_t>(p.ngroups) * dstate;

  for (int64_t row = blockIdx.x; row < p.batch; row += gridDim.x) {
    __syncthreads();  // the previous row is done with sB, sC and red
    const int64_t bc_off = row * seqlen * bc_step + group * dstate;
    const T* Bp = static_cast<const T*>(p.B) + bc_off;
    const T* Cp = static_cast<const T*>(p.C) + bc_off;
    for (int i = tid; i < seqlen * kMaxDstate; i += nthreads) {
      const int t = i / kMaxDstate;
      const int k = i % kMaxDstate;
      sB[i] = k < dstate ? to_float(Bp[t * bc_step + k]) : 0.f;
      sC[i] = k < dstate ? to_float(Cp[t * bc_step + k]) : 0.f;
    }
    __syncthreads();
    const int64_t base = row * seqlen * dim + ch;

    // pass 1: forward states, checkpoints and the gate's backward
    float h[kMaxDstate];
#pragma unroll
    for (int k = 0; k < kMaxDstate; ++k) h[k] = 0.f;
    for (int i = 0; i < seqlen; ++i) {
      if (i > 0 && i % kSeg == 0) {
        float* cp = ck + (i / kSeg - 1) * kMaxDstate * nthreads + tid;
#pragma unroll
        for (int k = 0; k < kMaxDstate; ++k) cp[k * nthreads] = h[k];
      }
      const int t = p.reverse ? seqlen - 1 - i : i;
      const int64_t off = base + static_cast<int64_t>(t) * dim;
      const float uv = active ? to_float(u[off]) : 0.f;
      const float x = (active ? to_float(dtp[off]) : 0.f) + bias;
      const float dt = p.softplus ? softplus(x) : x;
      const float dtu = dt * uv;
      const float* Bt = sB + t * kMaxDstate;
      const float* Ct = sC + t * kMaxDstate;
      float y = D * uv;
#pragma unroll
      for (int k = 0; k < kMaxDstate; ++k) {
        h[k] = expf(dt * A[k]) * h[k] + dtu * Bt[k];
        y += Ct[k] * h[k];
      }
      if (z && active) {
        const float zv = to_float(z[off]);
        const float s = sigmoid(zv);
        const float g = to_float(gp[off]);
        dz[off] = from_float<T>(g * y * (s + zv * s * (1.f - s)));
      }
    }

    // pass 2: segments last to first, each recomputed from its checkpoint
    float dh[kMaxDstate];
#pragma unroll
    for (int k = 0; k < kMaxDstate; ++k) dh[k] = 0.f;
    for (int s = nseg - 1; s >= 0; --s) {
      float hp[kMaxDstate];  // the state before the segment
      const float* cp = ck + (s > 0 ? s - 1 : 0) * kMaxDstate * nthreads + tid;
#pragma unroll
      for (int k = 0; k < kMaxDstate; ++k) {
        hp[k] = s > 0 ? cp[k * nthreads] : 0.f;
        h[k] = hp[k];
      }
      float hs[kSeg][kMaxDstate];
      float us[kSeg];
      float dts[kSeg];
      float dsp[kSeg];
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const int i = s * kSeg + j;
        us[j] = dts[j] = dsp[j] = 0.f;
        if (i < seqlen) {
          const int t = p.reverse ? seqlen - 1 - i : i;
          const int64_t off = base + static_cast<int64_t>(t) * dim;
          const float uv = active ? to_float(u[off]) : 0.f;
          const float x = (active ? to_float(dtp[off]) : 0.f) + bias;
          const float dt = p.softplus ? softplus(x) : x;
          us[j] = uv;
          dts[j] = dt;
          dsp[j] = p.softplus ? softplus_grad(x) : 1.f;
          const float dtu = dt * uv;
          const float* Bt = sB + t * kMaxDstate;
#pragma unroll
          for (int k = 0; k < kMaxDstate; ++k) {
            h[k] = expf(dt * A[k]) * h[k] + dtu * Bt[k];
          }
        }
#pragma unroll
        for (int k = 0; k < kMaxDstate; ++k) hs[j][k] = h[k];
      }
#pragma unroll
      for (int j = kSeg - 1; j >= 0; --j) {
        const int i = s * kSeg + j;
        if (i >= seqlen) continue;  // the same for every thread
        const int t = p.reverse ? seqlen - 1 - i : i;
        const int64_t off = base + static_cast<int64_t>(t) * dim;
        const float g = active ? to_float(gp[off]) : 0.f;
        float gy = g;
        if (z) {
          const float zv = active ? to_float(z[off]) : 0.f;
          gy = g * zv * sigmoid(zv);
        }
        const float uv = us[j];
        const float dt = dts[j];
        const float dtu = dt * uv;
        const float* Bt = sB + t * kMaxDstate;
        const float* Ct = sC + t * kMaxDstate;
        float v[32];  // dB for the 16 states, then dC
        float ddt = 0.f;
        float dhB = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxDstate; ++k) {
          const float a = expf(dt * A[k]);
          const float h_prev = j > 0 ? hs[j - 1][k] : hp[k];
          dh[k] += Ct[k] * gy;
          v[k] = dh[k] * dtu;
          v[kMaxDstate + k] = gy * hs[j][k];
          const float el = dh[k] * h_prev * a;
          dA[k] += el * dt;
          ddt += el * A[k];
          dhB += dh[k] * Bt[k];
          dh[k] *= a;
        }
        ddt = (ddt + dhB * uv) * dsp[j];
        dD += gy * uv;
        dbias += ddt;
        if (active) {
          du[off] = from_float<T>(dhB * dt + gy * D);
          ddtp[off] = from_float<T>(ddt);
        }
        warp_transpose_sum(v, lane);
        red[(warp * seqlen + t) * 32 + lane] = v[0];
      }
    }
    __syncthreads();

    // this row's dB and dC over the block's channels
    const int64_t part =
        (static_cast<int64_t>(tile) * p.batch + row) * seqlen * bc_step +
        group * dstate;
    for (int i = tid; i < seqlen * dstate; i += nthreads) {
      const int t = i / dstate;
      const int k = i % dstate;
      float sb = 0.f;
      float sc = 0.f;
      for (int w = 0; w < nwarps; ++w) {
        sb += red[(w * seqlen + t) * 32 + k];
        sc += red[(w * seqlen + t) * 32 + kMaxDstate + k];
      }
      p.dB[part + t * bc_step + k] = sb;
      p.dC[part + t * bc_step + k] = sc;
    }
  }

  if (active) {
    const int64_t prow = static_cast<int64_t>(blockIdx.x) * dim + ch;
    for (int k = 0; k < dstate; ++k) p.dA[prow * dstate + k] = dA[k];
    if (p.dD) p.dD[prow] = dD;
    if (p.dbias) p.dbias[prow] = dbias;
  }
}

template <typename T>
int launch(const Params& p, int row_groups, int threads, cudaStream_t s) {
  const int nseg = (p.seqlen + kSeg - 1) / kSeg;
  const size_t smem =
      sizeof(float) * (2 * p.seqlen * kMaxDstate +
                       (threads / 32) * p.seqlen * 32 +
                       (nseg - 1) * kMaxDstate * threads);
  cudaError_t err = cudaFuncSetAttribute(
      short_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(row_groups),
                  static_cast<unsigned>(p.ngroups * p.tiles));
  short_scan_bwd_kernel<T><<<grid, threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one direction on `stream`. dtype: 0 float32, 1 bfloat16 (u, dt,
// z, B, C, g, du, ddt and dz share it; A, D, bias and every partial are
// float32). B and C are (batch, seqlen, ngroups, dstate) with dim divisible
// by ngroups. z and dz, D and dD, bias and dbias are null together.
// `row_groups` (1 <= row_groups <= batch) row groups each write one partial
// of dA, dD and dbias; every channel tile of a group writes one partial of
// dB and dC, (tiles, batch, seqlen, ngroups, dstate), where tiles is
// ceil(dim / ngroups / min(128, dim / ngroups rounded up to 32)). Returns
// the cudaError_t of the launch (0 on success).
int short_scan_bwd(int dtype, long long batch, int seqlen, int dim,
                   int dstate, int ngroups, int row_groups, int reverse,
                   int softplus, const void* u, const void* dt,
                   const void* z, const void* B, const void* C,
                   const void* A, const void* D, const void* bias,
                   const void* g, void* du, void* ddt, void* dz, void* dA,
                   void* dB, void* dC, void* dD, void* dbias, void* stream) {
  if (batch < 1 || batch > 0x7fffffffLL || seqlen < 1 ||
      seqlen > kMaxSeqlen || dim < 1 || dstate < 1 ||
      dstate > kMaxDstate || ngroups < 1 || dim % ngroups != 0 ||
      row_groups < 1 || row_groups > batch || (dtype != 0 && dtype != 1) ||
      !u || !dt || !B || !C || !A || !g || !du || !ddt || !dA || !dB ||
      !dC || (!z != !dz) || (!D != !dD) || (!bias != !dbias)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a block's channels lie in one group: as many threads as the group has
  // channels, rounded up to a warp, at most kMaxThreads
  const int group_dim = dim / ngroups;
  const int rounded = (group_dim + 31) / 32 * 32;
  const int threads = rounded < kMaxThreads ? rounded : kMaxThreads;
  const int tiles = (group_dim + threads - 1) / threads;
  if (static_cast<long long>(ngroups) * tiles > 65535) {
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
  p.batch = batch;
  p.seqlen = seqlen;
  p.dim = dim;
  p.dstate = dstate;
  p.ngroups = ngroups;
  p.group_dim = group_dim;
  p.tiles = tiles;
  p.reverse = reverse;
  p.softplus = softplus;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, row_groups, threads, s);
  return launch<__nv_bfloat16>(p, row_groups, threads, s);
}

const char* short_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
