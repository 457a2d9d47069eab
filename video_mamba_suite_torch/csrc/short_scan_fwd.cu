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
//     6 operations, 0.3 us. The launch itself (a few us) bounds it.
//   video-adapter shape (batch 1568, seqlen 16, dim 768, dstate 16, bf16):
//     4 x 38.5 MB of u, dt, z and y, 77 MB of last state, 1.6 MB of B and
//     C: about 233 MB, about 70 us; 308 M state updates, 1.85 GFLOP, about
//     28 us. So the bound is the bytes.
//
// Design (simple and right first): one thread per (row, channel) with its
// dstate states in fp32 registers; a block takes `blockDim.x` (32 to 128)
// channels of one row, all inside one group, and first stages that group's
// B and C for every step of the row in shared memory as fp32 (at most
// 64 x 16 x 2 floats, 8 KB), so each step reads them from there. The walk
// runs over the true seqlen, forward or backward (`reverse` maps step i to
// L-1-i), so nothing is padded and no step is masked. Threads of a warp own
// neighbouring channels, so the loads of u, dt, z and the stores of y are
// coalesced along d; the y-reduction over the states is inside the thread.
// Each thread writes its last state as dstate contiguous floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeqlen = 64;
constexpr int kMaxDstate = 16;
constexpr int kMaxThreads = 128;

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

// softplus as torch computes it (threshold 20), as in short_bidir_fwd.cu.
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    short_scan_fwd_kernel(Params p) {
  // blockIdx.x: row; blockIdx.y: group * tiles + tile within the group
  const int64_t row = blockIdx.x;
  const int group = blockIdx.y / p.tiles;
  const int c = (blockIdx.y % p.tiles) * blockDim.x + threadIdx.x;
  const int ch = group * p.group_dim + c;

  __shared__ float sB[kMaxSeqlen * kMaxDstate];
  __shared__ float sC[kMaxSeqlen * kMaxDstate];
  const int64_t bc_step = static_cast<int64_t>(p.ngroups) * p.dstate;
  const int64_t bc_off = row * p.seqlen * bc_step + group * p.dstate;
  const T* Bp = static_cast<const T*>(p.B) + bc_off;
  const T* Cp = static_cast<const T*>(p.C) + bc_off;
  for (int i = threadIdx.x; i < p.seqlen * p.dstate; i += blockDim.x) {
    const int64_t src = (i / p.dstate) * bc_step + i % p.dstate;
    sB[i] = to_float(Bp[src]);
    sC[i] = to_float(Cp[src]);
  }
  __syncthreads();
  if (c >= p.group_dim) return;

  float A[kMaxDstate];
  float h[kMaxDstate];
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    A[k] = k < p.dstate ? p.A[ch * p.dstate + k] : 0.f;
    h[k] = 0.f;
  }
  const float bias = p.bias ? p.bias[ch] : 0.f;
  const float D = p.D ? p.D[ch] : 0.f;

  const T* u = static_cast<const T*>(p.u);
  const T* dtp = static_cast<const T*>(p.dt);
  const T* z = static_cast<const T*>(p.z);
  T* out = static_cast<T*>(p.out);
  const int64_t base = row * p.seqlen * p.dim + ch;
  for (int i = 0; i < p.seqlen; ++i) {
    const int t = p.reverse ? p.seqlen - 1 - i : i;
    const int64_t off = base + static_cast<int64_t>(t) * p.dim;
    const float uv = to_float(u[off]);
    float dt = to_float(dtp[off]) + bias;
    if (p.softplus) dt = softplus(dt);
    const float dtu = dt * uv;
    const float* Bt = sB + t * p.dstate;
    const float* Ct = sC + t * p.dstate;
    float y = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxDstate; ++k) {
      if (k < p.dstate) {
        h[k] = expf(dt * A[k]) * h[k] + dtu * Bt[k];
        y += Ct[k] * h[k];
      }
    }
    if (p.D) y += D * uv;
    if (z) {
      const float zv = to_float(z[off]);
      y *= zv / (1.f + expf(-zv));
    }
    out[off] = from_float<T>(y);
  }
  float* last = p.last + (row * p.dim + ch) * p.dstate;
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    if (k < p.dstate) last[k] = h[k];
  }
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
      seqlen > kMaxSeqlen || dim < 1 || dstate < 1 ||
      dstate > kMaxDstate || ngroups < 1 || dim % ngroups != 0 ||
      (dtype != 0 && dtype != 1) || !last) {
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
  p.out = out;
  p.last = static_cast<float*>(last);
  p.seqlen = seqlen;
  p.dim = dim;
  p.dstate = dstate;
  p.ngroups = ngroups;
  p.group_dim = group_dim;
  p.tiles = tiles;
  p.reverse = reverse;
  p.softplus = softplus;

  const dim3 grid(static_cast<unsigned>(batch),
                  static_cast<unsigned>(ngroups * tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    short_scan_fwd_kernel<float><<<grid, threads, 0, s>>>(p);
  } else {
    short_scan_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* short_scan_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
