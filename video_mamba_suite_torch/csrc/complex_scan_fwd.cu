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
// j = 0 .. ceil(L / chunk) - 1, fp32 (batch, nchunks, dim, dstate). The
// wrapper asks for them only when a backward will follow.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores), at the scan microbench shape (batch 8, L 2048, dim 1024,
// dstate 16, fp32 I/O): u, dt, z in and y out move 4 x 67 MB plus 2.1 MB of
// B and C, 270 MB, 81 us; each of the 268 M complex state updates takes an
// exponential, a sine, a cosine and some 17 multiplications and additions,
// 20 operations counting each transcendental as one, 5.4 GFLOP, 80 us. So
// the two bounds about meet (and a transcendental costs the fp32 units
// more than one operation).
//
// Design (simple and right first): one thread per (row, channel) walks the
// whole sequence with its 16 complex states in 32 registers, reading u, dt
// and z coalesced across the channels of a warp and B and C as broadcasts.
// The walk is not split in time (K3's segments): at the microbench shape
// that leaves 8192 threads, about 2 warps an SM, so the chain of dependent
// steps and not the bytes sets the time. Splitting the walk is the next
// step for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDstate = 16;
constexpr int kThreads = 128;

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
  long long batch;
  int seqlen, dim, dstate, ngroups, chunk, nchunks, reverse, softplus;
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

// softplus as torch computes it (threshold 20), as in chunked_scan_fwd.cu.
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) complex_scan_fwd_kernel(Params p) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= p.batch * p.dim) return;
  const long long row = idx / p.dim;
  const int ch = static_cast<int>(idx % p.dim);
  const int group = ch / (p.dim / p.ngroups);

  float Ar[kMaxDstate], Ai[kMaxDstate], hr[kMaxDstate], hi[kMaxDstate];
  const long long sidx = (row * p.dim + ch) * p.dstate;
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    const bool on = k < p.dstate;
    Ar[k] = on ? p.Ar[ch * p.dstate + k] : 0.f;
    Ai[k] = on ? p.Ai[ch * p.dstate + k] : 0.f;
    hr[k] = (on && p.h0r) ? p.h0r[sidx + k] : 0.f;
    hi[k] = (on && p.h0i) ? p.h0i[sidx + k] : 0.f;
  }
  const float bias = p.bias ? p.bias[ch] : 0.f;
  const float D = p.D ? p.D[ch] : 0.f;

  const T* u = static_cast<const T*>(p.u);
  const T* dtp = static_cast<const T*>(p.dt);
  const T* z = static_cast<const T*>(p.z);
  T* out = static_cast<T*>(p.out);
  const long long base = row * p.seqlen * p.dim + ch;
  const long long bc_step = static_cast<long long>(p.ngroups) * p.dstate;
  const T* Bp = static_cast<const T*>(p.B) + row * p.seqlen * bc_step +
                group * p.dstate;
  const T* Cp = static_cast<const T*>(p.C) + row * p.seqlen * bc_step +
                group * p.dstate;

  for (int i = 0; i < p.seqlen; ++i) {
    if (p.statesr && i % p.chunk == 0) {
      const long long off =
          ((row * p.nchunks + i / p.chunk) * p.dim + ch) * p.dstate;
#pragma unroll
      for (int k = 0; k < kMaxDstate; ++k) {
        if (k < p.dstate) {
          p.statesr[off + k] = hr[k];
          p.statesi[off + k] = hi[k];
        }
      }
    }
    const int t = p.reverse ? p.seqlen - 1 - i : i;
    const long long off = base + static_cast<long long>(t) * p.dim;
    const float uv = to_float(u[off]);
    float dt = to_float(dtp[off]) + bias;
    if (p.softplus) dt = softplus(dt);
    const float dtu = dt * uv;
    const T* Bt = Bp + t * bc_step;
    const T* Ct = Cp + t * bc_step;
    float y = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxDstate; ++k) {
      if (k < p.dstate) {
        const float mag = expf(dt * Ar[k]);
        float sn, cs;
        sincosf(dt * Ai[k], &sn, &cs);
        const float car = mag * cs;
        const float cai = mag * sn;
        const float hr_new = car * hr[k] - cai * hi[k] + dtu * to_float(Bt[k]);
        hi[k] = cai * hr[k] + car * hi[k];
        hr[k] = hr_new;
        y += to_float(Ct[k]) * hr[k];
      }
    }
    y *= 2.f;
    if (p.D) y += D * uv;
    if (z) {
      const float zv = to_float(z[off]);
      y *= zv / (1.f + expf(-zv));
    }
    out[off] = from_float<T>(y);
  }
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    if (k < p.dstate) {
      p.lastr[sidx + k] = hr[k];
      p.lasti[sidx + k] = hi[k];
    }
  }
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
  const long long threads = batch * dim;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

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
  p.batch = batch;
  p.seqlen = seqlen;
  p.dim = dim;
  p.dstate = dstate;
  p.ngroups = ngroups;
  p.chunk = statesr ? chunk : 1;
  p.nchunks = statesr ? (seqlen + chunk - 1) / chunk : 0;
  p.reverse = reverse;
  p.softplus = softplus;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (dtype == 0) {
    complex_scan_fwd_kernel<float><<<grid, kThreads, 0, s>>>(p);
  } else {
    complex_scan_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* complex_scan_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
