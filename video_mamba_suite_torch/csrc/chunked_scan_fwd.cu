// Chunked selective scan, forward, one direction, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_fwd_kernel` and `_fwd_kernel_hs` (its form for
// batch <= 4) in video_mamba_suite_tpu/ops/selective_scan_pallas.py,
// launched from `_scan_fwd_impl` (reached through `_scan_core` and, for
// the anti-causal direction, `_rev_core`). One kernel computes the function
// of both. Per (row, channel, state), walking t = 0..L-1, or L-1..0 when
// `reverse`:
//
//     dt_t = softplus(dt_t + bias)                     (softplus optional)
//     h_t  = exp(dt_t * A) * h_prev + dt_t * u_t * B_t[group]
//     y_t  = (sum_n C_t[group] * h_t + D * u_t) * silu(z_t)
//
// h starts at the initial state (zeros when absent); the last state is the
// state after the last step of the walk (t = L-1, or t = 0 when reverse).
// Channel d reads B and C of group d / (dim / G). u, dt, z, B, C and the
// output share one type (fp32 or bf16); A, D, bias and both states are fp32.
//
// Checkpoints (the `want_states` output of `_scan_fwd_impl`, for the
// backward, kernel K4 in chunked_scan_bwd.cu): when `states` is not null,
// the state before walk step j * chunk is written to states[row, j] for
// j = 0 .. ceil(L / chunk) - 1, fp32 (batch, ceil(L / chunk), dim, dstate);
// states[row, 0] is the initial state. The wrapper asks for them only when
// a backward will follow, so inference writes nothing more.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores), at ViViM-T's shape (batch 8, seqlen 3152 = 16 frames x 197
// tokens, dim 384, dstate 16, fp32 I/O):
//   bytes: u, dt, z in and y out, 4 x 38.7 MB, plus 3.2 MB of B and C,
//          about 158 MB, so about 47 us;
//   fp32:  about 6 operations (one an exponential) for each of 155 M state
//          updates, 0.93 GFLOP, about 14 us.
// So the bound is the bytes.
//
// Design. The recurrence is sequential in time, and at the main shape there
// are only 8 x 384 = 3072 independent (row, channel) recurrences (384 at
// batch 1), too few to fill 132 SMs one thread each. So a block takes
// `tile` channels of one row and splits the walk into nseg = 512 / tile
// segments, one thread per (segment, channel) with its 16 states in
// registers:
//   pass 1: every thread scans its segment from a zero state and leaves the
//           end state and the segment's sum of dt in shared memory;
//   combine: one thread per (channel, state) chains the segments in walk
//           order, H <- exp(A * sum dt) * H + end state (the decay of a
//           segment is exactly exp(A * sum dt)), starting from the initial
//           state, and leaves each segment's incoming state;
//   pass 2: every thread scans its segment again from its incoming state
//           and writes y; the thread of the last segment writes the last
//           state.
// That is twice the exponentials of one walk, for 512 threads per block.
// Threads of a warp own neighbouring channels (tile >= 32 bytes of one
// time step), so the loads of u, dt, z and the stores of y fill whole
// 32-byte sectors. The wrapper-side C entry picks the widest tile that
// still gives two blocks per SM. Nothing is padded: segments past the
// sequence end are empty, and empty segments are identities.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDstate = 16;
constexpr int kThreads = 512;

struct Params {
  const void* u;      // (batch, seqlen, dim)
  const void* dt;     // (batch, seqlen, dim), before bias and softplus
  const void* z;      // (batch, seqlen, dim) or null
  const void* B;      // (batch, seqlen, ngroups, dstate)
  const void* C;      // (batch, seqlen, ngroups, dstate)
  const float* A;     // (dim, dstate)
  const float* D;     // (dim,) or null
  const float* bias;  // (dim,) or null
  const float* h0;    // (batch, dim, dstate) or null
  void* out;          // (batch, seqlen, dim)
  float* last;        // (batch, dim, dstate) or null
  float* states;      // (batch, nchunks, dim, dstate) checkpoints or null
  int seqlen, dim, dstate, ngroups;
  int chunk;   // walk steps between checkpoints
  int nchunks;
  int tile;    // channels per block
  int ntiles;  // blocks per row
  int seglen;  // steps per segment
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
__global__ void __launch_bounds__(kThreads)
    chunked_scan_fwd_kernel(Params p) {
  // [segment][state][channel]: end states after pass 1, incoming states
  // after the combine; [segment][channel]: the sum of dt over the segment
  __shared__ float s_state[kThreads * kMaxDstate];
  __shared__ float s_dtsum[kThreads];

  const int64_t row = blockIdx.x / p.ntiles;
  const int ch0 = (blockIdx.x % p.ntiles) * p.tile;
  const int c = threadIdx.x % p.tile;
  const int seg = threadIdx.x / p.tile;
  const int ch = ch0 + c;
  const bool active = ch < p.dim;
  const int i0 = seg * p.seglen;
  const int i1 = min(i0 + p.seglen, p.seqlen);

  float A[kMaxDstate];
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    A[k] = (active && k < p.dstate) ? p.A[ch * p.dstate + k] : 0.f;
  }
  const float bias = (active && p.bias) ? p.bias[ch] : 0.f;
  const int group = active ? ch / (p.dim / p.ngroups) : 0;

  const T* u = static_cast<const T*>(p.u);
  const T* dtp = static_cast<const T*>(p.dt);
  const int64_t base = row * p.seqlen * p.dim + ch;
  const int64_t bc_step = static_cast<int64_t>(p.ngroups) * p.dstate;
  const T* Bp = static_cast<const T*>(p.B) + row * p.seqlen * bc_step +
                group * p.dstate;
  const T* Cp = static_cast<const T*>(p.C) + row * p.seqlen * bc_step +
                group * p.dstate;

  // pass 1: the segment's end state from a zero state, and its sum of dt
  float h[kMaxDstate];
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) h[k] = 0.f;
  float dtsum = 0.f;
  if (active) {
    for (int i = i0; i < i1; ++i) {
      const int t = p.reverse ? p.seqlen - 1 - i : i;
      const int64_t off = base + static_cast<int64_t>(t) * p.dim;
      float dt = to_float(dtp[off]) + bias;
      if (p.softplus) dt = softplus(dt);
      const float dtu = dt * to_float(u[off]);
      const T* Bt = Bp + t * bc_step;
#pragma unroll
      for (int k = 0; k < kMaxDstate; ++k) {
        if (k < p.dstate) {
          h[k] = expf(dt * A[k]) * h[k] + dtu * to_float(Bt[k]);
        }
      }
      dtsum += dt;
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    s_state[(seg * kMaxDstate + k) * p.tile + c] = h[k];
  }
  s_dtsum[seg * p.tile + c] = dtsum;
  __syncthreads();

  // combine: one thread per (channel, state) chains the segments
  const int nseg = kThreads / p.tile;
  if (threadIdx.x < p.tile * p.dstate) {
    const int cc = threadIdx.x % p.tile;
    const int k = threadIdx.x / p.tile;
    const int ch2 = ch0 + cc;
    if (ch2 < p.dim) {
      const float a = p.A[ch2 * p.dstate + k];
      float H = p.h0 ? p.h0[(row * p.dim + ch2) * p.dstate + k] : 0.f;
      for (int s = 0; s < nseg; ++s) {
        const int idx = (s * kMaxDstate + k) * p.tile + cc;
        const float end = s_state[idx];
        s_state[idx] = H;
        H = expf(a * s_dtsum[s * p.tile + cc]) * H + end;
      }
    }
  }
  __syncthreads();

  // pass 2: the segment again from its incoming state, writing y
  if (!active || i0 >= p.seqlen) return;
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    h[k] = s_state[(seg * kMaxDstate + k) * p.tile + c];
  }
  const float D = p.D ? p.D[ch] : 0.f;
  const T* z = static_cast<const T*>(p.z);
  T* out = static_cast<T*>(p.out);
  // the next checkpoint at or after i0: walk step ck_step, index ck
  int ck = p.states ? (i0 + p.chunk - 1) / p.chunk : p.nchunks;
  int ck_step = ck * p.chunk;
  for (int i = i0; i < i1; ++i) {
    if (i == ck_step && ck < p.nchunks) {
      float* st = p.states +
                  ((row * p.nchunks + ck) * p.dim + ch) * p.dstate;
#pragma unroll
      for (int k = 0; k < kMaxDstate; ++k) {
        if (k < p.dstate) st[k] = h[k];
      }
      ++ck;
      ck_step += p.chunk;
    }
    const int t = p.reverse ? p.seqlen - 1 - i : i;
    const int64_t off = base + static_cast<int64_t>(t) * p.dim;
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
        h[k] = expf(dt * A[k]) * h[k] + dtu * to_float(Bt[k]);
        y += to_float(Ct[k]) * h[k];
      }
    }
    if (p.D) y += D * uv;
    if (z) {
      const float zv = to_float(z[off]);
      y *= zv / (1.f + expf(-zv));
    }
    out[off] = from_float<T>(y);
  }
  if (i1 == p.seqlen && p.last) {
    float* last = p.last + (row * p.dim + ch) * p.dstate;
#pragma unroll
    for (int k = 0; k < kMaxDstate; ++k) {
      if (k < p.dstate) last[k] = h[k];
    }
  }
}

}  // namespace

extern "C" {

// Launches one direction on `stream`. dtype: 0 float32, 1 bfloat16 (u, dt,
// z, B, C and out share it; A, D, bias, h0 and last are float32). B and C
// are (batch, seqlen, ngroups, dstate) with dim divisible by ngroups. z, D,
// bias, h0, last and states may be null; with states, `chunk` >= 1 is the
// number of walk steps between checkpoints. Returns the cudaError_t of the
// launch (0 on success).
int chunked_scan_fwd(int dtype, long long batch, int seqlen, int dim,
                     int dstate, int ngroups, int reverse, int softplus,
                     int chunk, const void* u, const void* dt, const void* z,
                     const void* B, const void* C, const void* A,
                     const void* D, const void* bias, const void* h0,
                     void* out, void* last, void* states, void* stream) {
  if (batch < 1 || seqlen < 1 || dim < 1 || dstate < 1 ||
      dstate > kMaxDstate || ngroups < 1 || dim % ngroups != 0 ||
      (dtype != 0 && dtype != 1) || (states && chunk < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  // the widest tile (32 channels, 16 segments) that still gives two blocks
  // per SM; no narrower than one 32-byte sector of a time step
  const int min_tile = dtype == 0 ? 8 : 16;
  int tile = 32;
  while (tile > min_tile &&
         batch * ((dim + tile - 1) / tile) < 2LL * sms) {
    tile /= 2;
  }
  const int ntiles = (dim + tile - 1) / tile;
  const int nseg = kThreads / tile;
  if (batch * ntiles > 0x7fffffffLL) {
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
  p.h0 = static_cast<const float*>(h0);
  p.out = out;
  p.last = static_cast<float*>(last);
  p.states = static_cast<float*>(states);
  p.chunk = states ? chunk : 1;
  p.nchunks = states ? (seqlen + chunk - 1) / chunk : 0;
  p.seqlen = seqlen;
  p.dim = dim;
  p.dstate = dstate;
  p.ngroups = ngroups;
  p.tile = tile;
  p.ntiles = ntiles;
  p.seglen = (seqlen + nseg - 1) / nseg;
  p.reverse = reverse;
  p.softplus = softplus;

  const dim3 grid(static_cast<unsigned>(batch * ntiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    chunked_scan_fwd_kernel<float><<<grid, kThreads, 0, s>>>(p);
  } else {
    chunked_scan_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* chunked_scan_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
