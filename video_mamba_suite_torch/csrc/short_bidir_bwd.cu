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
// 2 x 308 M state updates (0.18 ms). So operations bound it, and the three
// exponentials per state update (forward pass, segment recompute, reverse
// step) go to the special-function units on top.
//
// Design (right and simple first): one thread per (row, channel) and one
// grid slice per direction, as in the forward kernel; each block loops
// over a fixed set of rows. Per row:
//   pass 1 walks forward, keeps the state in fp32 registers, stores it to
//          shared memory every kSeg steps (checkpoints), and computes the
//          gate's backward dz from y_t on the way;
//   pass 2 walks the segments backwards: it recomputes the kSeg states of
//          a segment from its checkpoint into registers, then runs the
//          adjoint walk over them. h_{t-1} is never rebuilt as
//          (h_t - dt u B) / a_t, which blows up where a_t underflows.
// dB and dC are sums over channels: each step reduces its 32 values (dB
// and dC for 16 states) across the warp with one transposing butterfly
// (31 shuffles, lane l ends with value l), the warps' results go to shared
// memory, and the block writes one fp32 partial per (channel block, row,
// step, state). dA, dD and dbias are sums over rows: each thread keeps them
// in registers over its block's rows and writes one fp32 partial per row
// group. The wrapper sums the partials with torch.sum, so the result does
// not depend on the order in which blocks run (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeqlen = 64;
constexpr int kMaxDstate = 16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 4;  // steps between state checkpoints

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
__global__ void __launch_bounds__(kThreads)
    short_bidir_bwd_kernel(Direction fwd, Direction bwd, int batch,
                           int seqlen, int dim, int dstate) {
  extern __shared__ float smem[];
  float* sB = smem;                              // [t][16], fp32, zero-padded
  float* sC = sB + seqlen * kMaxDstate;          // [t][16]
  float* red = sC + seqlen * kMaxDstate;         // [warp][t][32]
  float* ck = red + kWarps * seqlen * 32;        // [segment-1][16][thread]

  const bool reverse = blockIdx.z == 1;
  const Direction p = reverse ? bwd : fwd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ch = blockIdx.y * kThreads + tid;
  // Threads past the last channel load zeros (their state and cotangents
  // stay 0) and store nothing, but take part in the shuffles.
  const bool active = ch < dim;
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

  for (int64_t row = blockIdx.x; row < batch; row += gridDim.x) {
    __syncthreads();  // the previous row is done with sB, sC and red
    const int64_t bc_off = row * seqlen * dstate;
    const T* Bp = static_cast<const T*>(p.B) + bc_off;
    const T* Cp = static_cast<const T*>(p.C) + bc_off;
    for (int i = tid; i < seqlen * kMaxDstate; i += kThreads) {
      const int t = i / kMaxDstate;
      const int k = i % kMaxDstate;
      sB[i] = k < dstate ? to_float(Bp[t * dstate + k]) : 0.f;
      sC[i] = k < dstate ? to_float(Cp[t * dstate + k]) : 0.f;
    }
    __syncthreads();
    const int64_t base = row * seqlen * dim + ch;

    // pass 1: forward states, checkpoints and the gate's backward
    float h[kMaxDstate];
#pragma unroll
    for (int k = 0; k < kMaxDstate; ++k) h[k] = 0.f;
    for (int i = 0; i < seqlen; ++i) {
      if (i > 0 && i % kSeg == 0) {
        float* c = ck + (i / kSeg - 1) * kMaxDstate * kThreads + tid;
#pragma unroll
        for (int k = 0; k < kMaxDstate; ++k) c[k * kThreads] = h[k];
      }
      const int t = reverse ? seqlen - 1 - i : i;
      const int64_t off = base + static_cast<int64_t>(t) * dim;
      const float uv = active ? to_float(u[off]) : 0.f;
      const float dt = softplus((active ? to_float(dtp[off]) : 0.f) + bias);
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
      const float* c = ck + (s > 0 ? s - 1 : 0) * kMaxDstate * kThreads + tid;
#pragma unroll
      for (int k = 0; k < kMaxDstate; ++k) {
        hp[k] = s > 0 ? c[k * kThreads] : 0.f;
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
          const int t = reverse ? seqlen - 1 - i : i;
          const int64_t off = base + static_cast<int64_t>(t) * dim;
          const float uv = active ? to_float(u[off]) : 0.f;
          const float x = (active ? to_float(dtp[off]) : 0.f) + bias;
          const float dt = softplus(x);
          us[j] = uv;
          dts[j] = dt;
          dsp[j] = softplus_grad(x);
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
        const int t = reverse ? seqlen - 1 - i : i;
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
    const int64_t part = (static_cast<int64_t>(blockIdx.y) * batch + row) *
                         seqlen * dstate;
    for (int i = tid; i < seqlen * dstate; i += kThreads) {
      const int t = i / dstate;
      const int k = i % dstate;
      float sb = 0.f;
      float sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += red[(w * seqlen + t) * 32 + k];
        sc += red[(w * seqlen + t) * 32 + kMaxDstate + k];
      }
      p.dB[part + i] = sb;
      p.dC[part + i] = sc;
    }
  }

  if (active) {
    const int64_t prow = static_cast<int64_t>(blockIdx.x) * dim + ch;
    for (int k = 0; k < dstate; ++k) p.dA[prow * dstate + k] = dA[k];
    p.dD[prow] = dD;
    p.dbias[prow] = dbias;
  }
}

template <typename T>
int launch(const Direction& f, const Direction& b, long long batch,
           int seqlen, int dim, int dstate, int groups, cudaStream_t s) {
  const int nseg = (seqlen + kSeg - 1) / kSeg;
  const size_t smem =
      sizeof(float) * (2 * seqlen * kMaxDstate + kWarps * seqlen * 32 +
                       (nseg - 1) * kMaxDstate * kThreads);
  cudaError_t err = cudaFuncSetAttribute(
      short_bidir_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(groups),
                  static_cast<unsigned>((dim + kThreads - 1) / kThreads), 2);
  short_bidir_bwd_kernel<T><<<grid, kThreads, smem, s>>>(
      f, b, static_cast<int>(batch), seqlen, dim, dstate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches both directions on `stream`. dtype: 0 float32, 1 bfloat16 (u,
// dt, z, B, C, g, du, ddt and dz share it; A, D, bias and every partial are
// float32). `groups` row groups (1 <= groups <= batch) each write one
// partial of dA, dD and dbias. Returns the cudaError_t of the launch (0 on
// success).
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
      groups < 1 || groups > batch || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Direction f{uf, dtf, zf, Bf, Cf, static_cast<const float*>(Af),
                    static_cast<const float*>(Df),
                    static_cast<const float*>(biasf), gf, duf, ddtf, dzf,
                    static_cast<float*>(dAf), static_cast<float*>(dBf),
                    static_cast<float*>(dCf), static_cast<float*>(dDf),
                    static_cast<float*>(dbiasf)};
  const Direction b{ub, dtb, zb, Bb, Cb, static_cast<const float*>(Ab),
                    static_cast<const float*>(Db),
                    static_cast<const float*>(biasb), gb, dub, ddtb, dzb,
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
