// Selective scan with complex A, backward, for Hopper (sm_90a): kernel K8.
//
// Replaces the TPU kernel `_cbwd_kernel` in
// video_mamba_suite_tpu/ops/selective_scan_pallas.py, launched from
// `_complex_core_bwd` (the VJP of `_complex_core`). It is the adjoint of
// complex_scan_fwd.cu (K7), computed from K7's checkpoints: the two-channel
// state before every `chunk`-th step of the walk. Per (row, channel), with
// a_t = mag (cos + i sin), mag = exp(dt_t Ar), ang = dt_t Ai, the cotangent
// g_t of the output and (glastr, glasti) of the last state, walking the
// steps backwards:
//
//     dz_t  = g_t * y_t * (s + silu * (1 - s))     (s = sigmoid(z_t))
//     gy_t  = g_t * silu(z_t)
//     dhr  += 2 C_t gy_t                           (y reads the real channel)
//     dcar  = dhr hr_{t-1} + dhi hi_{t-1},  dcai = dhi hr_{t-1} - dhr hi_{t-1}
//     dmag  = dcar cos + dcai sin,          dang = dcai Re(a) - dcar Im(a)
//     dAr  += dmag mag dt_t,                dAi += dang dt_t
//     dC_t  = sum_d 2 gy_t hr_t,            dB_t = sum_d dhr dt_t u_t
//     ddt_t = (sum_n dmag mag Ar + dang Ai + u_t sum_n dhr B_t)
//             * sigmoid(dt_t + bias)        (with softplus)
//     du_t  = dt_t sum_n dhr B_t + gy_t D,  dD = sum gy_t u_t, dbias = sum ddt
//     (dhr, dhi) <- conj(a_t) (dhr, dhi)    (dh_{t-1} = conj(a_t) dh_t)
//
// and (dh0r, dh0i) is the adjoint left after the first step. dB and dC go
// to the group d / (dim / G) of their channel.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores), at the scan microbench shape (batch 8, L 2048, dim 1024,
// dstate 16, fp32 I/O, a checkpoint every 16 steps): it reads u, dt, z and
// g and writes du, ddt and dz, seven tensors of 67 MB, and reads 2 x 67 MB
// of checkpoints: about 610 MB, 182 us. The arithmetic (the forward
// recompute, about 20 operations per complex state update, and the adjoint
// step, about 35) is some 14.8 GFLOP, 220 us, counting each transcendental
// as one operation. So the operations bound it.
//
// Design (simple and right first): one thread per (row, channel), a warp
// on 32 channels of one group (lanes past the group's width load zeros and
// store nothing). Each thread walks the chunks from the last: it recomputes
// the chunk's states forward from its checkpoint into an array in its local
// memory (h_{t-1} is never rebuilt by dividing by a_t, which fails where
// a_t underflows), then runs the adjoint step above backwards over them.
// Reductions without atomics, so the result does not depend on the order in
// which blocks run: dB and dC are summed over the warp's 32 channels with a
// transposing butterfly (16 shuffles for 16 values, as in
// chunked_scan_bwd.cu) and written as one fp32 partial per 32-channel tile;
// dAr, dAi, dD and dbias are written per row. The wrapper adds the partials
// with torch.sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDstate = 16;
constexpr int kMaxChunk = 16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

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
  float* dAr;            // (batch, dim, dstate) partials
  float* dAi;
  float* dB;             // (tiles, batch, seqlen, ngroups, dstate) partials
  float* dC;
  float* dD;             // (batch, dim) partials or null
  float* dbias;          // (batch, dim) partials or null
  float* dh0r;           // (batch, dim, dstate)
  float* dh0i;
  long long batch;
  int seqlen, dim, dstate, ngroups;
  int chunk, nchunks;
  int width;  // channels per group
  int tiles;  // 32-channel tiles per group
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

template <typename T>
__global__ void __launch_bounds__(kThreads) complex_scan_bwd_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (w >= p.batch * p.ngroups * p.tiles) return;  // whole warps
  const int tile = static_cast<int>(w % p.tiles);
  const int group = static_cast<int>((w / p.tiles) % p.ngroups);
  const long long row = w / (static_cast<long long>(p.tiles) * p.ngroups);
  const int cw = tile * 32 + lane;
  const bool active = cw < p.width;
  const int ch = group * p.width + min(cw, p.width - 1);

  float Ar[kMaxDstate], Ai[kMaxDstate], dhr[kMaxDstate], dhi[kMaxDstate];
  float dAr[kMaxDstate], dAi[kMaxDstate];
  const long long sidx = (row * p.dim + ch) * p.dstate;
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    const bool on = k < p.dstate;
    Ar[k] = on ? p.Ar[ch * p.dstate + k] : 0.f;
    Ai[k] = on ? p.Ai[ch * p.dstate + k] : 0.f;
    dhr[k] = (on && active && p.glastr) ? p.glastr[sidx + k] : 0.f;
    dhi[k] = (on && active && p.glasti) ? p.glasti[sidx + k] : 0.f;
    dAr[k] = 0.f;
    dAi[k] = 0.f;
  }
  const float bias = p.bias ? p.bias[ch] : 0.f;
  const float D = p.D ? p.D[ch] : 0.f;
  float dD = 0.f, dbias = 0.f;

  const T* u = static_cast<const T*>(p.u);
  const T* dtp = static_cast<const T*>(p.dt);
  const T* z = static_cast<const T*>(p.z);
  const T* gp = static_cast<const T*>(p.g);
  const long long base = row * p.seqlen * p.dim + ch;
  const long long bc_step = static_cast<long long>(p.ngroups) * p.dstate;
  const T* Bp = static_cast<const T*>(p.B) + row * p.seqlen * bc_step +
                group * p.dstate;
  const T* Cp = static_cast<const T*>(p.C) + row * p.seqlen * bc_step +
                group * p.dstate;

  // the chunk's states: [0] its checkpoint, [s + 1] after its step s
  float tr[kMaxChunk + 1][kMaxDstate], ti[kMaxChunk + 1][kMaxDstate];

  for (int c = p.nchunks - 1; c >= 0; --c) {
    const int i_lo = c * p.chunk;
    const int i_hi = min(i_lo + p.chunk, p.seqlen);
    const long long soff = ((row * p.nchunks + c) * p.dim + ch) * p.dstate;
#pragma unroll
    for (int k = 0; k < kMaxDstate; ++k) {
      tr[0][k] = k < p.dstate ? p.statesr[soff + k] : 0.f;
      ti[0][k] = k < p.dstate ? p.statesi[soff + k] : 0.f;
    }
    for (int i = i_lo; i < i_hi; ++i) {  // the forward again
      const int s = i - i_lo;
      const int t = p.reverse ? p.seqlen - 1 - i : i;
      const long long off = base + static_cast<long long>(t) * p.dim;
      float dt = to_float(dtp[off]) + bias;
      if (p.softplus) dt = softplus(dt);
      const float dtu = dt * (active ? to_float(u[off]) : 0.f);
      const T* Bt = Bp + t * bc_step;
#pragma unroll
      for (int k = 0; k < kMaxDstate; ++k) {
        if (k < p.dstate) {
          const float mag = expf(dt * Ar[k]);
          float sn, cs;
          sincosf(dt * Ai[k], &sn, &cs);
          const float car = mag * cs;
          const float cai = mag * sn;
          tr[s + 1][k] = car * tr[s][k] - cai * ti[s][k] +
                         dtu * to_float(Bt[k]);
          ti[s + 1][k] = cai * tr[s][k] + car * ti[s][k];
        }
      }
    }
    for (int i = i_hi - 1; i >= i_lo; --i) {  // the adjoint
      const int s = i - i_lo;
      const int t = p.reverse ? p.seqlen - 1 - i : i;
      const long long off = base + static_cast<long long>(t) * p.dim;
      const float uv = active ? to_float(u[off]) : 0.f;
      const float gv = active ? to_float(gp[off]) : 0.f;
      const float dt_pre = to_float(dtp[off]) + bias;
      const float dt = p.softplus ? softplus(dt_pre) : dt_pre;
      const float dtu = dt * uv;
      const T* Bt = Bp + t * bc_step;
      const T* Ct = Cp + t * bc_step;
      float gy = gv;
      float dzv = 0.f;
      if (z) {
        float y = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxDstate; ++k) {
          if (k < p.dstate) y += to_float(Ct[k]) * tr[s + 1][k];
        }
        y = 2.f * y + (p.D ? D * uv : 0.f);
        const float zv = to_float(z[off]);
        const float sg = sigmoid(zv);
        const float silu = zv * sg;
        dzv = gv * y * (sg + silu * (1.f - sg));
        gy = gv * silu;
      }
      float dB[kMaxDstate], dC[kMaxDstate];
      float dh_b = 0.f, ddt = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDstate; ++k) {
        dB[k] = 0.f;
        dC[k] = 0.f;
        if (k < p.dstate) {
          const float mag = expf(dt * Ar[k]);
          float sn, cs;
          sincosf(dt * Ai[k], &sn, &cs);
          const float car = mag * cs;
          const float cai = mag * sn;
          const float Bk = to_float(Bt[k]);
          dhr[k] += 2.f * to_float(Ct[k]) * gy;
          const float hrp = tr[s][k];
          const float hip = ti[s][k];
          const float dcar = dhr[k] * hrp + dhi[k] * hip;
          const float dcai = dhi[k] * hrp - dhr[k] * hip;
          const float dmm = (dcar * cs + dcai * sn) * mag;
          const float dang = dcai * car - dcar * cai;
          dAr[k] += dmm * dt;
          dAi[k] += dang * dt;
          dC[k] = 2.f * gy * tr[s + 1][k];
          dB[k] = dhr[k] * dtu;
          dh_b += dhr[k] * Bk;
          ddt += dmm * Ar[k] + dang * Ai[k];
          const float nr = car * dhr[k] + cai * dhi[k];
          dhi[k] = car * dhi[k] - cai * dhr[k];
          dhr[k] = nr;
        }
      }
      ddt += dh_b * uv;
      if (p.softplus) ddt *= softplus_grad(dt_pre);
      dbias += ddt;
      dD += gy * uv;
      if (active) {
        static_cast<T*>(p.du)[off] = from_float<T>(dh_b * dt + gy * D);
        static_cast<T*>(p.ddt)[off] = from_float<T>(ddt);
        if (z) static_cast<T*>(p.dz)[off] = from_float<T>(dzv);
      }
      const float sb = warp_transpose_sum(dB, lane);
      const float sc = warp_transpose_sum(dC, lane);
      if (lane < p.dstate) {
        const long long poff =
            ((tile * p.batch + row) * p.seqlen + t) * bc_step +
            group * p.dstate + lane;
        p.dB[poff] = sb;
        p.dC[poff] = sc;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    if (k < p.dstate) {
      p.dh0r[sidx + k] = dhr[k];
      p.dh0i[sidx + k] = dhi[k];
      p.dAr[sidx + k] = dAr[k];
      p.dAi[sidx + k] = dAi[k];
    }
  }
  if (p.dD) p.dD[row * p.dim + ch] = dD;
  if (p.dbias) p.dbias[row * p.dim + ch] = dbias;
}

}  // namespace

extern "C" {

// Launches K8 on `stream`. dtype: 0 float32, 1 bfloat16 (u, dt, z, B, C, g,
// du, ddt and dz share it; everything else is float32). B and C are
// (batch, seqlen, ngroups, dstate) with dim divisible by ngroups; the
// checkpoints are K7's with the same `chunk` (1 to 16). z (with dz), D
// (with dD), bias (with dbias) and glastr/glasti (both or neither) may be
// null. Returns the cudaError_t of the launch (0 on success).
int complex_scan_bwd(int dtype, long long batch, int seqlen, int dim,
                     int dstate, int ngroups, int reverse, int softplus,
                     int chunk, const void* u, const void* dt, const void* z,
                     const void* B, const void* C, const void* Ar,
                     const void* Ai, const void* D, const void* bias,
                     const void* statesr, const void* statesi, const void* g,
                     const void* glastr, const void* glasti, void* du,
                     void* ddt, void* dz, void* dAr, void* dAi, void* dB,
                     void* dC, void* dD, void* dbias, void* dh0r, void* dh0i,
                     void* stream) {
  if (batch < 1 || seqlen < 1 || dim < 1 || dstate < 1 ||
      dstate > kMaxDstate || ngroups < 1 || dim % ngroups != 0 ||
      (dtype != 0 && dtype != 1) || chunk < 1 || chunk > kMaxChunk ||
      (!glastr) != (!glasti) || (!z) != (!dz) || (!D) != (!dD) ||
      (!bias) != (!dbias) || !statesr || !statesi || !g) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = dim / ngroups;
  const int tiles = (width + 31) / 32;
  const long long warps = batch * ngroups * tiles;
  const long long blocks = (warps + kWarps - 1) / kWarps;
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
  p.batch = batch;
  p.seqlen = seqlen;
  p.dim = dim;
  p.dstate = dstate;
  p.ngroups = ngroups;
  p.chunk = chunk;
  p.nchunks = (seqlen + chunk - 1) / chunk;
  p.width = width;
  p.tiles = tiles;
  p.reverse = reverse;
  p.softplus = softplus;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (dtype == 0) {
    complex_scan_bwd_kernel<float><<<grid, kThreads, 0, s>>>(p);
  } else {
    complex_scan_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* complex_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
