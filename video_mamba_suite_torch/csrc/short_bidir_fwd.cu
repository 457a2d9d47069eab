// Fused bidirectional short selective scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_short_bidir_fwd_kernel` in
// video_mamba_suite_tpu/ops/selective_scan_pallas.py (launched from
// `_short_bidir_fwd_impl`, reached through `selective_scan_pallas_bidir`).
// It runs both directions of a bidirectional Mamba mixer in one launch for
// sequences of at most 64 steps: a causal scan of (uf, dtf, Af, Bf, Cf) and
// an anti-causal scan of (ub, dtb, Ab, Bb, Cb), each with the dt bias added
// in fp32, softplus, the D skip and the SiLU(z) gate. Both outputs are in
// forward time order. Per (row, channel, state):
//
//     dt_t = softplus(dt_t + bias)
//     h_t  = exp(dt_t * A) * h_{t-1} + dt_t * u_t * B_t
//     y_t  = (sum_n C_t * h_t + D * u_t) * silu(z_t)
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores), at TimeMamba-B's shape (batch 1568 = 8 clips x 196
// patches, seqlen 16, dim 768, dstate 16, bf16 I/O):
//   bytes: 8 (b,l,d) bf16 tensors of 38.5 MB (u, dt, z in and y out, per
//          direction) plus 3.2 MB of B/C = 311.5 MB, about 93 us;
//   fp32:  about 6 operations for each of 2 x 308 M state updates,
//          3.7 GFLOP, about 55 us;
//   exp:   616.6 M exponentials on the special function units (16 results
//          a clock an SM), about 0.15-0.17 ms, and the softplus and gate
//          take about 4 more a (step, channel): 25% on top.
// So the roofline bound is the bytes, but the special function units set
// the pace. No tensor-core instruction applies: the recurrence is
// elementwise.
//
// Design: one block of 128 threads takes 128 channels of one row and one
// direction (grid z), one thread a channel with its 16 fp32 states in
// registers (there are 2 x 1.2 M recurrences, plenty to fill the card, so
// no lane split: each step's softplus, gate and B/C loads are paid once
// for 16 states). Before the walk the block stages the whole tile (seqlen
// <= 64 makes it fit): u, dt and z (seqlen x 128) and the row's B and C,
// by 16-byte cp.async (element copies where a pointer, stride or width
// does not allow them), in walk order (the anti-causal direction is
// staged back to front, never flipped), each thread stepping one pointer
// down its column, and widens B and C to fp32 once (zero past dstate).
// The walk then touches no device memory: each step reads its u, dt, z
// from shared memory, computes softplus, dt u and the gate once, the 16
// decays as exp2 of dt A log2(e) on the special function unit, reads B and
// C as float4 broadcasts, and writes y in place over u's slot; the tile
// leaves as 16-byte stores. Eight blocks an SM (64 registers a thread)
// overlap one block's copies with the others' walks. (Staging in groups
// of 8 steps, each walked as it arrived, ran slower on an H100.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_fwd.cuh"
#include "scan_lanes.cuh"

namespace {

using namespace scan_lanes;

constexpr int kMaxSeqlen = kMaxSteps;
constexpr int kUnits = 4;                          // 32-channel units a block
constexpr int kBlockChannels = kUnits * kChannels;  // 128, one a thread
static_assert(kBlockChannels == kThreads, "one thread a channel");

struct Direction {
  const void* u;      // (batch, seqlen, dim)
  const void* dt;     // (batch, seqlen, dim), before bias and softplus
  const void* z;      // (batch, seqlen, dim) or null
  const void* B;      // (batch, seqlen, dstate)
  const void* C;      // (batch, seqlen, dstate)
  const float* A;     // (dim, dstate)
  const float* D;     // (dim,) or null
  const float* bias;  // (dim,) or null
  void* out;          // (batch, seqlen, dim)
};

// Both directions, read by the grid's z index (an array in the parameter
// space, not a struct copied by a runtime select).
struct Directions {
  Direction d[2];
};

// Shared memory of one block for seqlen S: u, dt, z [S][128] and B, C
// [S][16] in the I/O type, then B and C widened to fp32 (each offset a
// multiple of 16 bytes).
__host__ __device__ constexpr int raw_elems(int S) {
  return S * (3 * kBlockChannels + 2 * kMaxDstate);
}
template <typename T>
size_t smem_bytes(int S) {
  return sizeof(T) * raw_elems(S) + sizeof(float) * 2 * S * kMaxDstate;
}

// One (S x 128) channel tile of `src` (nothing without src) into `dst`,
// rows in walk order: row i is time S - 1 - i when `reverse`. `base` is
// the element of time 0 and the block's first channel; channels at or
// past `valid` are zero. 16-byte cp.async copies with kVec (the caller
// commits them), each thread one column of 16 bytes stepping down the
// rows; else element copies, a thread a channel.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_tile(T* dst, const T* src,
                                           int64_t base, int S, int dim,
                                           int valid, bool reverse) {
  if (!src) return;
  const int64_t step = reverse ? -static_cast<int64_t>(dim) : dim;
  const T* row0 = src + base + (reverse ? static_cast<int64_t>(S - 1) * dim
                                        : 0);
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kRow = kBlockChannels / kPer;   // copies a row
    constexpr int kPass = kThreads / kRow;        // rows a pass
    const int c = (threadIdx.x % kRow) * kPer;
    const int n = max(0, min(kPer, valid - c)) * static_cast<int>(sizeof(T));
    for (int i = threadIdx.x / kRow; i < S; i += kPass) {
      cp_async16(dst + i * kBlockChannels + c, n ? row0 + i * step + c : src,
                 n);
    }
  } else {
    const int c = threadIdx.x;
    for (int i = 0; i < S; ++i) {
      dst[i * kBlockChannels + c] =
          c < valid ? row0[i * step + c] : from_float<T>(0.f);
    }
  }
}

// The output tile (walk order) to device memory, as `stage_tile` reads
// it: 16-byte stores with kVec.
template <typename T, bool kVec>
__device__ __forceinline__ void store_tile(T* dst, const T* tile,
                                           int64_t base, int S, int dim,
                                           int valid, bool reverse) {
  const int64_t step = reverse ? -static_cast<int64_t>(dim) : dim;
  T* row0 = dst + base + (reverse ? static_cast<int64_t>(S - 1) * dim : 0);
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kRow = kBlockChannels / kPer;
    constexpr int kPass = kThreads / kRow;
    const int c = (threadIdx.x % kRow) * kPer;
    if (c >= valid) return;   // valid is a multiple of kPer here
    for (int i = threadIdx.x / kRow; i < S; i += kPass) {
      *reinterpret_cast<uint4*>(row0 + i * step + c) =
          *reinterpret_cast<const uint4*>(tile + i * kBlockChannels + c);
    }
  } else {
    const int c = threadIdx.x;
    if (c >= valid) return;
    for (int i = 0; i < S; ++i) {
      row0[i * step + c] = tile[i * kBlockChannels + c];
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 8)
    short_bidir_fwd_tile_kernel(Directions dirs, int seqlen, int dim,
                                int dstate) {
  extern __shared__ float4 smem4[];
  const int S = seqlen;
  const int tile = S * kBlockChannels;            // one tensor's tile
  T* ru = reinterpret_cast<T*>(smem4);            // u, then y in place
  T* rdt = ru + tile;
  T* rz = rdt + tile;
  T* rbc = rz + tile;                             // B, then C
  float* fbc = reinterpret_cast<float*>(ru + raw_elems(S));

  const bool reverse = blockIdx.z == 1;
  const Direction& p = dirs.d[blockIdx.z];
  const int cb = blockIdx.y * kBlockChannels;
  const int valid = min(kBlockChannels, dim - cb);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * seqlen * dim + cb;
  const T* zp = static_cast<const T*>(p.z);
  stage_tile<T, kVec>(ru, static_cast<const T*>(p.u), base, S, dim, valid,
                      reverse);
  stage_tile<T, kVec>(rdt, static_cast<const T*>(p.dt), base, S, dim, valid,
                      reverse);
  stage_tile<T, kVec>(rz, zp, base, S, dim, valid, reverse);
  UnitPlace q;   // the row's B and C, as scan_lanes.cuh stages them
  q.row = blockIdx.x;
  q.i0 = 0;
  q.nsteps = seqlen;
  q.ch0 = cb;
  q.valid = valid;
  q.group = 0;
  q.seqlen = seqlen;
  q.dim = dim;
  q.dstate = dstate;
  q.ngroups = 1;
  q.reverse = reverse;
  stage_states<T, kVec>(rbc, S, q, static_cast<const T*>(p.B));
  stage_states<T, kVec>(rbc + S * kMaxDstate, S, q,
                        static_cast<const T*>(p.C));
  cp_async_commit();

  // the thread's channel, loaded while the copies are in flight
  const int ch = cb + threadIdx.x;
  const bool active = static_cast<int>(threadIdx.x) < valid;
  float A2[kMaxDstate];
#pragma unroll
  for (int k = 0; k < kMaxDstate; ++k) {
    A2[k] = active && k < dstate ? p.A[ch * dstate + k] * kLog2e : 0.f;
  }
  const float bias = active && p.bias ? p.bias[ch] : 0.f;
  const float D = active && p.D ? p.D[ch] : 0.f;

  cp_async_wait_all();
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * S * kMaxDstate; e += kThreads) {
    fbc[e] = e % kMaxDstate < dstate ? to_float(rbc[e]) : 0.f;
  }
  __syncthreads();

  if (active) {
    float h[kMaxDstate];
#pragma unroll
    for (int k = 0; k < kMaxDstate; ++k) h[k] = 0.f;
    for (int i = 0; i < seqlen; ++i) {
      const int e = i * kBlockChannels + threadIdx.x;
      const float uv = to_float(ru[e]);
      const float dt = scan_fwd::softplus(to_float(rdt[e]) + bias);
      const float dtu = dt * uv;
      const float4* b4 = reinterpret_cast<const float4*>(fbc + i * kMaxDstate);
      const float4* c4 = reinterpret_cast<const float4*>(
          fbc + (S + i) * kMaxDstate);
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxDstate / 4; ++j) {
        const float4 b = b4[j];
        const float4 c = c4[j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = 4 * j + k;
          h[n] = fmaf(exp2_sfu(dt * A2[n]), h[n], dtu * at(b, k));
          y = fmaf(at(c, k), h[n], y);
        }
      }
      if (p.D) y = fmaf(D, uv, y);
      if (zp) y *= scan_fwd::silu(to_float(rz[e]));
      ru[e] = from_float<T>(y);
    }
  }
  __syncthreads();
  store_tile<T, kVec>(static_cast<T*>(p.out), ru, base, S, dim, valid,
                      reverse);
}

// 16-byte copies need every channel tensor's rows and B/C steps on
// 16-byte boundaries.
bool vec_ok(const Direction& d, int dim, int dstate, int esize) {
  const void* ptrs[] = {d.u, d.dt, d.z, d.B, d.C, d.out};
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % 16) return false;
  }
  return (dim * esize) % 16 == 0 && (dstate * esize) % 16 == 0;
}

template <typename T, bool kVec>
int launch_vec(const Direction& f, const Direction& b, long long batch,
               int seqlen, int dim, int dstate, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(seqlen);
  if (smem > 48 * 1024) {   // above the default: opt in (64 fp32 steps)
    const cudaError_t err = cudaFuncSetAttribute(
        short_bidir_fwd_tile_kernel<T, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(batch),
                  static_cast<unsigned>((dim + kBlockChannels - 1) /
                                        kBlockChannels),
                  2);
  short_bidir_fwd_tile_kernel<T, kVec><<<grid, kThreads, smem, s>>>(
      Directions{{f, b}}, seqlen, dim, dstate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Direction& f, const Direction& b, long long batch,
           int seqlen, int dim, int dstate, cudaStream_t s) {
  const int esize = sizeof(T);
  if (vec_ok(f, dim, dstate, esize) && vec_ok(b, dim, dstate, esize)) {
    return launch_vec<T, true>(f, b, batch, seqlen, dim, dstate, s);
  }
  return launch_vec<T, false>(f, b, batch, seqlen, dim, dstate, s);
}

}  // namespace

extern "C" {

// Launches both directions on `stream`. dtype: 0 float32, 1 bfloat16 (u,
// dt, z, B, C and the outputs share it; A, D and bias are float32). Returns
// the cudaError_t of the launch (0 on success).
int short_bidir_fwd(int dtype, long long batch, int seqlen, int dim,
                    int dstate,
                    const void* uf, const void* dtf, const void* zf,
                    const void* Bf, const void* Cf, const void* Af,
                    const void* Df, const void* biasf,
                    const void* ub, const void* dtb, const void* zb,
                    const void* Bb, const void* Cb, const void* Ab,
                    const void* Db, const void* biasb,
                    void* outf, void* outb, void* stream) {
  if (batch < 1 || batch > 0x7fffffffLL || seqlen < 1 ||
      seqlen > kMaxSeqlen || dim < 1 || dstate < 1 || dstate > kMaxDstate ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Direction f{uf, dtf, zf, Bf, Cf, static_cast<const float*>(Af),
                    static_cast<const float*>(Df),
                    static_cast<const float*>(biasf), outf};
  const Direction b{ub, dtb, zb, Bb, Cb, static_cast<const float*>(Ab),
                    static_cast<const float*>(Db),
                    static_cast<const float*>(biasb), outb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(f, b, batch, seqlen, dim, dstate, s);
  return launch<__nv_bfloat16>(f, b, batch, seqlen, dim, dstate, s);
}

const char* short_bidir_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
