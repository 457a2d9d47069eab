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
//          updates, 0.93 GFLOP, about 14 us;
//   exp:   155 M exponentials a walk on the special function units (16
//          results a clock an SM), about 42 us a walk.
// So the bound is the bytes, with the exponentials close behind.
//
// Design. The recurrence is sequential in time, and at the main shape there
// are only 8 x 384 = 3072 independent (row, channel) recurrences (384 at
// batch 1), too few to fill 132 SMs. So a grid that leaves half the card
// idle splits the walk in time into G segments (G = 4, 8 or 16: the most
// that keep within 1.25 waves of resident blocks, each at least
// kMinSegment steps; 2 would walk the whole length twice), one block each,
// and the G blocks
// of one (row, 32 channels) form a thread block cluster (above 8 blocks,
// a non-portable size):
//   pass 1:  every block but the last walks its segment from a zero state
//            and leaves the end state and the segment's sum of dt in its
//            shared memory;
//   combine: after a cluster barrier each block chains the segments before
//            it in walk order from the initial state, reading their end
//            states from the other blocks' shared memory (distributed
//            shared memory), H <- exp(A * sum dt) * H + end state (the
//            decay of a segment is exactly exp(A * sum dt));
//   pass 2:  every block walks its segment again from that state, writing
//            y and the checkpoints; the last block writes the last state.
// A grid that fills the card alone takes G = 1: one walk, no pass 1.
// A block is scan_lanes.cuh's unit shape: 128 threads, 32 channels of one
// group, a channel's 16 states split over 4 lanes (4 a lane). It walks its
// segment kUnit steps at a time (scan_fwd.cuh's `run_segment` and
// `launch_split`, which K7 shares), pipelined over three units with one
// block barrier a unit: unit n + 2's u, dt, z (kUnit x 32) and B, C
// (kUnit x 16) arrive in shared memory by 16-byte cp.async (element copies
// where a pointer, stride or width does not allow them), each thread's
// copies at offsets computed once a segment; unit n + 1 is prepared:
// softplus(dt + bias), dt u, D u and the gate once a (step, channel) into
// fp32 working tiles, B and C widened once; unit n is walked: B and C read
// as float4 broadcasts, the decays exp2 of dt A log2(e) on the special
// function unit, each step's partial y kept in registers and summed over
// the 4 lanes after the unit (12 shuffles, off the dependent chain); y
// leaves through a shared tile as 16-byte stores after the next barrier,
// the checkpoints as float4 stores. Rows past the segment's end are exact
// identities (dt = 0), so every unit walks its kUnit rows with no branch
// a step. Nothing is padded in device memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_fwd.cuh"
#include "scan_lanes.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace scan_lanes;
using namespace scan_fwd;

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
  int chunk;     // walk steps between checkpoints
  int nchunks;
  int width;     // channels a group
  int tiles;     // 32-channel tiles a group
  int nseg;      // segments (blocks of a cluster) a (row, tile): G
  int seglen;    // walk steps a segment (a multiple of kUnit)
  int reverse, softplus;
};

// Walk the segment of walk steps [seg0, seg1) from the state h (in and
// out) through scan_fwd.cuh's pipeline. Pass 1 (!kOut) leaves h as the end
// state and adds to dtsum; pass 2 writes y and, with kCk, the checkpoints.
template <typename T, bool kVec, bool kOut, bool kCk>
__device__ void walk_segment(const Params& p, const FwdTiles<T>& w,
                             const UnitPlace& q, const FwdLane& L,
                             const Copies& cp, int seg0, int seg1,
                             float (&h)[kStates], float& dtsum) {
  const int left = p.dstate - L.q4;
  const bool vec = p.dstate % kStates == 0;
  const int64_t ck_stride = static_cast<int64_t>(p.dim) * p.dstate;
  // the next checkpoint (walk step ck_next) and where the lane stores it
  int ck_next = 0;
  float* ck = nullptr;
  if constexpr (kCk) {
    const int first = (seg0 + p.chunk - 1) / p.chunk;
    ck_next = first * p.chunk;
    ck = p.states + ((q.row * p.nchunks + first) * p.dim + L.ch) * p.dstate +
         L.q4;
  }
  run_segment<T, kVec, kOut>(p, w, q, cp, seg0, seg1,
                             [&](int n, int i0, int i1) {
    uint32_t ckmask = 0;
    if constexpr (kCk) {
      ckmask = checkpoint_mask(ck_next, p.chunk, i0, i1);
      if (!L.active) ckmask = 0;
    }
    walk_unit<T, kOut, kCk>(w, n, L, h, dtsum, ckmask, ck, ck_stride, left,
                            vec);
  });
}

template <typename T, bool kVec, bool kCk>
__global__ void __launch_bounds__(kThreads, 5)
    chunked_scan_fwd_lanes(Params p) {
  extern __shared__ float4 smem4[];
  const FwdTiles<T> w(smem4);

  // block -> (row, group, tile, segment); the nseg blocks of a (row, tile)
  // are consecutive, one cluster
  const int seg = static_cast<int>(blockIdx.x % p.nseg);
  const UnitPlace q = unit_place(p, blockIdx.x / p.nseg);
  const Copies cp = copies<T>(q.valid, p.dstate);
  const FwdLane L = fwd_lane(p, q);
  float h[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const int n = L.q4 + k;
    h[k] = L.active && n < p.dstate && p.h0
               ? p.h0[(q.row * p.dim + L.ch) * p.dstate + n] : 0.f;
  }

  const int seg0 = seg * p.seglen;
  const int seg1 = min(p.seqlen, seg0 + p.seglen);
  if (p.nseg > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    float e[kStates] = {0.f, 0.f, 0.f, 0.f};
    float dtsum = 0.f;
    if (seg + 1 < p.nseg) {
      walk_segment<T, kVec, false, false>(p, w, q, L, cp, seg0, seg1, e,
                                          dtsum);
    }
    w.carry[threadIdx.x] = make_float4(e[0], e[1], e[2], e[3]);
    if (L.quarter == 0) w.dtsum[L.cw] = dtsum;
    cluster.sync();  // every segment's end state is in its block
    // the state entering this segment: the initial state carried through
    // the segments before it
#pragma unroll
    for (int s = 0; s < kMaxSegments - 1; ++s) {
      if (s < seg) {
        const float4 E = *cluster.map_shared_rank(w.carry + threadIdx.x, s);
        const float S = *cluster.map_shared_rank(w.dtsum + L.cw, s);
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          h[k] = fmaf(exp2_sfu(S * L.A2[k]), h[k], at(E, k));
        }
      }
    }
    cluster.sync();  // no block leaves while another reads its carry
  }

  float unused = 0.f;
  walk_segment<T, kVec, true, kCk>(p, w, q, L, cp, seg0, seg1, h, unused);
  if (seg + 1 == p.nseg && p.last && L.active) {
    store_state(p.last + (q.row * p.dim + L.ch) * p.dstate + L.q4, h,
                p.dstate - L.q4, p.dstate % kStates == 0);
  }
}

// Pick the segments a (row, tile) (`launch_split`) and launch, the nseg
// blocks of a (row, tile) as one cluster.
template <typename T, bool kVec, bool kCk>
int launch_kernel(const Params& p, long long batch, cudaStream_t s) {
  constexpr int smem = static_cast<int>(FwdTiles<T>::bytes());
  static_assert(smem <= 48 * 1024, "no opt-in to more shared memory");
  static LaunchCache cache;
  const long long units = batch * p.ngroups * static_cast<long long>(p.tiles);
  return launch_split(chunked_scan_fwd_lanes<T, kVec, kCk>, p, units, smem,
                      cache, s);
}

template <typename T>
int launch(const Params& p, long long batch, cudaStream_t s) {
  const bool vec = vec_ok({p.u, p.dt, p.z, p.B, p.C, p.out}, p.dim, p.width,
                          p.dstate, sizeof(T));
  if (p.states) {
    return vec ? launch_kernel<T, true, true>(p, batch, s)
               : launch_kernel<T, false, true>(p, batch, s);
  }
  return vec ? launch_kernel<T, true, false>(p, batch, s)
             : launch_kernel<T, false, false>(p, batch, s);
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
  p.width = dim / ngroups;
  p.tiles = (p.width + kChannels - 1) / kChannels;
  p.nseg = 1;
  p.seglen = seqlen;
  p.reverse = reverse;
  p.softplus = softplus;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, batch, s);
  return launch<__nv_bfloat16>(p, batch, s);
}

const char* chunked_scan_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
