// Whole-row multi-head attention, forward, for Hopper (sm_90a): kernels K10
// and K9 in one source.
//
// Replaces the TPU kernels `_row_mha_kernel` (K10, launched from
// `_row_mha_fwd_impl`, reached through `row_mha_qkv`) and `_mha_kernel`
// (K9, launched from `_mha_fwd_impl`, reached through `vision_mha`) in
// video_mamba_suite_tpu/ops/vision_attention.py. For every (instance, head)
// and query row i over N <= 512 tokens of any width dh:
//
//     s_ij = (q_i . k_j) * scale          (K10: fp32 scores times scale)
//     s_ij = (round(q_i * scale) . k_j)   (K9: q scaled in its own type)
//     w_ij = round(exp(s_ij - max_j s) / sum_j exp(s_ij - max_j s))
//     o_i  = sum_j w_ij v_j               (fp32 sum, rounded to the type)
//
// with the max and the sum taken in fp32 over the whole row (no online
// rescale of the weights) and `round` the rounding to the I/O type (fp32
// or bf16), which is where the TPU kernels cast the scaled q (K9) and the
// weights (both) before their products. Entry `row_mha_fwd` is K10, entry
// `vision_mha_fwd` K9; they differ only in where the scale is applied.
//
// Head widths above 128 run in 128-column slices (`slices` > 1): a block
// owns one slice of its output (grid: the slices of a row block are
// neighbours), the scores are summed over every slice as q and K stream
// through shared memory a slice at a time, and V comes in the output's
// slice alone; the last slice is zero-filled past dh. Registers and shared
// memory stay those of dh 128.
//
// Layout: q, k, v and out are each described by four strides in elements,
// (outer0, outer1, head, row), with the dh elements of a row contiguous. So
// one entry reads (I, H, N, dh) (outer1 = 1), the head-major packed
// (B, T, 3H, N, dh) qkv, and the projection's own (B, S, T, 3D) output
// (outer0 = B, outer1 = T, head stride dh, row stride T * 3D) in place, and
// writes the output straight into (B, S, T, D) for the output projection.
//
// What bounds it on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 in the tensor
// cores, 67 TFLOP/s fp32 outside them): at the EK100 MIR request (B 8, T 16,
// H 12, N 197, dh 64, bf16) q, k, v and out move 4 x 38.7 MB = 155 MB
// (46 us) and the two products take 2 x 2 x 1536 x 197^2 x 64 = 15.3 GFLOP
// (15 us on the tensor cores). So the bytes bound it, the (N, N) scores
// never touching device memory. K9 at the vision width (128 x 12 x 197 x
// 64, bf16) is the same work.
//
// Dispatch by type: bf16 runs on the tensor cores, K9 in
// `vision_mha_mma_kernel` and K10 in `row_mha_mma_kernel` (one body, which
// differs only where the scale is applied); fp32 (K9 and K10) runs
// `row_mha_kernel` on the CUDA cores. fp32 stays there on purpose: the TPU
// kernels' fp32 products are full fp32, and TF32 tensor cores (about three
// decimal digits) would not hold the fp32 tolerances. No bf16 input reaches
// the SIMT kernel.
//
// `row_mha_kernel` (SIMT, fp32 only): a block of 4 warps takes 32
// query rows of one (instance, head), 8 rows a warp. It stages those rows
// of q in shared memory as fp32, then walks the keys in tiles of 64: each
// tile of K is staged transposed (dh x 64, padded against bank conflicts)
// and each lane computes two keys' scores for the warp's 8 rows, reading q
// as float4 broadcasts. The fp32 scores of the block's rows over all N keys
// stay in shared memory (at most 32 x 512 floats). Each warp then takes its
// rows' exact max and sum with shuffles and overwrites the scores with the
// weights (0 past N). Last, tiles of V are staged and each lane
// accumulates up to 4 output columns (dh <= 128) for the 8 rows in fp32
// registers (kCols = 1, 2 or 4 columns, by dh). Every copy into shared
// memory keeps 8 loads a thread in flight. Ragged N and dh are zero-padded
// in shared memory, so no padded key or column can reach a sum. Shared
// memory: 32 x dh (q) + 32 x ceil(N / 64) x 64 (scores) + about 68 x dh (a
// K or V tile) floats, at most 114 KB (58 KB at the MIR shape: 3 blocks an
// SM). Why bf16 does not run it: every FMA fed from fp32 operands in shared
// memory (at 67 TFLOP/s the products alone take 0.23 ms, 5x the bound); q,
// k and v widened to fp32 in shared memory (twice the bytes) by synchronous
// loads that overlap no arithmetic; 58 KB of scores a block (3 blocks an
// SM); and K and V read again for every 32 rows (7 times per (instance,
// head) at N = 197): in bf16 it took 2.1 ms at the MIR shape, 46x its
// bound.
//
// `vision_mha_mma_kernel` and `row_mha_mma_kernel` (bf16 on the tensor
// cores; attention_mma.cuh, one body `whole_row_mma`): one block of up to
// kMmaWarps warps takes up to 16 x kMmaWarps query rows of one (instance,
// head), 16 rows a warp, their q in registers as bf16 A fragments: K9's
// scaled by the bf16 scale and rounded to bf16 there, K10's as they are,
// its fp32 sums multiplied by the fp32 scale (the products run on bf16
// operands with fp32 sums, exactly the TPU kernels'). The rows need the
// whole row's max and sum before any weight is rounded, so the keys are
// walked twice (design (b)): the first walk over K takes each row's max
// and sum in fp32 (the sum rescaled when the max grows, so no score is
// kept), the second recomputes each tile's scores (the products are cheap
// on the tensor cores), forms w = round(exp(s - max) / sum) in registers
// and multiplies it by V. exp is exp2 of the scores in log2 units, and the
// division is the correctly rounded quotient from the row's reciprocal
// (Markstein's correction), so no weight takes a reciprocal of its own on
// the special function unit. The registers are bounded by one 64-key tile
// whatever N is, so one kernel serves every N <= 512 and dh <= 128, where
// keeping a warp's 16 x N scores in registers (design (a): 104 of them at
// N 197, with q and the output about 170) would halve the warps an SM
// holds, and spill above N 256 or at dh 128. ptxas's registers and spills
// per instantiation sit in the build's .log (chip_smoke.py prints them).
// Against the SIMT kernel: no fp32 products (about 15 us of tensor-core
// work); K and V stay bf16 in shared memory and arrive by cp.async into a
// two-stage ring, the next step's copy overlapping this step's products,
// one barrier a step; no scores in shared memory (55 KB a block at dh 64,
// whatever N); a block reads K twice and V once, and the row blocks of a
// head are neighbours in the grid, so only the first reads them from
// device memory and the rest from L2. dh is zero-padded to 16, 32, 64 or
// 128 (DHP) in shared memory and in the registers; where a pointer or
// stride is not 16-byte aligned, the same kernel copies 8, 4 or 2 bytes at
// a time (kVec, picked by the C entry).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kQueryRows = kWarps * kRowsPerWarp;   // 32 per block
constexpr int kKeysPerLane = 2;
constexpr int kKeyTile = 32 * kKeysPerLane;         // 64 keys per tile
constexpr int kMaxCols = 4;                         // 32 x 4 columns
constexpr int kMaxRow = 512;
constexpr int kSlice = 32 * kMaxCols;   // columns of a slice of a wide head

struct Strides {
  long long outer0, outer1, head, row;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  Strides sq, sk, sv, so;
  int outer1, heads, n, dh;
  int slices;     // kSlice-column slices of a head wider than kSlice, else 1
  int dh4;        // a slice's width rounded up to 4 (q's row stride in
                  // shared memory)
  int npad;       // n rounded up to the key tile (the scores' row stride)
  float scale;    // K9: already rounded to the I/O type by the caller
};

__device__ __forceinline__ long long offset(const Strides& s, long long o0,
                                            long long o1, long long h) {
  return o0 * s.outer0 + o1 * s.outer1 + h * s.head;
}

// Copies rows [r0, r0 + kRows) of an (n, dh) matrix with row stride
// `stride` into shared memory as fp32, zero past n and dh: element (j, d)
// goes to dst[j * sj + d * sd]. K9's q is scaled on the way (kPrescale).
// Each thread keeps kStage loads in flight before it stores, so the copy is
// not one load latency per element.
template <int kRows, bool kPrescale>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           long long stride, int r0, int n,
                                           int dh, int dh4, float scale,
                                           float* dst, int sj, int sd) {
  constexpr int kStage = 8;
  const int total = kRows * dh4;
  for (int base = threadIdx.x; base < total; base += kStage * blockDim.x) {
    float buf[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = base + u * blockDim.x;
      const int j = e / dh4, d = e - j * dh4;
      buf[u] = 0.f;
      if (e < total && r0 + j < n && d < dh) {
        buf[u] = src[(r0 + j) * stride + d];
        if (kPrescale) buf[u] *= scale;
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = base + u * blockDim.x;
      const int j = e / dh4, d = e - j * dh4;
      if (e < total) dst[j * sj + d * sd] = buf[u];
    }
  }
}

// kCols: output columns a lane owns, ceil(dh / 32) rounded up to 1, 2, 4
template <bool kPrescale, int kCols>
__global__ void __launch_bounds__(kWarps * 32)
row_mha_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sq = smem;                                  // kQueryRows x dh4
  float* ss = sq + kQueryRows * p.dh4;               // kQueryRows x npad
  float* tile = ss + kQueryRows * p.npad;            // K^T or V tile

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = p.n;
  const int dh = p.dh;
  const int dh4 = p.dh4;

  long long idx = blockIdx.x;
  const long long h = idx % p.heads;
  idx /= p.heads;
  const long long o1 = idx % p.outer1;
  const long long o0 = idx / p.outer1;
  const float* __restrict__ q =
      static_cast<const float*>(p.q) + offset(p.sq, o0, o1, h);
  const float* __restrict__ k =
      static_cast<const float*>(p.k) + offset(p.sk, o0, o1, h);
  const float* __restrict__ v =
      static_cast<const float*>(p.v) + offset(p.sv, o0, o1, h);
  const int os = blockIdx.y % p.slices;              // the output's slice
  float* out = static_cast<float*>(p.out) + offset(p.so, o0, o1, h) +
               os * kSlice;
  const int row0 = blockIdx.y / p.slices * kQueryRows;  // the first row
  // the columns of slice sl (all of dh when there is one)
  auto width = [&](int sl) { return min(dh - sl * kSlice, kSlice); };

  // q rows (K9's scaled first), zero past n and dh
  if (p.slices == 1) {
    stage_rows<kQueryRows, kPrescale>(q, p.sq.row, row0, n, dh, dh4,
                                      p.scale, sq, dh4, 1);
  }

  // scores, one key tile at a time; the K tile is transposed in shared
  // memory: tile[d * ktile_stride + j], zero past n and dh
  const int ktile_stride = kKeyTile + 4;
  const float score_scale = kPrescale ? 1.f : p.scale;
  const int my_row = warp * kRowsPerWarp;            // in the block
  for (int kt = 0; kt < p.npad; kt += kKeyTile) {
    float acc[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) acc[r][c] = 0.f;
    // summed over the head's column slices
    for (int sl = 0; sl < p.slices; ++sl) {
      __syncthreads();
      if (p.slices > 1) {
        stage_rows<kQueryRows, kPrescale>(q + sl * kSlice, p.sq.row, row0, n,
                                          width(sl), dh4, p.scale, sq, dh4, 1);
      }
      stage_rows<kKeyTile, false>(k + sl * kSlice, p.sk.row, kt, n, width(sl),
                                  dh4, 0.f, tile, 1, ktile_stride);
      __syncthreads();
      for (int d = 0; d < dh4; d += 4) {
        float kv[4][kKeysPerLane];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kKeysPerLane; ++c)
            kv[i][c] = tile[(d + i) * ktile_stride + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(&sq[(my_row + r) * dh4 + d]);
#pragma unroll
          for (int c = 0; c < kKeysPerLane; ++c) {
            acc[r][c] = fmaf(qv.x, kv[0][c], acc[r][c]);
            acc[r][c] = fmaf(qv.y, kv[1][c], acc[r][c]);
            acc[r][c] = fmaf(qv.z, kv[2][c], acc[r][c]);
            acc[r][c] = fmaf(qv.w, kv[3][c], acc[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c)
        ss[(my_row + r) * p.npad + kt + lane + 32 * c] =
            acc[r][c] * score_scale;
  }
  __syncwarp();

  // exact softmax over each of the warp's rows; the weights rounded to T
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* srow = ss + (my_row + r) * p.npad;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, srow[j]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < p.npad; j += 32)
      srow[j] = j < n ? srow[j] / sum : 0.f;
  }

  // out = w v, one V tile at a time: tile[j * vtile_stride + d]
  const int vtile_stride = dh4 + 4;
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  for (int vt = 0; vt < p.npad; vt += kKeyTile) {
    __syncthreads();
    stage_rows<kKeyTile, false>(v + os * kSlice, p.sv.row, vt, n, width(os),
                                dh4, 0.f, tile, vtile_stride, 1);
    __syncthreads();
    // the tile's keys up to n, in steps of 4 (the weights are 0 past n)
    const int jend = min(kKeyTile, (n - vt + 3) / 4 * 4);
    for (int j = 0; j < jend; j += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          vv[i][c] = d < dh4 ? tile[(j + i) * vtile_stride + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(
            &ss[(my_row + r) * p.npad + vt + j]);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[r][c] = fmaf(w.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(w.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(w.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(w.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + my_row + r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < width(os)) out[row * p.so.row + d] = acc[r][c];
    }
  }
}

// q rows, score rows, and the larger of the transposed K tile (dh4 rows of
// kKeyTile + 4) and the V tile (kKeyTile rows of dh4 + 4)
size_t smem_bytes(int dh4, int npad) {
  const size_t k_tile = static_cast<size_t>(dh4) * (kKeyTile + 4);
  const size_t v_tile = static_cast<size_t>(kKeyTile) * (dh4 + 4);
  return sizeof(float) * (static_cast<size_t>(kQueryRows) * (dh4 + npad) +
                          (k_tile > v_tile ? k_tile : v_tile));
}

template <bool kPrescale, int kCols>
int launch_cols(const Params& p, long long blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.dh4, p.npad);
  cudaError_t err = cudaFuncSetAttribute(
      row_mha_kernel<kPrescale, kCols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((p.n + kQueryRows - 1) / kQueryRows *
                                        p.slices));
  row_mha_kernel<kPrescale, kCols>
      <<<grid, kWarps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPrescale>
int launch(const Params& p, long long blocks, cudaStream_t stream) {
  if (p.slices > 1) return launch_cols<kPrescale, kMaxCols>(p, blocks, stream);
  if (p.dh <= 32) return launch_cols<kPrescale, 1>(p, blocks, stream);
  if (p.dh <= 64) return launch_cols<kPrescale, 2>(p, blocks, stream);
  return launch_cols<kPrescale, kMaxCols>(p, blocks, stream);
}

// K9 and K10 in bf16 on the tensor cores (see the note at the top). The
// most warps a block takes: at N 197 two blocks of 7 warps a head, whose
// registers (at most 128 a thread) let two blocks share an SM; one block
// of 13 warps a head, one an SM, read slower on an H100.
constexpr int kMmaWarps = 8;

// The body of both tensor-core kernels; kPrescale: K9 (q times the scale,
// rounded to bf16), else K10 (the fp32 sums times the scale).
template <int DHP, int kVec, bool kPrescale>
__device__ __forceinline__ void whole_row_mma(const Params& p) {
  using namespace attn_mma;
  constexpr int kKeys = attn_mma::kKeyTile;       // keys of a tile
  constexpr int ld = row_stride(DHP);
  constexpr int kTile = kKeys * ld;                // one K or V tile
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x / 32;
  uint16_t* sq = reinterpret_cast<uint16_t*>(smem4);   // 16 rows a warp
  uint16_t* ring = sq + warps * 16 * ld;           // 2 stages of K, V

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = p.n;
  const int dh = p.dh;
  // row blocks of one (instance, head) are neighbours in the grid, so the
  // K and V one reads are still in L2 for the next (launch_mma's count)
  const int row_blocks = ((n + 15) / 16 + kMmaWarps - 1) / kMmaWarps;
  long long idx = blockIdx.x / row_blocks;
  const int row0 = static_cast<int>(blockIdx.x % row_blocks) * warps * 16;
  const long long h = idx % p.heads;
  idx /= p.heads;
  const long long o1 = idx % p.outer1;
  const long long o0 = idx / p.outer1;
  const uint16_t* q =
      static_cast<const uint16_t*>(p.q) + offset(p.sq, o0, o1, h);
  const uint16_t* k =
      static_cast<const uint16_t*>(p.k) + offset(p.sk, o0, o1, h);
  const uint16_t* v =
      static_cast<const uint16_t*>(p.v) + offset(p.sv, o0, o1, h);
  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(p.out) + offset(p.so, o0, o1, h);

  // walk step t < tiles copies K tile t (the first walk: the max and the
  // sum); step tiles + t copies K and V tile t (the second: the output)
  const int tiles = (n + kKeys - 1) / kKeys;
  const int steps = 2 * tiles;
  auto issue = [&](int step) {
    uint16_t* stage = ring + (step & 1) * 2 * kTile;
    const int t = step < tiles ? step : step - tiles;
    copy_rows<kVec, DHP>(stage, ld, k, p.sk.row, t * kKeys, kKeys, n, dh);
    if (step >= tiles) {
      copy_rows<kVec, DHP>(stage + kTile, ld, v, p.sv.row, t * kKeys, kKeys,
                           n, dh);
    }
  };
  copy_rows<kVec, DHP>(sq, ld, q, p.sq.row, row0, warps * 16, n, dh);
  issue(0);
  cp_async_commit();

  const int wrow = row0 + warp * 16;               // the warp's first row
  const int g = lane / 4;
  const bool active = wrow < n;
  uint32_t qf[DHP / 16][4];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  // the first walk: each row's max and sum in fp32 over all keys; the sum
  // is rescaled when the max grows, each lane keeping its own part. The
  // scores are taken in log2 units (times log2(e), and K10's times the
  // scale too), so exp is exp2.
  const float log2_units = kPrescale ? kLog2e : p.scale * kLog2e;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();                            // this step's copies,
    __syncthreads();                               // and the last stage free
    if (t + 1 < steps) {
      issue(t + 1);                                // during this step
      cp_async_commit();
    }
    if (active) {
      if (t == 0) {
        load_q<DHP>(qf, sq + warp * 16 * ld, lane);
        if constexpr (kPrescale) {
          // K9: q times the bf16 scale, rounded to bf16, as the TPU kernel
#pragma unroll
          for (int kk = 0; kk < DHP / 16; ++kk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 x = unpack_bf16(qf[kk][e]);
              qf[kk][e] = pack_bf16(x.x * p.scale, x.y * p.scale);
            }
          }
        }
      }
      const int j0 = t * kKeys;
      const int groups = min(kKeyGroups, (n - j0 + 15) / 16);
      float s[8][4];
      tile_scores<DHP>(s, qf, ring + (t & 1) * 2 * kTile, groups, lane);
      scale_tile(s, log2_units);
      if (j0 + kKeys > n) mask_tile(s, j0, n, wrow + g, false, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(row_max(s, r)));
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          if (nb / 2 < groups) {
            sum += exp2f(s[nb][2 * r] - m_new) +
                   exp2f(s[nb][2 * r + 1] - m_new);
          }
        }
        l[r] = l[r] * exp2f(m[r] - m_new) + sum;
        m[r] = m_new;
      }
    }
  }

  // the second walk: w = round(exp(s - max) / sum) into A fragments, then
  // o += w v. e / sum is the correctly rounded quotient from the row's
  // reciprocal r = 1 / sum with Markstein's correction, w = q + (e - sum q)
  // r for q = e r (two FMAs and a product, where a division takes a
  // reciprocal of its own on the special function unit)
  float o[DHP / 8][4];
#pragma unroll
  for (int c = 0; c < DHP / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  }
  float rinv[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      rinv[r] = 1.f / l[r];
    }
  }
  for (int t = 0; t < tiles; ++t) {
    const int step = tiles + t;
    cp_async_wait<0>();
    __syncthreads();
    if (step + 1 < steps) {
      issue(step + 1);
      cp_async_commit();
    }
    if (active) {
      const uint16_t* stage = ring + (step & 1) * 2 * kTile;
      const int j0 = t * kKeys;
      const int groups = min(kKeyGroups, (n - j0 + 15) / 16);
      float s[8][4];
      tile_scores<DHP>(s, qf, stage, groups, lane);
      scale_tile(s, log2_units);
      if (j0 + kKeys > n) mask_tile(s, j0, n, wrow + g, false, lane);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = nb / 2 < groups ? exp2f(s[nb][e] - m[e / 2]) : 0.f;
          const float q = x * rinv[e / 2];
          s[nb][e] = fmaf(fmaf(-l[e / 2], q, x), rinv[e / 2], q);
        }
      }
      uint32_t w[kKeyGroups][4];
      pack_weights(w, s);
      tile_pv<DHP>(o, w, stage + kTile, groups, lane);
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* dst = out + row * p.so.row;
#pragma unroll
    for (int c = 0; c < DHP / 8; ++c) {
      const int col = c * 8 + 2 * (lane % 4);
      if (kVec > 1 && col + 1 < dh) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o[c][2 * r], o[c][2 * r + 1]);
      } else {
        if (col < dh) dst[col] = __float2bfloat16_rn(o[c][2 * r]);
        if (col + 1 < dh) dst[col + 1] = __float2bfloat16_rn(o[c][2 * r + 1]);
      }
    }
  }
}

// The body of both tensor-core kernels above kSlice columns: the walks of
// `whole_row_mma` with every step split into the head's 128-column slices.
// A stage holds the block's q rows, a K tile and (second walk, last slice)
// a V tile of one slice, all from shared memory (no q in registers; K9's
// q scaled as its fragments are read); the scores are summed over the
// slices, and the block writes the output's slice `os` (grid: slices of a
// row block are neighbours).
template <int kVec, bool kPrescale>
__device__ __forceinline__ void whole_row_mma_sliced(const Params& p) {
  using namespace attn_mma;
  constexpr int DHP = kSlice;
  constexpr int kKeys = attn_mma::kKeyTile;
  constexpr int ld = row_stride(DHP);
  constexpr int kTile = kKeys * ld;
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x / 32;
  const int kQ = warps * 16 * ld;                  // the q rows of a stage
  const int kStage = kQ + 2 * kTile;               // q, K and V slices
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem4);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = p.n;
  const int dh = p.dh;
  const int slices = p.slices;
  const int row_blocks = ((n + 15) / 16 + kMmaWarps - 1) / kMmaWarps;
  const int os = static_cast<int>(blockIdx.x % slices);
  const long long rb = blockIdx.x / slices;
  long long idx = rb / row_blocks;
  const int row0 = static_cast<int>(rb % row_blocks) * warps * 16;
  const long long h = idx % p.heads;
  idx /= p.heads;
  const long long o1 = idx % p.outer1;
  const long long o0 = idx / p.outer1;
  const uint16_t* q =
      static_cast<const uint16_t*>(p.q) + offset(p.sq, o0, o1, h);
  const uint16_t* k =
      static_cast<const uint16_t*>(p.k) + offset(p.sk, o0, o1, h);
  const uint16_t* v =
      static_cast<const uint16_t*>(p.v) + offset(p.sv, o0, o1, h);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) +
                       offset(p.so, o0, o1, h) + os * DHP;

  // walk step t: walk t / per (the max and sum, then the output), key tile
  // t % per / slices, column slice t % slices
  const int tiles = (n + kKeys - 1) / kKeys;
  const int per = tiles * slices;
  const int steps = 2 * per;
  auto issue = [&](int t) {
    uint16_t* stage = ring + (t & 1) * kStage;
    const int kt = t % per / slices;
    const int sl = t % slices;
    const int cols = dh - sl * DHP;
    copy_rows<kVec, DHP>(stage, ld, q + sl * DHP, p.sq.row, row0, warps * 16,
                         n, cols);
    copy_rows<kVec, DHP>(stage + kQ, ld, k + sl * DHP, p.sk.row, kt * kKeys,
                         kKeys, n, cols);
    if (t >= per && sl == slices - 1) {
      copy_rows<kVec, DHP>(stage + kQ + kTile, ld, v + os * DHP, p.sv.row,
                           kt * kKeys, kKeys, n, dh - os * DHP);
    }
  };
  issue(0);
  cp_async_commit();

  const int wrow = row0 + warp * 16;               // the warp's first row
  const int g = lane / 4;
  const bool active = wrow < n;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float rinv[2] = {0.f, 0.f};
  float o[DHP / 8][4];
#pragma unroll
  for (int c = 0; c < DHP / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  }
  const float log2_units = kPrescale ? kLog2e : p.scale * kLog2e;
  float s[8][4];
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<0>();                            // this step's copies,
    __syncthreads();                               // and the last stage free
    if (t + 1 < steps) {
      issue(t + 1);
      cp_async_commit();
    }
    if (t == per && active) {                      // between the walks
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        rinv[r] = 1.f / l[r];
      }
    }
    if (!active) continue;
    const uint16_t* stage = ring + (t & 1) * kStage;
    const int j0 = t % per / slices * kKeys;
    const int groups = min(kKeyGroups, (n - j0 + 15) / 16);
    if (t % slices == 0) zero_tile(s);
    tile_scores_shared_add<DHP, kPrescale>(s, stage + warp * 16 * ld,
                                           stage + kQ, groups, lane,
                                           p.scale);
    if (t % slices != slices - 1) continue;
    scale_tile(s, log2_units);
    if (j0 + kKeys > n) mask_tile(s, j0, n, wrow + g, false, lane);
    if (t < per) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(row_max(s, r)));
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          if (nb / 2 < groups) {
            sum += exp2f(s[nb][2 * r] - m_new) +
                   exp2f(s[nb][2 * r + 1] - m_new);
          }
        }
        l[r] = l[r] * exp2f(m[r] - m_new) + sum;
        m[r] = m_new;
      }
      continue;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = nb / 2 < groups ? exp2f(s[nb][e] - m[e / 2]) : 0.f;
        const float qq = x * rinv[e / 2];
        s[nb][e] = fmaf(fmaf(-l[e / 2], qq, x), rinv[e / 2], qq);
      }
    }
    uint32_t w[kKeyGroups][4];
    pack_weights(w, s);
    tile_pv<DHP>(o, w, stage + kQ + kTile, groups, lane);
  }

  if (!active) return;
  const int cols = dh - os * DHP;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* dst = out + row * p.so.row;
#pragma unroll
    for (int c = 0; c < DHP / 8; ++c) {
      const int col = c * 8 + 2 * (lane % 4);
      if (kVec > 1 && col + 1 < cols) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o[c][2 * r], o[c][2 * r + 1]);
      } else {
        if (col < cols) dst[col] = __float2bfloat16_rn(o[c][2 * r]);
        if (col + 1 < cols) dst[col + 1] = __float2bfloat16_rn(o[c][2 * r + 1]);
      }
    }
  }
}

template <int DHP, int kVec, bool kSliced>
__global__ void __launch_bounds__(kMmaWarps * 32)
vision_mha_mma_kernel(const Params p) {
  if constexpr (kSliced) {
    whole_row_mma_sliced<kVec, true>(p);
  } else {
    whole_row_mma<DHP, kVec, true>(p);
  }
}

template <int DHP, int kVec, bool kSliced>
__global__ void __launch_bounds__(kMmaWarps * 32)
row_mha_mma_kernel(const Params p) {
  if constexpr (kSliced) {
    whole_row_mma_sliced<kVec, false>(p);
  } else {
    whole_row_mma<DHP, kVec, false>(p);
  }
}

template <int DHP, int kVec, bool kPrescale, bool kSliced>
int launch_mma(const Params& p, long long blocks, cudaStream_t stream) {
  void (*kernel)(const Params) =
      kPrescale ? vision_mha_mma_kernel<DHP, kVec, kSliced>
                : row_mha_mma_kernel<DHP, kVec, kSliced>;
  const int ld = attn_mma::row_stride(DHP);
  const int row_tiles = (p.n + 15) / 16;
  const int row_blocks = (row_tiles + kMmaWarps - 1) / kMmaWarps;
  const int warps = (row_tiles + row_blocks - 1) / row_blocks;
  const long long grid = blocks * row_blocks * p.slices;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // q rows and a stage pair of K and V tiles (sliced: two stages of q, K
  // and V slices)
  const size_t smem = sizeof(uint16_t) * static_cast<size_t>(ld) *
                      (kSliced ? 2 * (warps * 16 + 2 * attn_mma::kKeyTile)
                               : warps * 16 + 4 * attn_mma::kKeyTile);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), warps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP, bool kPrescale, bool kSliced = false>
int launch_mma_vec(const Params& p, int vec, long long blocks,
                   cudaStream_t stream) {
  switch (vec) {
    case 8: return launch_mma<DHP, 8, kPrescale, kSliced>(p, blocks, stream);
    case 4: return launch_mma<DHP, 4, kPrescale, kSliced>(p, blocks, stream);
    case 2: return launch_mma<DHP, 2, kPrescale, kSliced>(p, blocks, stream);
    default: return launch_mma<DHP, 1, kPrescale, kSliced>(p, blocks, stream);
  }
}

// K9 or K10 in bf16: the head width padded to DHP (or cut in 128-column
// slices above 128) and the widest copy that every pointer and stride
// allows.
template <bool kPrescale>
int launch_bf16_mma(const Params& p, long long blocks, cudaStream_t stream) {
  unsigned long long bits = 0;
  const void* ptrs[4] = {p.q, p.k, p.v, p.out};
  const Strides* st[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int t = 0; t < 4; ++t) {
    bits |= reinterpret_cast<unsigned long long>(ptrs[t]);
    const long long strides =
        st[t]->outer0 | st[t]->outer1 | st[t]->head | st[t]->row;
    bits |= 2ull * static_cast<unsigned long long>(strides);
  }
  const int vec = attn_mma::vec_for(bits);
  cudaStream_t s = stream;
  if (p.slices > 1) {
    return launch_mma_vec<kSlice, kPrescale, true>(p, vec, blocks, s);
  }
  if (p.dh <= 16) return launch_mma_vec<16, kPrescale>(p, vec, blocks, s);
  if (p.dh <= 32) return launch_mma_vec<32, kPrescale>(p, vec, blocks, s);
  if (p.dh <= 64) return launch_mma_vec<64, kPrescale>(p, vec, blocks, s);
  return launch_mma_vec<128, kPrescale>(p, vec, blocks, s);
}

int run(bool prescale, int dtype, long long outer0, int outer1, int heads,
        int n, int dh, float scale, const long long* st, const void* q,
        const void* k, const void* v, void* out, void* stream) {
  const long long blocks = outer0 * outer1 * heads;
  if (outer0 < 1 || outer1 < 1 || heads < 1 || n < 1 || n > kMaxRow ||
      dh < 1 || blocks > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1) || !q || !k || !v || !out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  Strides* s[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int t = 0; t < 4; ++t) {
    s[t]->outer0 = st[4 * t];
    s[t]->outer1 = st[4 * t + 1];
    s[t]->head = st[4 * t + 2];
    s[t]->row = st[4 * t + 3];
  }
  p.outer1 = outer1;
  p.heads = heads;
  p.n = n;
  p.dh = dh;
  p.slices = (dh + kSlice - 1) / kSlice;
  p.dh4 = p.slices > 1 ? kSlice : (dh + 3) / 4 * 4;
  p.npad = (n + kKeyTile - 1) / kKeyTile * kKeyTile;
  p.scale = scale;
  cudaStream_t s0 = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return prescale ? launch<true>(p, blocks, s0)
                    : launch<false>(p, blocks, s0);
  }
  // bf16: K9 and K10 on the tensor cores
  return prescale ? launch_bf16_mma<true>(p, blocks, s0)
                  : launch_bf16_mma<false>(p, blocks, s0);
}

}  // namespace

extern "C" {

// K10 on `stream`. dtype: 0 float32, 1 bfloat16 (q, k, v and out share
// it). q, k, v, out: (outer0, outer1, heads, n, dh) with the element strides
// sX0, sX1, sXh, sXn (the last dimension contiguous); the scores are scaled
// by `scale` in fp32. n <= 512, any dh. Returns the cudaError_t of the
// launch (0 on success).
int row_mha_fwd(int dtype, long long outer0, int outer1, int heads, int n,
                int dh, float scale, long long sq0, long long sq1,
                long long sqh, long long sqn, long long sk0, long long sk1,
                long long skh, long long skn, long long sv0, long long sv1,
                long long svh, long long svn, long long so0, long long so1,
                long long soh, long long son, const void* q, const void* k,
                const void* v, void* out, void* stream) {
  const long long st[16] = {sq0, sq1, sqh, sqn, sk0, sk1, skh, skn,
                            sv0, sv1, svh, svn, so0, so1, soh, son};
  return run(false, dtype, outer0, outer1, heads, n, dh, scale, st, q, k, v,
             out, stream);
}

// K9 on `stream`: the arguments of row_mha_fwd, but q is multiplied by
// `scale` (already rounded to the I/O type) and rounded to that type
// before the product, as the TPU kernel does.
int vision_mha_fwd(int dtype, long long outer0, int outer1, int heads, int n,
                   int dh, float scale, long long sq0, long long sq1,
                   long long sqh, long long sqn, long long sk0, long long sk1,
                   long long skh, long long skn, long long sv0, long long sv1,
                   long long svh, long long svn, long long so0, long long so1,
                   long long soh, long long son, const void* q,
                   const void* k, const void* v, void* out, void* stream) {
  const long long st[16] = {sq0, sq1, sqh, sqn, sk0, sk1, skh, skn,
                            sv0, sv1, svh, svn, so0, so1, soh, son};
  return run(true, dtype, outer0, outer1, heads, n, dh, scale, st, q, k, v,
             out, stream);
}

const char* row_mha_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* vision_mha_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
