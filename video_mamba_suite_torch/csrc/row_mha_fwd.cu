// Whole-row multi-head attention, forward, for Hopper (sm_90a): kernels K10
// and K9 in one source.
//
// Replaces the TPU kernels `_row_mha_kernel` (K10, launched from
// `_row_mha_fwd_impl`, reached through `row_mha_qkv`) and `_mha_kernel`
// (K9, launched from `_mha_fwd_impl`, reached through `vision_mha`) in
// video_mamba_suite_tpu/ops/vision_attention.py. For every (instance, head)
// and query row i over N <= 512 tokens of width dh <= 128:
//
//     s_ij = (q_i . k_j) * scale          (K10: fp32 scores times scale)
//     s_ij = (round(q_i * scale) . k_j)   (K9: q scaled in its own type)
//     w_ij = round(exp(s_ij - max_j s) / sum_j exp(s_ij - max_j s))
//     o_i  = sum_j w_ij v_j               (fp32 sum, rounded to the type)
//
// with the max and the sum taken in fp32 over the whole row (two passes, no
// online rescale) and `round` the rounding to the I/O type (fp32 or bf16),
// which is where the TPU kernels cast the scaled q (K9) and the weights
// (both) before their products. Entry `row_mha_fwd` is K10, entry
// `vision_mha_fwd` K9; they differ only in where the scale is applied.
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
// never touching device memory.
//
// Design (simple and right first; no tensor cores yet): a block of 4 warps
// takes 32 query rows of one (instance, head), 8 rows a warp. It stages
// those rows of q in shared memory as fp32, then walks the keys in tiles of
// 64: each tile of K is staged transposed (dh x 64, padded against bank
// conflicts) and each lane computes two keys' scores for the warp's 8 rows,
// reading q as float4 broadcasts. The fp32 scores of the block's rows over
// all N keys stay in shared memory (at most 32 x 512 floats). Each warp then
// takes its rows' exact max and sum with shuffles and overwrites the scores
// with the rounded weights (0 past N). Last, tiles of V are staged and each
// lane accumulates up to 4 output columns (dh <= 128) for the 8 rows in fp32
// registers (kCols = 1, 2 or 4 columns, by dh). Every copy into shared
// memory keeps 8 loads a thread in flight. Ragged N and dh are zero-padded
// in shared memory, so no padded key or column can reach a sum. Shared memory: 32 x dh (q) +
// 32 x ceil(N / 64) x 64 (scores) + about 68 x dh (a K or V tile) floats,
// at most 114 KB (58 KB at the MIR shape: 3 blocks an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kQueryRows = kWarps * kRowsPerWarp;   // 32 per block
constexpr int kKeysPerLane = 2;
constexpr int kKeyTile = 32 * kKeysPerLane;         // 64 keys per tile
constexpr int kMaxCols = 4;                         // dh <= 32 x 4
constexpr int kMaxRow = 512;
constexpr int kMaxHeadDim = 32 * kMaxCols;

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
  int dh4;        // dh rounded up to 4 (q's row stride in shared memory)
  int npad;       // n rounded up to the key tile (the scores' row stride)
  float scale;    // K9: already rounded to the I/O type by the caller
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
  return __float2bfloat16(v);
}

// the value rounded to T and back: what the TPU kernel holds after a cast
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ long long offset(const Strides& s, long long o0,
                                            long long o1, long long h) {
  return o0 * s.outer0 + o1 * s.outer1 + h * s.head;
}

// Copies rows [r0, r0 + kRows) of an (n, dh) matrix with row stride
// `stride` into shared memory as fp32, zero past n and dh: element (j, d)
// goes to dst[j * sj + d * sd]. K9's q is scaled and rounded to T on the
// way (kPrescale). Each thread keeps kStage loads in flight before it
// stores, so the copy is not one load latency per element.
template <typename T, int kRows, bool kPrescale>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
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
        buf[u] = to_float(src[(r0 + j) * stride + d]);
        if (kPrescale) buf[u] = round_to<T>(buf[u] * scale);
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
template <typename T, bool kPrescale, int kCols>
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
  const T* __restrict__ q =
      static_cast<const T*>(p.q) + offset(p.sq, o0, o1, h);
  const T* __restrict__ k =
      static_cast<const T*>(p.k) + offset(p.sk, o0, o1, h);
  const T* __restrict__ v =
      static_cast<const T*>(p.v) + offset(p.sv, o0, o1, h);
  T* out = static_cast<T*>(p.out) + offset(p.so, o0, o1, h);
  const int row0 = blockIdx.y * kQueryRows;          // the block's first row

  // q rows as fp32 (K9: scaled and rounded to T first), zero past n and dh
  stage_rows<T, kQueryRows, kPrescale>(q, p.sq.row, row0, n, dh, dh4,
                                       p.scale, sq, dh4, 1);

  // scores, one key tile at a time; the K tile is transposed in shared
  // memory: tile[d * ktile_stride + j], zero past n and dh
  const int ktile_stride = kKeyTile + 4;
  const float score_scale = kPrescale ? 1.f : p.scale;
  const int my_row = warp * kRowsPerWarp;            // in the block
  for (int kt = 0; kt < p.npad; kt += kKeyTile) {
    __syncthreads();
    stage_rows<T, kKeyTile, false>(k, p.sk.row, kt, n, dh, dh4, 0.f, tile,
                                   1, ktile_stride);
    __syncthreads();
    float acc[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) acc[r][c] = 0.f;
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
      srow[j] = j < n ? round_to<T>(srow[j] / sum) : 0.f;
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
    stage_rows<T, kKeyTile, false>(v, p.sv.row, vt, n, dh, dh4, 0.f, tile,
                                   vtile_stride, 1);
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
      if (d < dh) out[row * p.so.row + d] = from_float<T>(acc[r][c]);
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

template <typename T, bool kPrescale, int kCols>
int launch_cols(const Params& p, long long blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.dh4, p.npad);
  cudaError_t err = cudaFuncSetAttribute(
      row_mha_kernel<T, kPrescale, kCols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((p.n + kQueryRows - 1) / kQueryRows));
  row_mha_kernel<T, kPrescale, kCols>
      <<<grid, kWarps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPrescale>
int launch(const Params& p, long long blocks, cudaStream_t stream) {
  if (p.dh <= 32) return launch_cols<T, kPrescale, 1>(p, blocks, stream);
  if (p.dh <= 64) return launch_cols<T, kPrescale, 2>(p, blocks, stream);
  return launch_cols<T, kPrescale, kMaxCols>(p, blocks, stream);
}

int run(bool prescale, int dtype, long long outer0, int outer1, int heads,
        int n, int dh, float scale, const long long* st, const void* q,
        const void* k, const void* v, void* out, void* stream) {
  const long long blocks = outer0 * outer1 * heads;
  if (outer0 < 1 || outer1 < 1 || heads < 1 || n < 1 || n > kMaxRow ||
      dh < 1 || dh > kMaxHeadDim || blocks > 0x7fffffffLL ||
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
  p.dh4 = (dh + 3) / 4 * 4;
  p.npad = (n + kKeyTile - 1) / kKeyTile * kKeyTile;
  p.scale = scale;
  cudaStream_t s0 = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return prescale ? launch<float, true>(p, blocks, s0)
                    : launch<float, false>(p, blocks, s0);
  }
  return prescale ? launch<__nv_bfloat16, true>(p, blocks, s0)
                  : launch<__nv_bfloat16, false>(p, blocks, s0);
}

}  // namespace

extern "C" {

// K10 on `stream`. dtype: 0 float32, 1 bfloat16 (q, k, v and out share
// it). q, k, v, out: (outer0, outer1, heads, n, dh) with the element strides
// sX0, sX1, sXh, sXn (the last dimension contiguous); the scores are scaled
// by `scale` in fp32. n <= 512, dh <= 128. Returns the cudaError_t of the
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
