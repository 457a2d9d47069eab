// Flash attention for Hopper (sm_90a): kernel K11, forward and backward.
//
// Replaces the TPU kernels of jax's Pallas `flash_attention`
// (jax/experimental/pallas/ops/tpu/flash_attention.py): the forward
// `_flash_attention_kernel` and the backward `_flash_attention_dkv_kernel`
// and `_flash_attention_dq_kernel` (the VJP `_flash_attention_bwd`), which
// the JAX package reaches through `_flash_mha` in
// video_mamba_suite_tpu/models/common.py (FusedMHA(flash=True)). For every
// (batch, head) and query row i of L rows of width dh:
//
//     s_ij  = (q_i . k_j) * scale       fp32 sums of the I/O type's products
//     m_i   = max_j s_ij,  l_i = sum_j exp(s_ij - m_i)
//     o_i   = sum_j round(exp(s_ij - m_i)) v_j / l_i
//     lse_i = m_i + log(l_i)
//
// and, from o, lse and the output's cotangent do:
//
//     p_ij  = exp(s_ij - lse_i)
//     di_i  = sum_c o_ic * do_ic      (fp32)
//     dv_j  = sum_i round(p_ij) do_i
//     ds_ij = p_ij * (do_i . v_j - di_i) * scale
//     dq_i  = sum_j round(ds_ij) k_j,   dk_j = sum_i round(ds_ij) q_i
//
// where causal keeps keys j <= i, keys and rows at or past L count nothing,
// `round` rounds to the I/O type (fp32 or bf16; the library's casts of its
// weights and of ds before their products), and the forward keeps m and l
// online over key tiles.
//
// Head widths: those jax's flash_attention computes, any dh <= 128 (the
// wrapper gives the kernels a multiple of 8, padding a copy where needed)
// and multiples of 128 above that. Up to 128 the tiles are 64 or 128
// columns wide, zero-filled in shared memory past dh: zero columns change
// neither the scores nor the kept columns of o, dq, dk and dv. Above 128
// (`slices` > 1) every kernel works in 128-column slices: a block owns one
// slice of its outputs (grid x: tile x slices + slice), the score products
// (s, and in the backward dp) are summed over all slices as their operands
// stream through shared memory a slice at a time, and the products that
// make the outputs run on the block's own slice, the one the backward
// walks last. So registers and shared memory stay those of dh 128.
//
// Layout: q, k and v are (B, L, H, dh), each given by three strides in
// elements (batch, row, head) with the dh elements of a row contiguous, so
// the projection's (B, L, 3D) output is read in place; out and do are
// contiguous (B, L, H * dh) in the I/O type, lse (and the backward's
// scratch di) contiguous (B, H, L) fp32, dq, dk and dv contiguous
// (B, L, H, dh).
//
// Two C entries. `flash_mha_fwd` launches one kernel; `flash_mha_bwd`
// launches three in order on the stream:
//   di:   8 to 32 lanes per (batch, row, head) sum o * do, 16 bytes of
//         each a lane (one warp a row reading 2 bytes a lane took 3x as
//         long at the vision width on an H100);
//   dkdv: a block per 64 keys of one (batch, head) holds K and V and walks
//         the query tiles (from the diagonal when causal), accumulating dk
//         and dv in registers;
//   dq:   a block per 64 query rows holds Q and dO and walks the key tiles
//         (up to the diagonal when causal), accumulating dq in registers.
// So every output is written once by one block, with no atomics, and the
// scores are recomputed in both walks (the library's split too).
//
// What bounds it on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 in the tensor
// cores, 67 TFLOP/s fp32 outside them): at the vision shape (B 128, L 197,
// H 12, dh 64, bf16) the forward moves q, k, v and out, 4 x 38.7 MB (46 us),
// and its two products take 2 x 2 x 1536 x 197^2 x 64 = 15.3 GFLOP (15 us on
// the tensor cores); the backward moves 8 such tensors, 310 MB (93 us),
// against five products (s, dp, dv, dq, dk), 38 GFLOP (39 us). At the long
// shape (2 x 2048, 8 heads, dh 64, causal, bf16) the forward moves 16.8 MB
// (5 us) against 8.6 GFLOP of the causal half (9 us). So short rows are
// bound by the bytes, long ones by the products.
//
// Dispatch by type: bf16 runs on the tensor cores, the forward in
// `flash_mha_fwd_mma_kernel` and the backward in
// `flash_mha_bwd_dkdv_mma_kernel` and `flash_mha_bwd_dq_mma_kernel`; fp32
// runs the SIMT kernels (`flash_mha_fwd_kernel`, `flash_mha_bwd_dkdv_kernel`,
// `flash_mha_bwd_dq_kernel`). fp32 stays on the CUDA cores on purpose: the
// TPU kernels' fp32 products are full fp32, and TF32 tensor cores (about
// three decimal digits) would not hold the fp32 tolerances. No bf16 input
// reaches a SIMT kernel but di, which both types share.
//
// SIMT design (CUDA cores, fp32 only): every kernel but di runs 256 threads
// on 64-row tiles held in shared memory as fp32 rows padded to dh + 4
// floats, so the products read float4s without bank conflicts. Thread (ty,
// tx) of the 16 x 16 grid holds a 4 x 4 piece of each 64 x 64 score tile
// (rows 4 ty + r, columns tx + 16 q), writes its p (or ds) into a 64 x 68 tile
// for the product that follows, and accumulates rows 4 ty + r, columns 4
// tx + 64 g of its outputs in registers. The forward takes 64 query rows
// of one (batch, head), walks the key tiles up to the diagonal when
// causal, reduces each row's max and sum across its 16 lanes with
// shuffles, and rescales its output rows by exp(m_old - m_new) at every
// tile. Rows and keys past L are zero in shared memory. Shared memory:
// forward 3 x 64 x (dh + 4) + 64 x 68 floats (68 KB at dh 64, 116 KB at dh
// 128); backward 4 x 64 x (dh + 4) floats plus one (dq) or two (dkdv) 64 x
// 68 tiles, at most 169 KB (dkdv at dh 128). Why bf16 does not run them:
// every FMA fed from fp32 operands in shared memory (at 67 TFLOP/s the
// forward's two products alone take 0.23 ms at the vision width, 5x the
// bound; it reached about 17 TFLOP/s); q, k and v widened to fp32 in
// shared memory (twice the bytes) by synchronous loads (`load_tile`) that
// overlap no arithmetic; and every P (and dS) tile written to shared memory
// and read back for the product that follows. The backward runs seven such
// products a score (s, dp, dv and dk per key tile, s, dp and dq per query
// tile): in bf16 it took 3.27 ms at the vision width, 35x its bound.
//
// `flash_mha_fwd_mma_kernel` (bf16 on the tensor cores; attention_mma.cuh):
// 4 warps take 64 query rows of one (batch, head), 16 a warp, their q in
// registers as bf16 A fragments; K and V tiles of 64 keys stay bf16 in
// shared memory and arrive by cp.async into a two-stage ring, the next
// tile's copy overlapping this tile's products; the scores, the online max
// and sum, the rescale and the rounded p stay in registers, p packed into
// A fragments for p @ v (no P tile in shared memory). Causal blocks stop at
// the diagonal tile, only that tile (and the one holding L) is masked, and
// in it each warp skips the 16-key groups wholly past its rows. The same
// quantities as the SIMT forward: p = round(exp(s - m_running)), the output
// rescaled by exp(m_old - m_new) at every tile and divided by l at the
// end, lse = m + log(l) in fp32, which the backward reads (exp
// taken as exp2 of the scores times scale log2(e), m kept in those units).
// One barrier a tile. Strides that are multiples of 4 but not 8 bf16 take
// 8-byte copies in the same kernel (kVec 4). q is staged in the ring's
// second stage and read into registers before that stage takes a tile.
// Shared memory: 4 x 64 x (dh + 8) bf16 (36 KB at dh 64, 68 KB at dh 128),
// so registers (ptxas: about 115 a thread at dh 64) set 4 blocks an SM.
//
// The bf16 backward on the tensor cores (attention_mma.cuh), the library's
// split and rounding points kept (di, then dk/dv per key tile, then dq per
// query tile; every output written once by one block, no atomics):
//   `flash_mha_bwd_dkdv_mma_kernel`: 4 warps take 64 keys of one (batch,
//     head), 16 a warp, K and V in shared memory for the whole walk. Q and
//     dO tiles of 64 rows, with their 64 lse and di values, arrive by
//     cp.async into a two-stage ring. Per tile a warp computes S^T = K Q^T
//     and dP^T = V dO^T (A rows from shared memory, Q and dO the `.col` B
//     operands through `ldmatrix`), P^T = exp(S^T scale - lse) in fp32,
//     rounds it into A fragments in registers for dV += P^T dO, then dS^T =
//     P^T (dP^T - di) scale, rounded the same way for dK += dS^T Q (dO and
//     Q read as B operands through `ldmatrix.trans` from the same tiles).
//     dK and dV stay in fp32 registers. Causal blocks start at the
//     diagonal tile.
//   `flash_mha_bwd_dq_mma_kernel`: 4 warps take 64 query rows, Q and dO in
//     shared memory, each lane's two rows' lse and di in registers; K and V
//     tiles stream through the ring. S = Q K^T, dP = dO V^T, dS packed into
//     A fragments for dQ += dS K (K through `ldmatrix.trans`). Causal blocks
//     stop at the diagonal tile, where each warp skips the key groups
//     wholly past its rows.
// The A operands are read from shared memory at every tile, not held in
// registers: at dh 128 the dK and dV sums alone take 128 registers a
// thread, and K and V fragments as well would pass 255 and spill; at dh 64,
// where they fit, they left dk/dv 2 blocks an SM instead of 3, and both
// kernels ran slower on an H100. exp is exp2 of the scores in log2 units,
// lse scaled by log2(e) as it is read.
// Only the tiles at the diagonal or holding L are masked: p is set to 0
// explicitly at keys or rows at or past L (zero-filled rows score 0, not
// -inf) and past the diagonal; lse and di past L are staged as 0, never
// read out of bounds. Shared memory: 6 x 64 x (dh + 8) bf16 (55 KB at dh
// 64, 104 KB at dh 128), dk/dv 512 bytes more for lse and di.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int kBlock = 64;          // rows per block, rows per tile
constexpr int kThreads = 256;       // a 16 x 16 grid of threads
constexpr int kPad = 4;             // floats of padding per row
constexpr int kPRow = kBlock + kPad;

// What both passes read: q, k and v through their strides, and the shape.
struct Inputs {
  const void* q;
  const void* k;
  const void* v;
  long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh;
  int seqlen, heads, causal;
  int dh;       // the head width (the row length of out, do, dq, dk, dv)
  int slices;   // 128-column slices of a head wider than 128, else 1
  float scale;
};

// Each pass takes its own outputs, so the forward's parameters stay small:
// with the backward's pointers in its struct as well, ptxas gave the
// forward fewer registers and it ran slower on an H100.
struct FwdParams : Inputs {
  void* out;         // (B, L, H * dh) contiguous
  float* lse;        // (B, H, L)
};

struct BwdParams : Inputs {
  const void* out;   // (B, L, H * dh) contiguous
  const float* lse;  // (B, H, L)
  const void* dout;  // (B, L, H * dh) contiguous
  float* di;         // (B, H, L)
  void* dq;          // (B, L, H, dh) contiguous
  void* dk;
  void* dv;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows r0 .. r0 + 63 (row stride in elements) into shared memory as fp32
// rows of DH + kPad floats; rows at or past L and columns at or past `cols`
// are zeros.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int seqlen, int cols) {
  constexpr int kVec = DH / 4;
  for (int idx = threadIdx.x; idx < kBlock * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < seqlen && c < cols) {
      val = load4(src + static_cast<long long>(r0 + r) * row_stride + c);
    }
    store4(dst + r * (DH + kPad) + c, val);
  }
}

// 64 values of a (B, H, L) fp32 row into shared memory (0 past L).
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int r0, int seqlen) {
  if (threadIdx.x < kBlock) {
    const int i = r0 + threadIdx.x;
    dst[threadIdx.x] = i < seqlen ? src[i] : 0.f;
  }
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  }
}

// acc[r][q] += sum_c X[4 ty + r][c] * Y[tx + 16 q][c].
template <int DH>
__device__ __forceinline__ void product_nt_add(float (&acc)[4][4],
                                               const float* X, const float* Y,
                                               int ty, int tx) {
  constexpr int ld = DH + kPad;
#pragma unroll 2
  for (int c = 0; c < DH; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = load4(X + (ty * 4 + r) * ld + c);
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = load4(Y + (tx + 16 * q) * ld + c);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = acc[r][q];
        s = fmaf(a[r].x, b[q].x, s);
        s = fmaf(a[r].y, b[q].y, s);
        s = fmaf(a[r].z, b[q].z, s);
        s = fmaf(a[r].w, b[q].w, s);
        acc[r][q] = s;
      }
    }
  }
}

// acc[r][4 g + e] += sum_j P[4 ty + r][j] * Y[j][4 tx + 64 g + e].
template <int DH>
__device__ __forceinline__ void product_nn(float (&acc)[4][DH / 16],
                                           const float* P, const float* Y,
                                           int ty, int tx) {
  constexpr int ld = DH + kPad;
#pragma unroll 2
  for (int j = 0; j < kBlock; j += 4) {
    float4 p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = load4(P + (ty * 4 + r) * kPRow + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int g = 0; g < DH / 64; ++g) {
        const float4 y = load4(Y + (j + jj) * ld + tx * 4 + 64 * g);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float pv = jj == 0 ? p[r].x : jj == 1 ? p[r].y
                         : jj == 2 ? p[r].z : p[r].w;
          acc[r][4 * g + 0] = fmaf(pv, y.x, acc[r][4 * g + 0]);
          acc[r][4 * g + 1] = fmaf(pv, y.y, acc[r][4 * g + 1]);
          acc[r][4 * g + 2] = fmaf(pv, y.z, acc[r][4 * g + 2]);
          acc[r][4 * g + 3] = fmaf(pv, y.w, acc[r][4 * g + 3]);
        }
      }
    }
  }
}

// Rows i0 + 4 ty + r (< L) of a contiguous (B, L, H, dh) output: columns
// os DH .. os DH + DH - 1 (slice os), those below dh.
template <int DH>
__device__ __forceinline__ void store_rows(float* dst, const Inputs& p,
                                           long long b, int h, int i0,
                                           int os,
                                           const float (&acc)[4][DH / 16],
                                           int ty, int tx) {
  const int cols = min(DH, p.dh - os * DH);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= p.seqlen) continue;
    float* row = dst + ((b * p.seqlen + i) * p.heads + h) * p.dh + os * DH;
#pragma unroll
    for (int g = 0; g < DH / 64; ++g) {
      if (tx * 4 + 64 * g >= cols) continue;
      store4(row + tx * 4 + 64 * g,
             make_float4(acc[r][4 * g], acc[r][4 * g + 1],
                         acc[r][4 * g + 2], acc[r][4 * g + 3]));
    }
  }
}

// Max and sum over the 16 lanes that share a row group (lanes of one half
// of the warp).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Forward: 64 query rows of one (batch, head).
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_mha_fwd_kernel(FwdParams p) {
  extern __shared__ float smem[];
  constexpr int ld = DH + kPad;
  constexpr int kCols = DH / 16;
  float* Qs = smem;
  float* Ks = Qs + kBlock * ld;
  float* Vs = Ks + kBlock * ld;
  float* Ps = Vs + kBlock * ld;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tile = blockIdx.x / p.slices;  // the query tile
  const int os = blockIdx.x % p.slices;    // the output's column slice
  const int cols = min(DH, p.dh);
  const int i0 = tile * kBlock;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;

  if (p.slices == 1) load_tile<DH>(Qs, q, p.sql, i0, p.seqlen, cols);

  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[r][c] = 0.f;
  }

  int ntiles = (p.seqlen + kBlock - 1) / kBlock;
  if (p.causal) ntiles = min(ntiles, tile + 1);
  for (int kt = 0; kt < ntiles; ++kt) {
    const int j0 = kt * kBlock;
    // the scores summed over the head's column slices; V of the output's
    float s[4][4];
    zero4(s);
    for (int sl = 0; sl < p.slices; ++sl) {
      __syncthreads();  // the previous readers are done
      if (p.slices > 1) {
        load_tile<DH>(Qs, q + sl * DH, p.sql, i0, p.seqlen, DH);
      }
      load_tile<DH>(Ks, k + sl * DH, p.skl, j0, p.seqlen, cols);
      if (sl == p.slices - 1) {
        load_tile<DH>(Vs, v + os * DH, p.svl, j0, p.seqlen, cols);
      }
      __syncthreads();
      product_nt_add<DH>(s, Qs, Ks, ty, tx);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      float mt = -INFINITY;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int j = j0 + tx + 16 * qq;
        const bool keep = j < p.seqlen && (!p.causal || j <= i);
        s[r][qq] = keep ? s[r][qq] * p.scale : -INFINITY;
        mt = fmaxf(mt, s[r][qq]);
      }
      mt = max16(mt);
      const float m_new = fmaxf(m[r], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const float pv = expf(s[r][qq] - m_use);
        rs += pv;
        Ps[(ty * 4 + r) * kPRow + tx + 16 * qq] = pv;
      }
      rs = sum16(rs);
      l[r] = alpha * l[r] + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[r][c] *= alpha;
    }
    __syncthreads();
    product_nn<DH>(o, Ps, Vs, ty, tx);
  }

  float* lse = p.lse + (b * p.heads + h) * p.seqlen;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[r][c] *= inv;
    const int i = i0 + ty * 4 + r;
    if (os == 0 && tx == 0 && i < p.seqlen) lse[i] = m[r] + logf(l[r]);
  }
  store_rows<DH>(static_cast<float*>(p.out), p, b, h, i0, os, o, ty, tx);
}

template <int DH>
cudaError_t launch(const FwdParams& p, long long batch,
                   cudaStream_t stream) {
  const int smem = (3 * kBlock * (DH + kPad) + kBlock * kPRow) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_fwd_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seqlen + kBlock - 1) / kBlock * p.slices, p.heads,
                  static_cast<unsigned>(batch));
  flash_mha_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Forward in bf16 on the tensor cores: 64 query rows of one (batch, head),
// 16 a warp (see the note at the top).
constexpr int kMmaWarps = 4;

template <int DH, int kVec, bool kSliced>
__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_mha_fwd_mma_kernel(FwdParams p) {
  // the column slices: 1 at compile time below 128 columns
  const int slices = kSliced ? p.slices : 1;
  using namespace attn_mma;
  constexpr int ld = row_stride(DH);
  constexpr int kTile = kKeyTile * ld;             // one 64-row tile
  // a stage: K and V tiles (kSliced: the q, K and V column slices)
  constexpr int kStage = (kSliced ? 3 : 2) * kTile;
  extern __shared__ float4 smem4[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem4);   // 2 stages
  uint16_t* sq = ring + kStage;                    // q, in stage 1 at first

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x / slices;          // the query tile
  const int os = blockIdx.x % slices;            // the output's slice
  const int cols = min(DH, p.dh);
  const int i0 = tile * kBlock;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int L = p.seqlen;
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.sqb + h * p.sqh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.skb + h * p.skh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.svb + h * p.svh;

  int ntiles = (L + kKeyTile - 1) / kKeyTile;
  if (p.causal) ntiles = min(ntiles, tile + 1);
  // walk step t: key tile t / slices, column slice t % slices (the scores
  // summed over the slices; V of the output's slice with the last)
  const int steps = ntiles * slices;
  auto issue = [&](int t) {
    uint16_t* stage = ring + (t & 1) * kStage;
    const int j0 = t / slices * kKeyTile;
    const int sl = t % slices;
    if constexpr (kSliced) {
      copy_rows<kVec, DH>(stage, ld, q + sl * DH, p.sql, i0, kBlock, L, DH);
      copy_rows<kVec, DH>(stage + kTile, ld, k + sl * DH, p.skl, j0,
                          kKeyTile, L, DH);
      if (sl == slices - 1) {
        copy_rows<kVec, DH>(stage + 2 * kTile, ld, v + os * DH, p.svl, j0,
                            kKeyTile, L, DH);
      }
    } else {
      copy_rows<kVec, DH>(stage, ld, k, p.skl, j0, kKeyTile, L, cols);
      copy_rows<kVec, DH>(stage + kTile, ld, v, p.svl, j0, kKeyTile, L,
                          cols);
    }
  };
  if constexpr (!kSliced) {
    copy_rows<kVec, DH>(sq, ld, q, p.sql, i0, kBlock, L, cols);
  }
  issue(0);
  cp_async_commit();

  const int wrow = i0 + warp * 16;                 // the warp's first row
  const int g = lane / 4;
  const bool active = wrow < L;
  // q into registers before stage 1 takes the next tile
  uint32_t qf[DH / 16][4];
  if constexpr (!kSliced) {
    cp_async_wait<0>();
    __syncthreads();
    if (active) load_q<DH>(qf, sq + warp * 16 * ld, lane);
  }

  float o[DH / 8][4];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  }
  // the running max in log2 units (the scores times scale log2(e)) and
  // each lane's part of the sum
  const float scale2 = p.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[8][4];

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<0>();                            // this step's copies,
    __syncthreads();                               // and q or the last step's
    if (t + 1 < steps) {                           // stage read: it is free
      issue(t + 1);                                // during this step
      cp_async_commit();
    }
    if (!active) continue;
    const uint16_t* stage = ring + (t & 1) * kStage;
    const int kt = t / slices;
    const int j0 = kt * kKeyTile;
    const bool diag = p.causal && kt == tile;
    int groups = min(kKeyGroups, (L - j0 + 15) / 16);
    if (diag) groups = min(groups, warp + 1);      // keys past the rows
    if constexpr (kSliced) {
      if (t % slices == 0) zero_tile(s);
      tile_scores_shared_add<DH>(s, stage + warp * 16 * ld, stage + kTile,
                                 groups, lane);
      if (t % slices != slices - 1) continue;
    } else {
      tile_scores<DH>(s, qf, stage, groups, lane);
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= scale2;
    }
    if (diag || j0 + kKeyTile > L) mask_tile(s, j0, L, wrow + g, diag, lane);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(row_max(s, r)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[nb][e] = nb / 2 < groups ? exp2f(s[nb][e] - m_use) : 0.f;
          sum += s[nb][e];
        }
      }
      l[r] = alpha[r] * l[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] *= alpha[e / 2];
    }
    uint32_t w[kKeyGroups][4];
    pack_weights(w, s);                            // p rounded to bf16
    tile_pv<DH>(o, w, stage + (kSliced ? 2 : 1) * kTile, groups, lane);
  }

  if (!active) return;
  float* lse = p.lse + (b * p.heads + h) * L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wrow + g + 8 * r;
    const float lr = quad_sum(l[r]);
    if (i >= L) continue;
    if (os == 0 && lane % 4 == 0) lse[i] = m[r] * kLn2 + logf(lr);
    const float inv = 1.f / lr;
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) +
                         ((b * L + i) * p.heads + h) * p.dh + os * DH;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      if (c * 8 >= cols) continue;
      *reinterpret_cast<__nv_bfloat162*>(dst + c * 8 + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[c][2 * r] * inv, o[c][2 * r + 1] * inv);
    }
  }
}

template <int DH, int kVec, bool kSliced>
cudaError_t launch_mma(const FwdParams& p, long long batch,
                       cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(uint16_t)) *
                   attn_mma::row_stride(DH) * (kSliced ? 6 : 4) *
                   attn_mma::kKeyTile;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_fwd_mma_kernel<DH, kVec, kSliced>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seqlen + kBlock - 1) / kBlock * p.slices, p.heads,
                  static_cast<unsigned>(batch));
  flash_mha_fwd_mma_kernel<DH, kVec, kSliced>
      <<<grid, kMmaWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// The widest copy (in bf16) that q, k, v and every stride allow (`extra`:
// another pointer the kernels read, or 0).
int copy_vec(const Inputs& p, const void* extra) {
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(p.q) |
      reinterpret_cast<unsigned long long>(p.k) |
      reinterpret_cast<unsigned long long>(p.v) |
      reinterpret_cast<unsigned long long>(extra) |
      2ull * static_cast<unsigned long long>(p.sqb | p.sql | p.sqh | p.skb |
                                             p.skl | p.skh | p.svb | p.svl |
                                             p.svh);
  return attn_mma::vec_for(bits);
}

// One of a kernel family's instantiations by head width: 64 or 128
// columns (zero-filled past dh), or 128-column slices above 128.
template <template <int, int, bool> class F, int kVec, typename P>
cudaError_t by_width(const P& p, long long batch, cudaStream_t stream) {
  if (p.slices > 1) return F<128, kVec, true>::run(p, batch, stream);
  if (p.dh <= 64) return F<64, kVec, false>::run(p, batch, stream);
  return F<128, kVec, false>::run(p, batch, stream);
}

template <int DH, int kVec, bool kSliced>
struct FwdMma {
  static cudaError_t run(const FwdParams& p, long long batch,
                         cudaStream_t stream) {
    return launch_mma<DH, kVec, kSliced>(p, batch, stream);
  }
};

// The bf16 forward: 16-byte copies where every pointer and stride allows
// them, else 8-byte ones (strides in multiples of 4, as the wrapper
// requires).
cudaError_t launch_fwd_mma(const FwdParams& p, long long batch,
                           cudaStream_t stream) {
  const int vec = copy_vec(p, nullptr);
  if (vec < 4) return cudaErrorInvalidValue;
  return vec == 8 ? by_width<FwdMma, 8>(p, batch, stream)
                  : by_width<FwdMma, 4>(p, batch, stream);
}

// Backward.

// di[b, h, i] = sum_c o[b, i, h, c] * do[b, i, h, c]: kLanes lanes a row
// (8, 16 or 32), each reading 16 bytes of o and of do at a time, so a warp
// takes 32 / kLanes whole rows in one coalesced load each at dh 64 and 128
// (out and do are 16-byte aligned, as the wrapper requires, and dh a
// multiple of 8).
template <typename T, int kLanes>
__global__ void __launch_bounds__(kThreads)
    flash_mha_bwd_di(BwdParams p, long long rows) {
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
  float acc = 0.f;
  if (row < rows) {
    for (int c = (threadIdx.x % kLanes) * kElems; c < p.dh;
         c += kLanes * kElems) {
      const uint4 ov = *reinterpret_cast<const uint4*>(
          static_cast<const T*>(p.out) + row * p.dh + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(
          static_cast<const T*>(p.dout) + row * p.dh + c);
      const T* o = reinterpret_cast<const T*>(&ov);
      const T* g = reinterpret_cast<const T*>(&gv);
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc += to_float(o[e]) * to_float(g[e]);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (row < rows && threadIdx.x % kLanes == 0) {
    const int h = static_cast<int>(row % p.heads);
    const long long bi = row / p.heads;  // b * L + i
    const long long b = bi / p.seqlen;
    const int i = static_cast<int>(bi % p.seqlen);
    p.di[(b * p.heads + h) * p.seqlen + i] = acc;
  }
}

// dk and dv for keys j0 .. j0 + 63 of one (batch, head).
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_mha_bwd_dkdv_kernel(BwdParams p) {
  extern __shared__ float smem[];
  constexpr int ld = DH + kPad;
  constexpr int kCols = DH / 16;
  float* Ks = smem;
  float* Vs = Ks + kBlock * ld;
  float* Qs = Vs + kBlock * ld;
  float* Os = Qs + kBlock * ld;   // dO
  float* Ps = Os + kBlock * ld;   // round(p)^T: [key][query]
  float* Ss = Ps + kBlock * kPRow;  // round(ds)^T
  float* lse_s = Ss + kBlock * kPRow;
  float* di_s = lse_s + kBlock;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tile = blockIdx.x / p.slices;  // the key tile
  const int os = blockIdx.x % p.slices;    // the outputs' column slice
  const int cols = min(DH, p.dh);
  const int j0 = tile * kBlock;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long row_stride = static_cast<long long>(p.heads) * p.dh;
  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
  const float* dout = static_cast<const float*>(p.dout) +
                  b * p.seqlen * row_stride + h * p.dh;
  const float* lse = p.lse + (b * p.heads + h) * p.seqlen;
  const float* di = p.di + (b * p.heads + h) * p.seqlen;

  if (p.slices == 1) {
    load_tile<DH>(Ks, k, p.skl, j0, p.seqlen, cols);
    load_tile<DH>(Vs, v, p.svl, j0, p.seqlen, cols);
  }

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[r][c] = 0.f;
      dv[r][c] = 0.f;
    }
  }

  const int ntiles = (p.seqlen + kBlock - 1) / kBlock;
  for (int qt = p.causal ? tile : 0; qt < ntiles; ++qt) {
    const int i0 = qt * kBlock;
    // s^T: [key][query] and (do v^T)^T summed over the column slices, the
    // output's slice last, so that Qs and Os end holding it
    float s[4][4], dp[4][4];
    zero4(s);
    zero4(dp);
    for (int r = 0; r < p.slices; ++r) {
      const int sl = (os + 1 + r) % p.slices;
      __syncthreads();  // the previous readers are done
      if (p.slices > 1) {
        load_tile<DH>(Ks, k + sl * DH, p.skl, j0, p.seqlen, DH);
        load_tile<DH>(Vs, v + sl * DH, p.svl, j0, p.seqlen, DH);
      }
      load_tile<DH>(Qs, q + sl * DH, p.sql, i0, p.seqlen, cols);
      load_tile<DH>(Os, dout + sl * DH, row_stride, i0, p.seqlen, cols);
      if (r == 0) {
        load_row(lse_s, lse, i0, p.seqlen);
        load_row(di_s, di, i0, p.seqlen);
      }
      __syncthreads();
      product_nt_add<DH>(s, Ks, Qs, ty, tx);
      product_nt_add<DH>(dp, Vs, Os, ty, tx);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty * 4 + r;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int il = tx + 16 * qq;
        const int i = i0 + il;
        const bool keep = i < p.seqlen && j < p.seqlen &&
                          (!p.causal || j <= i);
        const float pv = keep ? expf(s[r][qq] * p.scale - lse_s[il]) : 0.f;
        const float ds = pv * (dp[r][qq] - di_s[il]) * p.scale;
        Ps[(ty * 4 + r) * kPRow + il] = pv;
        Ss[(ty * 4 + r) * kPRow + il] = ds;
      }
    }
    __syncthreads();
    product_nn<DH>(dv, Ps, Os, ty, tx);
    product_nn<DH>(dk, Ss, Qs, ty, tx);
  }
  store_rows<DH>(static_cast<float*>(p.dk), p, b, h, j0, os, dk, ty, tx);
  store_rows<DH>(static_cast<float*>(p.dv), p, b, h, j0, os, dv, ty, tx);
}

// dq for query rows i0 .. i0 + 63 of one (batch, head).
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_mha_bwd_dq_kernel(BwdParams p) {
  extern __shared__ float smem[];
  constexpr int ld = DH + kPad;
  constexpr int kCols = DH / 16;
  float* Qs = smem;
  float* Os = Qs + kBlock * ld;   // dO
  float* Ks = Os + kBlock * ld;
  float* Vs = Ks + kBlock * ld;
  float* Ss = Vs + kBlock * ld;   // round(ds): [query][key]
  float* lse_s = Ss + kBlock * kPRow;
  float* di_s = lse_s + kBlock;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tile = blockIdx.x / p.slices;  // the query tile
  const int os = blockIdx.x % p.slices;    // the output's column slice
  const int cols = min(DH, p.dh);
  const int i0 = tile * kBlock;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long row_stride = static_cast<long long>(p.heads) * p.dh;
  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
  const float* dout = static_cast<const float*>(p.dout) +
                      b * p.seqlen * row_stride + h * p.dh;

  if (p.slices == 1) {
    load_tile<DH>(Qs, q, p.sql, i0, p.seqlen, cols);
    load_tile<DH>(Os, dout, row_stride, i0, p.seqlen, cols);
  }
  load_row(lse_s, p.lse + (b * p.heads + h) * p.seqlen, i0, p.seqlen);
  load_row(di_s, p.di + (b * p.heads + h) * p.seqlen, i0, p.seqlen);

  float dq[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[r][c] = 0.f;
  }

  int ntiles = (p.seqlen + kBlock - 1) / kBlock;
  if (p.causal) ntiles = min(ntiles, tile + 1);
  for (int kt = 0; kt < ntiles; ++kt) {
    const int j0 = kt * kBlock;
    // s and do v^T summed over the column slices, the output's slice last,
    // so that Ks ends holding it
    float s[4][4], dp[4][4];
    zero4(s);
    zero4(dp);
    for (int r = 0; r < p.slices; ++r) {
      const int sl = (os + 1 + r) % p.slices;
      __syncthreads();
      if (p.slices > 1) {
        load_tile<DH>(Qs, q + sl * DH, p.sql, i0, p.seqlen, DH);
        load_tile<DH>(Os, dout + sl * DH, row_stride, i0, p.seqlen, DH);
      }
      load_tile<DH>(Ks, k + sl * DH, p.skl, j0, p.seqlen, cols);
      load_tile<DH>(Vs, v + sl * DH, p.svl, j0, p.seqlen, cols);
      __syncthreads();
      product_nt_add<DH>(s, Qs, Ks, ty, tx);
      product_nt_add<DH>(dp, Os, Vs, ty, tx);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = ty * 4 + r;
      const int i = i0 + il;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int j = j0 + tx + 16 * qq;
        const bool keep = i < p.seqlen && j < p.seqlen &&
                          (!p.causal || j <= i);
        const float pv = keep ? expf(s[r][qq] * p.scale - lse_s[il]) : 0.f;
        const float ds = pv * (dp[r][qq] - di_s[il]) * p.scale;
        Ss[il * kPRow + tx + 16 * qq] = ds;
      }
    }
    __syncthreads();
    product_nn<DH>(dq, Ss, Ks, ty, tx);
  }
  store_rows<DH>(static_cast<float*>(p.dq), p, b, h, i0, os, dq, ty, tx);
}

// di, the first of the backward's three kernels in both types.
template <typename T, int kLanes>
cudaError_t launch_di_lanes(const BwdParams& p, long long batch,
                            cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / kLanes;
  const long long rows = batch * p.seqlen * p.heads;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_mha_bwd_di<T, kLanes><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(p, rows);
  return cudaGetLastError();
}

// As many lanes a row as its 16-byte pieces, 8 to 32.
template <typename T>
cudaError_t launch_di(const BwdParams& p, long long batch,
                      cudaStream_t stream) {
  const int pieces = p.dh * static_cast<int>(sizeof(T)) / 16;
  if (pieces <= 8) return launch_di_lanes<T, 8>(p, batch, stream);
  if (pieces <= 16) return launch_di_lanes<T, 16>(p, batch, stream);
  return launch_di_lanes<T, 32>(p, batch, stream);
}

// The fp32 backward on the SIMT kernels.
template <int DH>
cudaError_t launch(const BwdParams& p, long long batch,
                   cudaStream_t stream) {
  cudaError_t err = launch_di<float>(p, batch, stream);
  if (err != cudaSuccess) return err;

  const int tile = kBlock * (DH + kPad);
  const int extra = kBlock * kPRow + 2 * kBlock;
  const int smem_dkdv =
      (4 * tile + kBlock * kPRow + extra) * static_cast<int>(sizeof(float));
  const int smem_dq = (4 * tile + extra) * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_mha_bwd_dkdv_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkdv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_mha_bwd_dq_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seqlen + kBlock - 1) / kBlock * p.slices, p.heads,
                  static_cast<unsigned>(batch));
  flash_mha_bwd_dkdv_kernel<DH><<<grid, kThreads, smem_dkdv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_mha_bwd_dq_kernel<DH><<<grid, kThreads, smem_dq, stream>>>(p);
  return cudaGetLastError();
}

// The backward in bf16 on the tensor cores (see the note at the top).

// 64 fp32 values of a (B, H, L) row from r0 by 4-byte cp.async; 0 at and
// past L (nothing read there).
__device__ __forceinline__ void copy_row_async(float* dst, const float* src,
                                               int r0, int seqlen) {
  for (int idx = threadIdx.x; idx < kBlock; idx += blockDim.x) {
    const bool valid = r0 + idx < seqlen;
    attn_mma::cp_async<4>(dst + idx, valid ? src + r0 + idx : src,
                          valid ? 4 : 0);
  }
}

// bf16 rows i (< L) of a contiguous (B, L, H, dh) output from the fp32 C
// fragments of a warp whose lane holds rows row and row + 8: columns os DH
// .. os DH + DH - 1 (slice os), those below dh.
template <int DH>
__device__ __forceinline__ void store_fragments(void* dst, const Inputs& p,
                                                long long b, int h, int row,
                                                int os,
                                                const float (&acc)[DH / 8][4],
                                                int lane) {
  const int cols = min(DH, p.dh - os * DH);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i >= p.seqlen) continue;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dst) +
                         ((b * p.seqlen + i) * p.heads + h) * p.dh + os * DH;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      if (c * 8 >= cols) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + c * 8 + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[c][2 * r], acc[c][2 * r + 1]);
    }
  }
}

template <int DH>
__device__ __forceinline__ void zero(float (&acc)[DH / 8][4]) {
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  }
}

// dk and dv for keys j0 .. j0 + 63 of one (batch, head), 16 a warp. Above
// 128 columns (kSliced) a stage holds the Q, dO, K and V column slices, the
// scores are summed over the slices and the outputs' slice comes last.
template <int DH, int kVec, bool kSliced>
__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_mha_bwd_dkdv_mma_kernel(BwdParams p) {
  // the column slices: 1 at compile time below 128 columns
  const int slices = kSliced ? p.slices : 1;
  using namespace attn_mma;
  constexpr int ld = row_stride(DH);
  constexpr int kTile = kBlock * ld;               // one 64-row bf16 tile
  constexpr int kStage = (kSliced ? 4 : 2) * kTile;
  extern __shared__ float4 smem4[];
  uint16_t* sk = reinterpret_cast<uint16_t*>(smem4);
  uint16_t* sv = sk + kTile;
  uint16_t* ring = kSliced ? sk : sv + kTile;      // 2 stages of Q, dO
  float* rows = reinterpret_cast<float*>(ring + 2 * kStage);  // lse, di

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x / slices;          // the key tile
  const int os = blockIdx.x % slices;            // the outputs' slice
  const int cols = min(DH, p.dh);
  const int j0 = tile * kBlock;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int L = p.seqlen;
  const long long dstride = static_cast<long long>(p.heads) * p.dh;
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.sqb + h * p.sqh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.skb + h * p.skh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.svb + h * p.svh;
  const uint16_t* dout =
      static_cast<const uint16_t*>(p.dout) + b * L * dstride + h * p.dh;
  const float* lse = p.lse + (b * p.heads + h) * L;
  const float* di = p.di + (b * p.heads + h) * L;

  const int first = p.causal ? tile : 0;
  const int ntiles = (L + kBlock - 1) / kBlock;
  // walk step t: query tile first + t / slices, column slice (os + 1 +
  // t % slices) % slices
  const int steps = (ntiles - first) * slices;
  auto issue = [&](int t) {
    const int i0 = (first + t / slices) * kBlock;
    const int sl = (os + 1 + t % slices) % slices;
    uint16_t* sq = ring + (t & 1) * kStage;
    copy_rows<kVec, DH>(sq, ld, q + sl * DH, p.sql, i0, kBlock, L, cols);
    copy_rows<kVec, DH>(sq + kTile, ld, dout + sl * DH, dstride, i0, kBlock,
                        L, cols);
    if constexpr (kSliced) {
      copy_rows<kVec, DH>(sq + 2 * kTile, ld, k + sl * DH, p.skl, j0,
                          kBlock, L, DH);
      copy_rows<kVec, DH>(sq + 3 * kTile, ld, v + sl * DH, p.svl, j0,
                          kBlock, L, DH);
    }
    copy_row_async(rows + (t & 1) * 2 * kBlock, lse, i0, L);
    copy_row_async(rows + (t & 1) * 2 * kBlock + kBlock, di, i0, L);
  };
  if constexpr (!kSliced) {
    copy_rows<kVec, DH>(sk, ld, k, p.skl, j0, kBlock, L, cols);
    copy_rows<kVec, DH>(sv, ld, v, p.svl, j0, kBlock, L, cols);
  }
  issue(0);
  cp_async_commit();

  const int key = j0 + warp * 16 + lane / 4;       // the lane's first key
  const bool active = j0 + warp * 16 < L;
  const float scale2 = p.scale * kLog2e;
  float dk[DH / 8][4], dv[DH / 8][4];
  zero<DH>(dk);
  zero<DH>(dv);
  float st[8][4], dpt[8][4];

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<0>();                            // this step's copies,
    __syncthreads();                               // and the other stage free
    if (t + 1 < steps) {
      issue(t + 1);
      cp_async_commit();
    }
    if (!active) continue;
    const int qt = first + t / slices;
    const uint16_t* sq = ring + (t & 1) * kStage;
    const uint16_t* sdo = sq + kTile;
    const float* slse = rows + (t & 1) * 2 * kBlock;
    const float* sdi = slse + kBlock;
    const int i0 = qt * kBlock;
    const int groups = min(kKeyGroups, (L - i0 + 15) / 16);
    const bool edge = (p.causal && qt == first) || i0 + kBlock > L;

    // S^T (and, sliced, dP^T) summed over the slices
    if constexpr (kSliced) {
      if (t % slices == 0) {
        zero_tile(st);
        zero_tile(dpt);
      }
      tile_scores_shared_add<DH>(st, sq + 2 * kTile + warp * 16 * ld, sq,
                                 groups, lane);
      tile_scores_shared_add<DH>(dpt, sq + 3 * kTile + warp * 16 * ld, sdo,
                                 groups, lane);
      if (t % slices != slices - 1) continue;
    } else {
      tile_scores_shared<DH>(st, sk + warp * 16 * ld, sq, groups, lane);
    }
    // P^T = exp(S^T scale - lse) in fp32: rows keys, columns queries
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = nb * 8 + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(slse + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + col + (e & 1);
        const int j = key + (e / 2) * 8;
        const float lrow = (e & 1) ? l2.y : l2.x;
        float x = exp2f(fmaf(st[nb][e], scale2, -lrow * kLog2e));
        if (edge && (i >= L || (p.causal && j > i))) x = 0.f;
        st[nb][e] = x;
      }
    }
    uint32_t w[kKeyGroups][4];
    pack_weights(w, st);                           // round(P^T)
    tile_pv<DH>(dv, w, sdo, groups, lane);         // dV += round(P^T) dO

    // dS^T = P^T (dP^T - di) scale
    if constexpr (!kSliced) {
      tile_scores_shared<DH>(dpt, sv + warp * 16 * ld, sdo, groups, lane);
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(sdi + nb * 8 + 2 * (lane % 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[nb][e] = st[nb][e] * (dpt[nb][e] - ((e & 1) ? d2.y : d2.x)) *
                    p.scale;
      }
    }
    pack_weights(w, st);                           // round(dS^T)
    tile_pv<DH>(dk, w, sq, groups, lane);          // dK += round(dS^T) Q
  }
  if (!active) return;
  store_fragments<DH>(p.dk, p, b, h, key, os, dk, lane);
  store_fragments<DH>(p.dv, p, b, h, key, os, dv, lane);
}

// dq for query rows i0 .. i0 + 63 of one (batch, head), 16 a warp. Above
// 128 columns (kSliced) a stage holds the K, V, Q and dO column slices, the
// scores are summed over the slices and the output's slice comes last.
template <int DH, int kVec, bool kSliced>
__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_mha_bwd_dq_mma_kernel(BwdParams p) {
  // the column slices: 1 at compile time below 128 columns
  const int slices = kSliced ? p.slices : 1;
  using namespace attn_mma;
  constexpr int ld = row_stride(DH);
  constexpr int kTile = kBlock * ld;
  constexpr int kStage = (kSliced ? 4 : 2) * kTile;
  extern __shared__ float4 smem4[];
  uint16_t* sq = reinterpret_cast<uint16_t*>(smem4);
  uint16_t* sdo = sq + kTile;
  uint16_t* ring = kSliced ? sq : sdo + kTile;     // 2 stages of K, V

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x / slices;          // the query tile
  const int os = blockIdx.x % slices;            // the output's slice
  const int cols = min(DH, p.dh);
  const int i0 = tile * kBlock;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int L = p.seqlen;
  const long long dstride = static_cast<long long>(p.heads) * p.dh;
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.sqb + h * p.sqh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.skb + h * p.skh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.svb + h * p.svh;
  const uint16_t* dout =
      static_cast<const uint16_t*>(p.dout) + b * L * dstride + h * p.dh;

  int ntiles = (L + kBlock - 1) / kBlock;
  if (p.causal) ntiles = min(ntiles, tile + 1);
  // walk step t: key tile t / slices, column slice (os + 1 + t % slices) %
  // slices
  const int steps = ntiles * slices;
  auto issue = [&](int t) {
    const int j0 = t / slices * kBlock;
    const int sl = (os + 1 + t % slices) % slices;
    uint16_t* stage = ring + (t & 1) * kStage;
    copy_rows<kVec, DH>(stage, ld, k + sl * DH, p.skl, j0, kBlock, L, cols);
    copy_rows<kVec, DH>(stage + kTile, ld, v + sl * DH, p.svl, j0, kBlock, L,
                        cols);
    if constexpr (kSliced) {
      copy_rows<kVec, DH>(stage + 2 * kTile, ld, q + sl * DH, p.sql, i0,
                          kBlock, L, DH);
      copy_rows<kVec, DH>(stage + 3 * kTile, ld, dout + sl * DH, dstride, i0,
                          kBlock, L, DH);
    }
  };
  if constexpr (!kSliced) {
    copy_rows<kVec, DH>(sq, ld, q, p.sql, i0, kBlock, L, cols);
    copy_rows<kVec, DH>(sdo, ld, dout, dstride, i0, kBlock, L, cols);
  }
  issue(0);
  cp_async_commit();

  const int wrow = i0 + warp * 16;                 // the warp's first row
  const int g = lane / 4;
  const bool active = wrow < L;
  // the lane's two rows' lse (in log2 units) and di; 0 past L
  float lse2[2], dir[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wrow + g + 8 * r;
    const long long at = (b * p.heads + h) * L + i;
    lse2[r] = i < L ? p.lse[at] * kLog2e : 0.f;
    dir[r] = i < L ? p.di[at] : 0.f;
  }
  const float scale2 = p.scale * kLog2e;
  float dq[DH / 8][4];
  zero<DH>(dq);
  float s[8][4], dp[8][4];

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < steps) {
      issue(t + 1);
      cp_async_commit();
    }
    if (!active) continue;
    const uint16_t* stage = ring + (t & 1) * kStage;
    const int kt = t / slices;
    const int j0 = kt * kBlock;
    const bool diag = p.causal && kt == tile;
    int groups = min(kKeyGroups, (L - j0 + 15) / 16);
    if (diag) groups = min(groups, warp + 1);      // keys past the rows
    const bool edge = diag || j0 + kBlock > L;
    if constexpr (kSliced) {
      if (t % slices == 0) {
        zero_tile(s);
        zero_tile(dp);
      }
      tile_scores_shared_add<DH>(s, stage + 2 * kTile + warp * 16 * ld,
                                 stage, groups, lane);
      tile_scores_shared_add<DH>(dp, stage + 3 * kTile + warp * 16 * ld,
                                 stage + kTile, groups, lane);
      if (t % slices != slices - 1) continue;
    } else {
      tile_scores_shared<DH>(s, sq + warp * 16 * ld, stage, groups, lane);
      tile_scores_shared<DH>(dp, sdo + warp * 16 * ld, stage + kTile, groups,
                             lane);
    }
    // dS = P (dP - di) scale, P = exp(S scale - lse) in fp32
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int j = j0 + nb * 8 + 2 * (lane % 4) + (e & 1);
        float x = exp2f(fmaf(s[nb][e], scale2, -lse2[r]));
        if (edge && (j >= L || (p.causal && j > wrow + g + 8 * r))) x = 0.f;
        s[nb][e] = x * (dp[nb][e] - dir[r]) * p.scale;
      }
    }
    uint32_t w[kKeyGroups][4];
    pack_weights(w, s);                            // round(dS)
    tile_pv<DH>(dq, w, stage, groups, lane);       // dQ += round(dS) K
  }
  if (!active) return;
  store_fragments<DH>(p.dq, p, b, h, wrow + g, os, dq, lane);
}

template <int DH, int kVec, bool kSliced>
cudaError_t launch_mma_bwd(const BwdParams& p, long long batch,
                           cudaStream_t stream) {
  cudaError_t err = launch_di<__nv_bfloat16>(p, batch, stream);
  if (err != cudaSuccess) return err;
  const int tiles = static_cast<int>(sizeof(uint16_t)) *
                    attn_mma::row_stride(DH) * (kSliced ? 8 : 6) * kBlock;
  const int smem_dkdv = tiles + 4 * kBlock * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_mha_bwd_dkdv_mma_kernel<DH, kVec, kSliced>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkdv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_mha_bwd_dq_mma_kernel<DH, kVec, kSliced>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tiles);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seqlen + kBlock - 1) / kBlock * p.slices, p.heads,
                  static_cast<unsigned>(batch));
  flash_mha_bwd_dkdv_mma_kernel<DH, kVec, kSliced>
      <<<grid, kMmaWarps * 32, smem_dkdv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_mha_bwd_dq_mma_kernel<DH, kVec, kSliced>
      <<<grid, kMmaWarps * 32, tiles, stream>>>(p);
  return cudaGetLastError();
}

template <int DH, int kVec, bool kSliced>
struct BwdMma {
  static cudaError_t run(const BwdParams& p, long long batch,
                         cudaStream_t stream) {
    return launch_mma_bwd<DH, kVec, kSliced>(p, batch, stream);
  }
};

// The inputs both entries share; false if the kernels do not take them.
bool set_inputs(Inputs& p, int dtype, long long batch, int seqlen,
                int heads, int dh, int causal, float scale, long long sqb,
                long long sql, long long sqh, long long skb, long long skl,
                long long skh, long long svb, long long svl, long long svh,
                const void* q, const void* k, const void* v) {
  // head widths: any multiple of 8 up to 128, or of 128 above that
  const bool width_ok = dh > 0 && (dh <= 128 ? dh % 8 == 0 : dh % 128 == 0);
  if (batch < 1 || batch > 65535 || seqlen < 1 || heads < 1 ||
      heads > 65535 || !width_ok || (dtype != 0 && dtype != 1)) {
    return false;
  }
  p.q = q;
  p.k = k;
  p.v = v;
  p.sqb = sqb;
  p.sql = sql;
  p.sqh = sqh;
  p.skb = skb;
  p.skl = skl;
  p.skh = skh;
  p.svb = svb;
  p.svl = svl;
  p.svh = svh;
  p.seqlen = seqlen;
  p.heads = heads;
  p.causal = causal;
  p.dh = dh;
  p.slices = dh > 128 ? dh / 128 : 1;
  p.scale = scale;
  return true;
}

// The bf16 backward: 16-byte copies where every pointer and stride allows
// them, else 8-byte ones, as the forward.
cudaError_t launch_bwd_mma(const BwdParams& p, long long batch,
                           cudaStream_t stream) {
  const int vec = copy_vec(p, p.dout);
  if (vec < 4) return cudaErrorInvalidValue;
  return vec == 8 ? by_width<BwdMma, 8>(p, batch, stream)
                  : by_width<BwdMma, 4>(p, batch, stream);
}

// The fp32 SIMT kernels by head width: 64 or 128 columns (zero-filled past
// dh), or 128-column slices.
template <typename P>
cudaError_t launch_simt(const P& p, long long batch, cudaStream_t stream) {
  return p.dh <= 64 ? launch<64>(p, batch, stream)
                    : launch<128>(p, batch, stream);
}

}  // namespace

extern "C" {

// Launches K11's forward on `stream`. dtype: 0 float32 (the SIMT kernel),
// 1 bfloat16 (the tensor-core kernel); q, k, v and out share it. q, k, v:
// (batch, seqlen, heads, dh) with strides (batch, row, head) in elements,
// each a multiple of 4, 16-byte aligned; dh a multiple of 8 up to 128, or
// of 128 above that. out: contiguous
// (batch, seqlen, heads * dh); lse: contiguous fp32 (batch, heads,
// seqlen). Returns the cudaError_t of the launch (0 on success).
int flash_mha_fwd(int dtype, long long batch, int seqlen, int heads, int dh,
                  int causal, float scale, long long sqb, long long sql,
                  long long sqh, long long skb, long long skl, long long skh,
                  long long svb, long long svl, long long svh, const void* q,
                  const void* k, const void* v, void* out, void* lse,
                  void* stream) {
  FwdParams p{};
  if (!set_inputs(p, dtype, batch, seqlen, heads, dh, causal, scale, sqb,
                  sql, sqh, skb, skl, skh, svb, svl, svh, q, k, v)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.out = out;
  p.lse = static_cast<float*>(lse);
  // bf16 on the tensor cores, fp32 on the SIMT kernel
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = launch_fwd_mma(p, batch, s);
  } else {
    err = launch_simt(p, batch, s);
  }
  return static_cast<int>(err);
}

// Launches K11's backward on `stream` (three kernels: di, dkdv, dq; bf16 on
// the tensor cores, fp32 on the SIMT kernels). q, k, v, dtype and dh as
// `flash_mha_fwd` takes them (out, dout, dq, dk and dv share the dtype).
// out and dout: contiguous (batch, seqlen, heads * dh), 16-byte aligned;
// lse and the scratch di: contiguous fp32 (batch, heads, seqlen); dq, dk,
// dv: contiguous (batch, seqlen, heads, dh). Returns the cudaError_t of the
// launches (0 on success).
int flash_mha_bwd(int dtype, long long batch, int seqlen, int heads, int dh,
                  int causal, float scale, long long sqb, long long sql,
                  long long sqh, long long skb, long long skl, long long skh,
                  long long svb, long long svl, long long svh, const void* q,
                  const void* k, const void* v, const void* out,
                  const void* lse, const void* dout, void* di, void* dq,
                  void* dk, void* dv, void* stream) {
  BwdParams p{};
  if (!set_inputs(p, dtype, batch, seqlen, heads, dh, causal, scale, sqb,
                  sql, sqh, skb, skl, skh, svb, svl, svh, q, k, v)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.out = out;
  p.lse = static_cast<const float*>(lse);
  p.dout = dout;
  p.di = static_cast<float*>(di);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  // bf16 on the tensor cores, fp32 on the SIMT kernels
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = launch_bwd_mma(p, batch, s);
  } else {
    err = launch_simt(p, batch, s);
  }
  return static_cast<int>(err);
}

const char* flash_mha_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* flash_mha_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
