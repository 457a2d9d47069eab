// Tensor-core tile engine of the bf16 attention kernels on Hopper (sm_90a),
// shared by K9 and K10 (`vision_mha_mma_kernel`, `row_mha_mma_kernel` in
// row_mha_fwd.cu) and K11 (`flash_mha_fwd_mma_kernel`,
// `flash_mha_bwd_dkdv_mma_kernel`, `flash_mha_bwd_dq_mma_kernel` in
// flash_mha.cu).
//
// A warp owns 16 rows of the left operand. In the forwards its q rows stay
// in registers for the whole walk as A fragments of `mma.sync.aligned.
// m16n8k16.row.col.f32.bf16.bf16.f32` (one per 16 columns of the head
// width), read once from shared memory with `ldmatrix`; the backward reads
// its A rows (K and V, or Q and dO) from shared memory at every tile
// (`tile_scores_shared`), which leaves its registers to the fp32 gradient
// sums. Tiles stream through shared memory 64 rows at a time, kept in bf16
// (never widened), each row padded by 8 bf16 so that a row is an odd number
// of 16-byte units: the eight rows an `ldmatrix` phase reads then fall in
// eight different 16-byte bank groups, free of bank conflicts. The copies
// are `cp.async` (16, 8 or 4 bytes, by the alignment of the pointers and
// strides) into a ring of two stages, so the next tile's copy runs while
// this tile's products do; a copy whose source lies at or past the row
// count or the head width reads nothing and zero-fills (src-size 0 or a
// part), so a padded key or column holds 0 and never meets a NaN.
//
// Per tile and warp: S = A B^T as 8 fp32 C fragments (16 rows x 8 tile rows
// each), the tile read as the `.col` B operand with `ldmatrix`; the caller
// masks and turns S into weights; pairs of C fragments are then packed into
// bf16 A fragments in registers (P never goes through shared memory) and
// multiplied by a tile read as the B operand through `ldmatrix.trans`
// (`tile_pv`: V in the forwards, dO, Q or K in the backward) into fp32
// fragments of 16 rows x the head width. A row's max and sum take two
// `__shfl_xor_sync` steps within the quad of lanes that holds it.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A holds rows
// g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds k rows 2t,
// 2t + 1 and 2t + 8, 2t + 9 of column g; C holds rows g and g + 8,
// columns 2t and 2t + 1 (c[0], c[1] row g; c[2], c[3] row g + 8).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_mma {

constexpr int kKeyTile = 64;                  // keys of a shared tile
constexpr int kKeyGroups = kKeyTile / 16;     // 16-key steps of a tile
constexpr int kRowPad = 8;                    // bf16 of padding a row
// exp(x) is taken as exp2(x log2(e)): one product and the special function
// unit's exp2, where expf adds a range reduction of its own
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory row stride, in bf16, of a tile of width dhp (a multiple
// of 16): dhp / 8 + 1 16-byte units, an odd number.
__host__ __device__ constexpr int row_stride(int dhp) {
  return dhp + kRowPad;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b on the tensor cores: bf16 products, fp32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kBytes (16, 8 or 4) from global to shared memory, of which the first
// src_bytes are read and the rest zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `kPending` of this thread's groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The largest kVec (8, 4, 2 or 1 bf16 a copy) that `bits` (the OR of every
// byte address and byte stride a kernel reads through) allows.
__host__ __device__ constexpr int vec_for(unsigned long long bits) {
  return bits % 16 == 0 ? 8 : bits % 8 == 0 ? 4 : bits % 4 == 0 ? 2 : 1;
}

// Rows r0 .. r0 + rows - 1 of an (n, dh) bf16 matrix whose rows lie
// `stride` elements apart (the dh elements of a row contiguous) into shared
// rows of DHP bf16 at row stride ld: zero at rows >= n and columns >= dh.
// kVec bf16 a copy: 8, 4 or 2 through cp.async (16, 8 or 4 bytes, waited
// for with cp_async_wait), 1 through plain loads and stores. All threads of
// the block take part.
template <int kVec, int DHP>
__device__ __forceinline__ void copy_rows(uint16_t* dst, int ld,
                                          const uint16_t* src,
                                          long long stride, int r0, int rows,
                                          int n, int dh) {
  constexpr int kChunks = DHP / kVec;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * kVec;
    const int row = r0 + r;
    const int valid = row < n ? max(0, min(kVec, dh - c)) : 0;
    const uint16_t* s = valid ? src + row * stride + c : src;
    uint16_t* d = dst + r * ld + c;
    if constexpr (kVec == 1) {
      *d = valid ? *s : static_cast<uint16_t>(0);
    } else {
      cp_async<2 * kVec>(d, s, 2 * valid);
    }
  }
}

// The warp's q fragments: its 16 rows of DHP columns at `sq`.
template <int DHP>
__device__ __forceinline__ void load_q(uint32_t (&q)[DHP / 16][4],
                                       const uint16_t* sq, int lane) {
  constexpr int ld = row_stride(DHP);
  const uint16_t* p = sq + (lane % 16) * ld + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) ldmatrix_x4(q[kk], p + kk * 16);
}

// s = the warp's scores against the 64 keys of the tile at `sk`, 8 keys a
// fragment; only the first `groups` groups of 16 keys are computed, the
// rest stay 0 (the caller masks them).
template <int DHP>
__device__ __forceinline__ void tile_scores(float (&s)[8][4],
                                            const uint32_t (&q)[DHP / 16][4],
                                            const uint16_t* sk, int groups,
                                            int lane) {
  constexpr int ld = row_stride(DHP);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
  }
  // lanes 0-7 and 8-15 address keys 0-7 at columns +0 and +8 (the two B
  // registers of the first 8 keys), lanes 16-31 keys 8-15 likewise
  const uint16_t* p =
      sk + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int gq = 0; gq < kKeyGroups; ++gq) {
    if (gq < groups) {
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, p + gq * 16 * ld + kk * 16);
        mma(s[2 * gq], q[kk], b[0], b[1]);
        mma(s[2 * gq + 1], q[kk], b[2], b[3]);
      }
    }
  }
}

// s += the scores of the warp's 16 rows at `sa` (shared, DHP columns at
// row stride row_stride(DHP)) against the 64 rows of the tile at `sb`, as
// `tile_scores` with the A fragments read from shared memory one 16-column
// step at a time, so no operand row is held in registers. Head widths
// above 128 are summed this way over 128-column slices. kScaleA: each A
// value multiplied by a_scale and rounded to bf16 first (K9's scaled q).
template <int DHP, bool kScaleA = false>
__device__ __forceinline__ void tile_scores_shared_add(
    float (&s)[8][4], const uint16_t* sa, const uint16_t* sb, int groups,
    int lane, float a_scale = 1.f) {
  constexpr int ld = row_stride(DHP);
  const uint16_t* pa = sa + (lane % 16) * ld + (lane / 16) * 8;
  const uint16_t* pb =
      sb + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, pa + kk * 16);
    if constexpr (kScaleA) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = unpack_bf16(a[e]);
        a[e] = pack_bf16(x.x * a_scale, x.y * a_scale);
      }
    }
#pragma unroll
    for (int gq = 0; gq < kKeyGroups; ++gq) {
      if (gq < groups) {
        uint32_t b[4];
        ldmatrix_x4(b, pb + gq * 16 * ld + kk * 16);
        mma(s[2 * gq], a, b[0], b[1]);
        mma(s[2 * gq + 1], a, b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void zero_tile(float (&s)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
  }
}

// s = the scores of `tile_scores_shared_add` alone.
template <int DHP>
__device__ __forceinline__ void tile_scores_shared(float (&s)[8][4],
                                                   const uint16_t* sa,
                                                   const uint16_t* sb,
                                                   int groups, int lane) {
  zero_tile(s);
  tile_scores_shared_add<DHP>(s, sa, sb, groups, lane);
}

// -inf at keys >= n and, when `causal`, at keys past the row. j0: the
// tile's first key; row: the absolute row of the lane's first fragment row.
__device__ __forceinline__ void mask_tile(float (&s)[8][4], int j0, int n,
                                          int row, bool causal, int lane) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j0 + nb * 8 + 2 * (lane % 4) + (e & 1);
      const int r = row + (e / 2) * 8;
      if (key >= n || (causal && key > r)) s[nb][e] = -INFINITY;
    }
  }
}

// The A fragments of the weights w (fp32 C fragments), rounded to bf16.
__device__ __forceinline__ void pack_weights(uint32_t (&p)[kKeyGroups][4],
                                             const float (&w)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < kKeyGroups; ++ks) {
    p[ks][0] = pack_bf16(w[2 * ks][0], w[2 * ks][1]);
    p[ks][1] = pack_bf16(w[2 * ks][2], w[2 * ks][3]);
    p[ks][2] = pack_bf16(w[2 * ks + 1][0], w[2 * ks + 1][1]);
    p[ks][3] = pack_bf16(w[2 * ks + 1][2], w[2 * ks + 1][3]);
  }
}

// o += p v for the tile's V at `sv`, over its first `groups` groups of 16
// keys.
template <int DHP>
__device__ __forceinline__ void tile_pv(float (&o)[DHP / 8][4],
                                        const uint32_t (&p)[kKeyGroups][4],
                                        const uint16_t* sv, int groups,
                                        int lane) {
  constexpr int ld = row_stride(DHP);
  // lanes 0-7 and 8-15 address keys 0-7 and 8-15 at columns +0 (the two B
  // registers of the first 8 columns), lanes 16-31 the same keys at +8
  const uint16_t* base =
      sv + (((lane / 8) % 2) * 8 + lane % 8) * ld + (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < kKeyGroups; ++ks) {
    if (ks < groups) {
#pragma unroll
      for (int dp = 0; dp < DHP / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, base + ks * 16 * ld + dp * 16);
        mma(o[2 * dp], p[ks], b[0], b[1]);
        mma(o[2 * dp + 1], p[ks], b[2], b[3]);
      }
    }
  }
}

// max and sum over the quad of lanes that holds a row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Scores times f: log2(e) (and the scale, where it multiplies the fp32
// sums) puts them in log2 units, for exp2.
__device__ __forceinline__ void scale_tile(float (&s)[8][4], float f) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] *= f;
  }
}

// The lane's largest score in fragment row `half` (0: row g, 1: g + 8).
__device__ __forceinline__ float row_max(const float (&s)[8][4], int half) {
  float m = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    m = fmaxf(m, fmaxf(s[nb][2 * half], s[nb][2 * half + 1]));
  }
  return m;
}

}  // namespace attn_mma
