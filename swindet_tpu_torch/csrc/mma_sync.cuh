// Warp-level tensor-core building blocks in PTX, shared by the window
// attention's tensor-core kernels (window_attention.cu) and the v4
// attention's (window_attention_v4.cu): cp.async copies into shared
// memory, ldmatrix fragment loads and mma.sync m16n8k16 (bf16 in, fp32
// accumulation), with the row addresses of the fragments of a row-major
// tile.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace swindet {

// A window's tokens padded to one 64-row tile, four 16-row warp tiles;
// the logits of a row span kTcKeyTiles n8 tiles.
constexpr int kTcRows = 64;
constexpr int kTcKeyTiles = kTcRows / 8;
constexpr int kTcPitchP = kTcRows + 8;  // bf16 row pitch of P and dS

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes, or 16 zero bytes where !valid (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8 x 8 bf16 matrices: lanes 8m .. 8m + 7 give the row addresses of
// matrix m, and register m of a lane holds its elements (lane / 4,
// 2 (lane % 4) + {0, 1}), or with .trans (2 (lane % 4) + {0, 1}, lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row-major fragment) b (16 x 8)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to nearest even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A lane's ldmatrix row address in a row-major tile `base` of row pitch
// `pitch` elements:
// - for the A operand (16 x 16) at rows m0 .., columns k0 .. (ldsm_x4);
__device__ __forceinline__ const __nv_bfloat16* frag_a(
    const __nv_bfloat16* base, int pitch, int m0, int k0, int lane) {
  return base + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + k0 +
         (lane >> 4) * 8;
}
// - for the A operand at rows m0 .., columns k0 .. of the transpose of a
//   tile stored [k][m] (ldsm_x4_t);
__device__ __forceinline__ const __nv_bfloat16* frag_a_t(
    const __nv_bfloat16* base, int pitch, int m0, int k0, int lane) {
  return base + (k0 + (lane & 7) + (lane >> 4) * 8) * pitch + m0 +
         ((lane >> 3) & 1) * 8;
}
// - for the B operands of two n8 tiles (n0 .., n0 + 8 ..) by k16 from a
//   tile stored [n][k] (ldsm_x4: registers 0-1 the first tile's, 2-3 the
//   second's);
__device__ __forceinline__ const __nv_bfloat16* frag_b_nk(
    const __nv_bfloat16* base, int pitch, int n0, int k0, int lane) {
  return base + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 +
         ((lane >> 3) & 1) * 8;
}
// - the same from a tile stored [k][n] (ldsm_x4_t).
__device__ __forceinline__ const __nv_bfloat16* frag_b_kn(
    const __nv_bfloat16* base, int pitch, int k0, int n0, int lane) {
  return base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 +
         (lane >> 4) * 8;
}

// The A fragment of k step kk (columns 16 kk ..) of a 16 x 64 fp32
// accumulator, rounded to bf16: the accumulator layout of n8 tiles 2 kk
// and 2 kk + 1 is the A operand's.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&s)[kTcKeyTiles][4],
                                         int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// Store a warp's 16 x HD fp32 accumulator, times mul and rounded to bf16,
// to rows row0 .. (those below n), row i at row_at(i): through the warp's
// own staging tile st (16 rows of HD + 8), so that every global store is
// 16 bytes.
template <int HD, typename RowAt>
__device__ __forceinline__ void store_tile(const float (&acc)[HD / 8][4],
                                           float mul, __nv_bfloat16* st,
                                           RowAt row_at, int row0, int n,
                                           int lane) {
  constexpr int P = HD + 8, CH = HD / 8;
  const int gq = lane >> 2, t = lane & 3;
  __syncwarp();  // the lanes' earlier reads of st are done
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(st + gq * P + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
    *reinterpret_cast<uint32_t*>(st + (gq + 8) * P + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, d = (e % CH) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(row_at(row0 + r) + d) =
          *reinterpret_cast<const uint4*>(st + r * P + d);
  }
}

// The same with row i at dst + i stride.
template <int HD>
__device__ __forceinline__ void store_tile(const float (&acc)[HD / 8][4],
                                           float mul, __nv_bfloat16* st,
                                           __nv_bfloat16* dst, size_t stride,
                                           int row0, int n, int lane) {
  store_tile<HD>(
      acc, mul, st, [=](int i) { return dst + (size_t)i * stride; }, row0,
      n, lane);
}

// The attention backward of one window and head for this warp's 16 rows
// m0 .. (rows 7 of csrc/window_attention.cu and 13 of
// csrc/window_attention_v4.cu): from the fp32 P in registers (pf, zero
// outside N x N) and the head's bf16 q, k, v and output-gradient tiles
// (rows of HD + 8; g_s the gradient of the attention output), dP = g V^T,
// dS = P (dP - rowsum(dP P)) in fp32, summed into db, and P and dS rounded
// to bf16 into this warp's rows of sp and sds (64 x kTcPitchP each); then
// dQ = scale dS K and, after a block barrier (every warp's rows of P and
// dS are in), dV = P^T g and dK = scale dS^T Q, each rounded to bf16 into
// rows m0 .. (those below n) of d_win (dq), d_win + c (dk) and
// d_win + 2 c (dv), 3 c apart, through the warp's staging tile st.
template <int HD>
__device__ __forceinline__ void attention_bwd_tile(
    const float (&pf)[kTcKeyTiles][4], const __nv_bfloat16* q_s,
    const __nv_bfloat16* k_s, const __nv_bfloat16* v_s,
    const __nv_bfloat16* g_s, __nv_bfloat16* sp, __nv_bfloat16* sds,
    __nv_bfloat16* st, __nv_bfloat16* d_win, int c,
    float (&db)[kTcKeyTiles][4], int n, float scale, int m0, int lane) {
  constexpr int P = HD + 8;
  const int gq = lane >> 2, t = lane & 3;
  // dP = g V^T
  float ds[kTcKeyTiles][4] = {};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, frag_a(g_s, P, m0, 16 * kk, lane));
#pragma unroll
    for (int jj = 0; jj < kTcKeyTiles / 2; ++jj) {
      uint32_t bv[4];
      ldsm_x4(bv, frag_b_nk(v_s, P, 16 * jj, 16 * kk, lane));
      mma_bf16(ds[2 * jj], a, bv[0], bv[1]);
      mma_bf16(ds[2 * jj + 1], a, bv[2], bv[3]);
    }
  }
  // dS = P (dP - rowsum(dP P)) in fp32, summed into dBias; P and dS
  // rounded to bf16 into this warp's rows of shared memory
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dot[e >> 1] += ds[nt][e] * pf[nt][e];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
    dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
  }
#pragma unroll
  for (int nt = 0; nt < kTcKeyTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ds[nt][e] = pf[nt][e] * (ds[nt][e] - dot[e >> 1]);
      db[nt][e] += ds[nt][e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = (m0 + gq + 8 * r) * kTcPitchP + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(sp + at) =
          pack_bf16(pf[nt][2 * r], pf[nt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(sds + at) =
          pack_bf16(ds[nt][2 * r], ds[nt][2 * r + 1]);
    }
  }

  // dQ = scale dS K, with dS repacked as the A operand
  {
    float acc[HD / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, ds, kk);
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t bk[4];
        ldsm_x4_t(bk, frag_b_kn(k_s, P, 16 * kk, 16 * dd, lane));
        mma_bf16(acc[2 * dd], a, bk[0], bk[1]);
        mma_bf16(acc[2 * dd + 1], a, bk[2], bk[3]);
      }
    }
    store_tile<HD>(acc, scale, st, d_win, 3 * (size_t)c, m0, n, lane);
  }
  __syncthreads();  // every row of P and dS is in shared memory

  // dV = P^T g and dK = scale dS^T Q for key rows m0 ..
  {
    float acc[HD / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, frag_a_t(sp, kTcPitchP, m0, 16 * kk, lane));
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t bg[4];
        ldsm_x4_t(bg, frag_b_kn(g_s, P, 16 * kk, 16 * dd, lane));
        mma_bf16(acc[2 * dd], a, bg[0], bg[1]);
        mma_bf16(acc[2 * dd + 1], a, bg[2], bg[3]);
      }
    }
    store_tile<HD>(acc, 1.f, st, d_win + 2 * c, 3 * (size_t)c, m0, n,
                   lane);
  }
  {
    float acc[HD / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, frag_a_t(sds, kTcPitchP, m0, 16 * kk, lane));
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t bq[4];
        ldsm_x4_t(bq, frag_b_kn(q_s, P, 16 * kk, 16 * dd, lane));
        mma_bf16(acc[2 * dd], a, bq[0], bq[1]);
        mma_bf16(acc[2 * dd + 1], a, bq[2], bq[3]);
      }
    }
    store_tile<HD>(acc, scale, st, d_win + c, 3 * (size_t)c, m0, n, lane);
  }
}

// the tensor-core kernels' head widths
template <typename F>
inline int by_head_dim(int hd, F&& launch) {
  switch (hd) {
    case 16: return launch(std::integral_constant<int, 16>());
    case 32: return launch(std::integral_constant<int, 32>());
    case 48: return launch(std::integral_constant<int, 48>());
    case 64: return launch(std::integral_constant<int, 64>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace swindet
