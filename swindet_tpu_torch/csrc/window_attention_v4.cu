// Swin window attention with both projections folded in (the v4
// configuration, SWINDET_WATTN_V4=1):
//   out = proj(window_attention(x Wqkv^T + bqkv)) + bproj
// over (B_, N, C) window tokens, and its backward.
//
// Replaces: swindet_tpu/ops/window_attention_v4.py · _wattn4_kernel (:74,
// via _wattn4_fwd_impl, pallas_call at :118) and · _wattn4_bwd_kernel
// (:141, via _wattn4_bwd_impl, pallas_call at :238), run by every Swin
// block when SWINDET_WATTN_V4=1 (models/backbones/swin.py:243).
//
// Inputs as on the TPU: x in the compute type, Wqkv (3C, C), bqkv, Wproj
// (C, C), bproj (nn.Linear layout), the relative-position bias (nH, N, N)
// and the shift mask (nW, N, N; window w reads mask[w mod nW]) in fp32.
//
// Bound: operations. Per window the two projections cost 8 N C^2 flops
// (4.7 MFLOP at stage 1, C = 96; 231 MFLOP at stage 4, C = 768) on 2 N C
// elements in and out, 100 to 800 flops per byte, and the attention
// 4 N^2 C more; the backward about 2.75 times the forward. The TPU kept
// both weight matrices and a block of windows in VMEM; Wqkv alone is 3.5
// MB in bf16 at stage 4, far over a block's 227 KB, and at stage 4 a
// request has 24 windows for 132 SMs.
//
// bf16 with N <= 64 and hd in {16, 32, 48, 64} (every Swin-T/S/B stage):
// tensor cores, mma.sync m16n8k16 (bf16 in, fp32 accumulation) on
// ldmatrix fragments (csrc/mma_sync.cuh), a window's tokens padded to one
// 64-row tile, four warps of one 16-row tile each. The weights are rounded
// to bf16 once a call (wattn4_cast_kernel, also writing the transposes
// the backward's products read); q, k, v, P, the attention output,
// d(attn), dS and dqkv are rounded to bf16 where they feed a product, the
// softmax and every sum stay fp32 (ops/window_attention_v4.py
// window_attention_v4_bwd_reference with tc_rounding computes the same).
// Every projection is a 64-row product streamed through a cp.async
// pipeline in 32-column chunks (gemm_stream): the window's x or g rows
// and the weight rows of the block's columns; the head's bias plus the
// window's mask is staged in shared memory once per head and window.
//   wattn4_fwd_tc_kernel (row 12): a thread-block cluster of 1-8 blocks
//   per window (ops/window_attention_v4.py fwd_geometry: one block a
//   window while the windows fill the card, the window split by heads
//   where they do not, 8 blocks at stage 4), each block a run of heads:
//   per head q, k, v (one product of 3 hd columns), P in registers and
//   round(P) v into the block's columns of the 64 x C attention output,
//   a tile in its shared memory. After a cluster barrier each rank writes
//   its columns of ao Wproj^T + bproj, its projection's A operand copied
//   chunk by chunk from the ranks' tiles through distributed shared
//   memory, so a block holds only its own columns (three blocks an SM at
//   every Swin-T stage): nothing between the projections leaves the chip,
//   no atomics, deterministic.
//   Row 13 keeps the four-kernel split below, on tensor cores:
//   wattn4_bwd_heads_tc_kernel (per head and group of windows, geometry
//   as row 7's) recomputes q, k, v and P, forms d(attn)_h = g Wproj[:, h]
//   (from Wproj^T's rows), writes o_h and dq, dk, dv to bf16 scratch (the
//   device-memory round trip the TPU avoided, half the bytes of the SIMT
//   kernels' fp32), and sums dS into dBias (one atomic per entry a
//   block); wattn4_bwd_dx_tc_kernel forms dx = dqkv Wqkv in 64 x 96 (or
//   64) tiles, the column tiles of a row tile side by side so dqkv is read
//   once; wattn4_bwd_dw_tc_kernel forms dWqkv = dqkv^T x and dWproj = g^T
//   ao (with dbqkv and dbproj) in 64 x 64 tiles over splits of the rows
//   (dw_split_rows), on wgmma (csrc/sm90.cuh) from 64-row chunks that
//   cp.async lays out as TMA's 128-byte swizzle would, one fp32 atomic per
//   entry per split.
//
// fp32 and other shapes: the SIMT kernels, kept as first written. Forward
// (wattn4_fwd_kernel): one block per window loops over the heads. For head
// h it forms that head's q, k, v (N x 3hd) from x and the matching Wqkv
// rows, both streamed from device memory (L2 after the first window), into
// shared memory; the logits, softmax and P v run from there as in
// csrc/window_attention.cu, and the head's output lands in an N x C fp32
// buffer in shared memory. Once every head is done the block multiplies
// that buffer by Wproj (streamed) and writes the rounded output; qkv, the
// logits, P and the attention output are fp32 and stay on chip. Shared
// memory is 4 (N C + 3 N (hd + 1) + max(N (N + 1), 2080)) bytes: 225 KB at
// N = 49, C = 1,024, hd = 32; the wrapper refuses shapes over the 227 KB.
// The products run on the CUDA cores (SIMT fp32 FMA, csrc/tile_gemm.cuh).
//
// SIMT backward: the TPU recomputed qkv and P per window block and summed
// dWqkv, dbqkv, dWproj, dbproj and dBias across its sequential grid in
// VMEM. Here blocks run in no order and a window's weight-gradient partials
// (4 C^2 floats: 9 MB at stage 4) do not fit on chip, so the backward is
// four kernels:
//  1. wattn4_bwd_heads_kernel, one block per head and group of kBwdGroup
//     windows: recomputes the head's q, k, v, P and output o_h, forms
//     d(attn)_h = g Wproj[:, head], and runs the attention backward
//     (dV = P^T d, dP = d V^T, dS = P (dP - rowsum(dP P)), dQ = scale dS K,
//     dK = dS^T (scale Q)), all in fp32 in shared memory. It writes o_h
//     and dQ, dK, dV to two fp32 scratch tensors (B_, N, C) and (B_, N, 3C)
//     and sums dS over its windows in shared memory, adding that to dBias
//     with one atomic per entry per group.
//  2. wattn4_bwd_dx_kernel: dx = dqkv Wqkv per 64-row tile, no atomics:
//     deterministic, rounded once to x's type.
//  3. wattn4_bwd_dw_kernel, twice: dWqkv = dqkv^T x with dbqkv, and
//     dWproj = g^T o with dbproj. Each block sums a 64 x 32 tile over one
//     split of the rows in registers and adds it with one fp32 atomic per
//     entry per split (the host picks splits for about two blocks per SM),
//     not one per entry per window.
// In both the atomics' order varies, so the weight gradients and dBias
// vary in their last bits.
#include <cooperative_groups.h>

#include <algorithm>

#include "mma_sync.cuh"
#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace swindet {

constexpr int kV4Threads = kGemmThreads;
constexpr int kBwdGroup = 8;  // windows per block of the backward's heads
using Tile = Micro<64, 32, 4, 2>;

// Head h's q (times scale), k and v of one window, fp32, into
// qkv_s[(p * n + i) * (hd + 1) + d] for p = 0, 1, 2:
//   sum_k x[i][k] Wqkv[p C + h hd + d][k] + bqkv[p C + h hd + d].
template <typename T>
__device__ void head_qkv(const T* __restrict__ xw,
                         const float* __restrict__ wqkv,
                         const float* __restrict__ bqkv, int n, int c,
                         int hd, int h, float scale, float* qkv_s, float* As,
                         float* Bs) {
  const Tile mt;
  const int cols = 3 * hd, ld = hd + 1;
  for (int n0 = 0; n0 < cols; n0 += 32) {
    float acc[4][2] = {};
    tile_gemm<64, 32, 4, 2, false, false>(
        acc, c,
        [&](int m, int k) {
          return m < n ? to_f32(xw[(size_t)m * c + k]) : 0.f;
        },
        [&](int j, int k) {
          const int col = n0 + j;
          if (col >= cols) return 0.f;
          const int row = (col / hd) * c + h * hd + col % hd;
          return wqkv[(size_t)row * c + k];
        },
        As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = mt.tm + i, col = n0 + mt.tn + j;
        if (m < n && col < cols) {
          const int p = col / hd, d = col % hd;
          const float v = acc[i][j] + bqkv[p * c + h * hd + d];
          qkv_s[(p * n + m) * ld + d] = p == 0 ? v * scale : v;
        }
      }
  }
}

// P = softmax(q k^T + bias_h + mask_w) by rows, fp32, into p_s (rows of
// n + 1). q is already scaled; mask_w may be null. Ends synchronised.
__device__ void head_softmax(const float* q, const float* k,
                             const float* __restrict__ bias_h,
                             const float* __restrict__ mask_w, int n, int hd,
                             float* p_s) {
  const int ld = hd + 1, lds = n + 1, tid = threadIdx.x;
  for (int idx = tid; idx < n * n; idx += kV4Threads) {
    const int i = idx / n, j = idx % n;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc += q[i * ld + d] * k[j * ld + d];
    acc += bias_h[idx];
    if (mask_w) acc += mask_w[idx];
    p_s[i * lds + j] = acc;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < n; i += kV4Threads / 32) {
    float* row = p_s + i * lds;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] *= inv;
  }
  __syncthreads();
}

// ----------------------------------------------------------------- forward
// One block per window. Dynamic shared memory (floats): the attention
// output (n x c), q, k, v (3 x n x (hd + 1)), and one region for the logits
// (n x (n + 1)) that the products' staging tiles (2 kStage) reuse.
template <typename T>
__global__ void __launch_bounds__(kV4Threads)
wattn4_fwd_kernel(const T* __restrict__ x, const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv,
                  const float* __restrict__ bias,
                  const float* __restrict__ mask,
                  const float* __restrict__ wproj,
                  const float* __restrict__ bproj, T* __restrict__ out, int n,
                  int c, int nh, int nw, float scale) {
  extern __shared__ float smem[];
  const int hd = c / nh, ld = hd + 1, lds = n + 1;
  float* ao = smem;
  float* qkv_s = ao + n * c;
  float* p_s = qkv_s + 3 * n * ld;
  float* As = p_s;
  float* Bs = p_s + kStage;
  const int win = blockIdx.x, tid = threadIdx.x;
  const T* xw = x + (size_t)win * n * c;
  const float* mask_w = mask ? mask + (size_t)(win % nw) * n * n : nullptr;
  const float* v = qkv_s + 2 * n * ld;
  for (int h = 0; h < nh; ++h) {
    head_qkv<T>(xw, wqkv, bqkv, n, c, hd, h, scale, qkv_s, As, Bs);
    __syncthreads();
    head_softmax(qkv_s, qkv_s + n * ld, bias + (size_t)h * n * n, mask_w, n,
                 hd, p_s);
    for (int idx = tid; idx < n * hd; idx += kV4Threads) {
      const int i = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc += p_s[i * lds + j] * v[j * ld + d];
      ao[i * c + h * hd + d] = acc;
    }
    __syncthreads();  // p_s holds the next head's staging tiles
  }
  const Tile mt;
  T* ow = out + (size_t)win * n * c;
  for (int o0 = 0; o0 < c; o0 += 32) {
    float acc[4][2] = {};
    tile_gemm<64, 32, 4, 2, false, false>(
        acc, c, [&](int m, int k) { return m < n ? ao[m * c + k] : 0.f; },
        [&](int j, int k) {
          return o0 + j < c ? wproj[(size_t)(o0 + j) * c + k] : 0.f;
        },
        As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = mt.tm + i, o = o0 + mt.tn + j;
        if (m < n && o < c)
          ow[(size_t)m * c + o] = from_f32<T>(acc[i][j] + bproj[o]);
      }
  }
}

// ---------------------------------------------------------------- backward
// Block (group of kBwdGroup windows, head h). Dynamic shared memory
// (floats): q, k, v, d(attn)_h (4 x n x (hd + 1)), P (n x (n + 1)), dP / dS
// (n x (n + 1), also the staging tiles of the two products), the group's
// sum of dS (n x n). Writes o_h into ao (B_, N, C) and dq, dk, dv into
// dqkv (B_, N, 3C), both fp32; adds the group's dS sum into dbias[h].
template <typename T>
__global__ void __launch_bounds__(kV4Threads)
wattn4_bwd_heads_kernel(const T* __restrict__ x,
                        const float* __restrict__ wqkv,
                        const float* __restrict__ bqkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        const float* __restrict__ wproj,
                        const T* __restrict__ g, float* __restrict__ ao,
                        float* __restrict__ dqkv, float* __restrict__ dbias,
                        int b_, int n, int c, int nh, int nw, float scale) {
  extern __shared__ float smem[];
  const int hd = c / nh, ld = hd + 1, lds = n + 1, c3 = 3 * c;
  float* qkv_s = smem;
  float* q = qkv_s;
  float* k = q + n * ld;
  float* v = k + n * ld;
  float* da = v + n * ld;
  float* p_s = da + n * ld;
  float* ds = p_s + n * lds;
  float* db = ds + max(n * lds, 2 * kStage);
  float* As = ds;
  float* Bs = ds + kStage;
  const int h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const Tile mt;
  for (int idx = tid; idx < n * n; idx += kV4Threads) db[idx] = 0.f;

  const int w_end = min((int)(blockIdx.x + 1) * kBwdGroup, b_);
  for (int win = blockIdx.x * kBwdGroup; win < w_end; ++win) {
    const T* xw = x + (size_t)win * n * c;
    const T* gw = g + (size_t)win * n * c;
    head_qkv<T>(xw, wqkv, bqkv, n, c, hd, h, scale, qkv_s, As, Bs);
    __syncthreads();
    head_softmax(q, k, bias + (size_t)h * n * n,
                 mask ? mask + (size_t)(win % nw) * n * n : nullptr, n, hd,
                 p_s);
    // o_h = P v, for dWproj
    float* ao_w = ao + (size_t)win * n * c + h * hd;
    for (int idx = tid; idx < n * hd; idx += kV4Threads) {
      const int i = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc += p_s[i * lds + j] * v[j * ld + d];
      ao_w[(size_t)i * c + d] = acc;
    }
    // d(attn)_h[i][d] = sum_o g[i][o] Wproj[o][h hd + d]
    for (int d0 = 0; d0 < hd; d0 += 32) {
      float acc[4][2] = {};
      tile_gemm<64, 32, 4, 2, false, true>(
          acc, c,
          [&](int m, int o) {
            return m < n ? to_f32(gw[(size_t)m * c + o]) : 0.f;
          },
          [&](int j, int o) {
            return d0 + j < hd ? wproj[(size_t)o * c + h * hd + d0 + j] : 0.f;
          },
          As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = mt.tm + i, d = d0 + mt.tn + j;
          if (m < n && d < hd) da[m * ld + d] = acc[i][j];
        }
    }
    __syncthreads();

    float* dq_w = dqkv + (size_t)win * n * c3 + h * hd;
    // dV[j][d] = sum_i P[i][j] da[i][d]
    for (int idx = tid; idx < n * hd; idx += kV4Threads) {
      const int j = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc += p_s[i * lds + j] * da[i * ld + d];
      dq_w[(size_t)j * c3 + 2 * c + d] = acc;
    }
    // dP[i][j] = sum_d da[i][d] v[j][d]
    for (int idx = tid; idx < n * n; idx += kV4Threads) {
      const int i = idx / n, j = idx % n;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc += da[i * ld + d] * v[j * ld + d];
      ds[i * lds + j] = acc;
    }
    __syncthreads();
    // dS = P (dP - rowsum(dP P)), one warp per row
    for (int i = warp; i < n; i += kV4Threads / 32) {
      const float* pr = p_s + i * lds;
      float* dr = ds + i * lds;
      float dot = 0.f;
      for (int j = lane; j < n; j += 32) dot += dr[j] * pr[j];
      dot = warp_sum(dot);
      for (int j = lane; j < n; j += 32) {
        const float dsv = pr[j] * (dr[j] - dot);
        dr[j] = dsv;
        db[i * n + j] += dsv;
      }
    }
    __syncthreads();
    // dQ = scale dS K; dK = dS^T (scale Q)
    for (int idx = tid; idx < n * hd; idx += kV4Threads) {
      const int i = idx / hd, d = idx % hd;
      float acc_q = 0.f, acc_k = 0.f;
      for (int j = 0; j < n; ++j) {
        acc_q += ds[i * lds + j] * k[j * ld + d];
        acc_k += ds[j * lds + i] * q[j * ld + d];
      }
      dq_w[(size_t)i * c3 + d] = acc_q * scale;
      dq_w[(size_t)i * c3 + c + d] = acc_k;
    }
    __syncthreads();  // the next window overwrites shared memory
  }
  float* dbias_h = dbias + (size_t)h * n * n;
  for (int idx = tid; idx < n * n; idx += kV4Threads)
    atomicAdd(dbias_h + idx, db[idx]);
}

// dx[r][cc] = sum_p dqkv[r][p] Wqkv[p][cc] for a 64-row x 32-column tile.
template <typename T>
__global__ void __launch_bounds__(kV4Threads)
wattn4_bwd_dx_kernel(const float* __restrict__ dqkv,
                     const float* __restrict__ wqkv, T* __restrict__ dx,
                     int64_t rows, int c) {
  __shared__ float As[kStage], Bs[kStage];
  const int64_t r0 = (int64_t)blockIdx.x * 64;
  const int c0 = blockIdx.y * 32, c3 = 3 * c;
  const Tile mt;
  float acc[4][2] = {};
  tile_gemm<64, 32, 4, 2, false, true>(
      acc, c3,
      [&](int m, int p) {
        return r0 + m < rows ? dqkv[(r0 + m) * c3 + p] : 0.f;
      },
      [&](int j, int p) {
        return c0 + j < c ? wqkv[(size_t)p * c + c0 + j] : 0.f;
      },
      As, Bs);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t r = r0 + mt.tm + i;
      const int cc = c0 + mt.tn + j;
      if (r < rows && cc < c) dx[r * c + cc] = from_f32<T>(acc[i][j]);
    }
}

// out[m][k] += sum_r a[r][m] b[r][k] over this block's split of the rows,
// for a 64 x 32 tile (blockIdx.x, blockIdx.y) of the (M, K) output; blocks
// of the first column of tiles also add sum_r a[r][m] into db. a (rows, M)
// and b (rows, K) are row-major.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kV4Threads)
wattn4_bwd_dw_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                     float* __restrict__ out, float* __restrict__ db,
                     int64_t rows, int M, int K, int64_t rows_per_split) {
  __shared__ float As[kStage], Bs[kStage];
  const int m0 = blockIdx.x * 64, k0 = blockIdx.y * 32;
  const int64_t r_begin = (int64_t)blockIdx.z * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < rows ? r_begin + rows_per_split : rows;
  const int nr = (int)(r_end - r_begin);
  const Tile mt;
  float acc[4][2] = {};
  tile_gemm<64, 32, 4, 2, true, true>(
      acc, nr,
      [&](int m, int r) {
        return m0 + m < M ? to_f32(a[(r_begin + r) * M + m0 + m]) : 0.f;
      },
      [&](int j, int r) {
        return k0 + j < K ? to_f32(b[(r_begin + r) * K + k0 + j]) : 0.f;
      },
      As, Bs);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + mt.tm + i, kk = k0 + mt.tn + j;
      if (m < M && kk < K) atomicAdd(out + (size_t)m * K + kk, acc[i][j]);
    }
  const int t = threadIdx.x;
  if (blockIdx.y == 0 && t < 64 && m0 + t < M) {
    float s = 0.f;
    for (int64_t r = r_begin; r < r_end; ++r) s += to_f32(a[r * M + m0 + t]);
    atomicAdd(db + m0 + t, s);
  }
}

inline size_t fwd_smem(int n, int c, int nh) {
  const int hd = c / nh;
  return sizeof(float) * ((size_t)n * c + 3 * n * (hd + 1) +
                          std::max(n * (n + 1), 2 * kStage));
}

inline size_t bwd_smem(int n, int c, int nh) {
  const int hd = c / nh;
  return sizeof(float) * ((size_t)4 * n * (hd + 1) + n * (n + 1) +
                          std::max(n * (n + 1), 2 * kStage) + n * n);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// out (M, K) += a^T b over `rows`, db (M) += column sums of a.
template <typename TA, typename TB>
cudaError_t launch_dw(const TA* a, const TB* b, float* out, float* db,
                      int64_t rows, int M, int K, cudaStream_t stream) {
  const int tiles = ((M + 63) / 64) * ((K + 31) / 32);
  const int64_t max_splits = (rows + 63) / 64;
  const int64_t splits =
      std::max<int64_t>(1, std::min<int64_t>(max_splits,
                                             (2 * sm_count() + tiles - 1) /
                                                 tiles));
  const int64_t per = (rows + splits - 1) / splits;
  const int64_t used = (rows + per - 1) / per;
  dim3 grid((M + 63) / 64, (K + 31) / 32, (unsigned)used);
  wattn4_bwd_dw_kernel<TA, TB><<<grid, kV4Threads, 0, stream>>>(
      a, b, out, db, rows, M, K, per);
  return cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const float* wqkv, const float* bqkv,
               const float* bias, const float* mask, const float* wproj,
               const float* bproj, void* out, int b_, int n, int c, int nh,
               int nw, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem(n, c, nh);
  cudaError_t err = allow_smem(wattn4_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  wattn4_fwd_kernel<T><<<b_, kV4Threads, smem, stream>>>(
      (const T*)x, wqkv, bqkv, bias, mask, wproj, bproj, (T*)out, n, c, nh,
      nw, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const float* wqkv, const float* bqkv,
               const float* bias, const float* mask, const float* wproj,
               const void* g, float* ao, float* dqkv, void* dx, float* dwqkv,
               float* dbqkv, float* dbias, float* dwproj, float* dbproj,
               int b_, int n, int c, int nh, int nw, float scale,
               cudaStream_t stream) {
  const size_t smem = bwd_smem(n, c, nh);
  cudaError_t err = allow_smem(wattn4_bwd_heads_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((b_ + kBwdGroup - 1) / kBwdGroup, nh);
  wattn4_bwd_heads_kernel<T><<<grid, kV4Threads, smem, stream>>>(
      (const T*)x, wqkv, bqkv, bias, mask, wproj, (const T*)g, ao, dqkv,
      dbias, b_, n, c, nh, nw, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t rows = (int64_t)b_ * n;
  dim3 dx_grid((unsigned)((rows + 63) / 64), (c + 31) / 32);
  wattn4_bwd_dx_kernel<T><<<dx_grid, kV4Threads, 0, stream>>>(
      dqkv, wqkv, (T*)dx, rows, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_dw(dqkv, (const T*)x, dwqkv, dbqkv, rows, 3 * c, c,
                       stream)) != cudaSuccess)
    return err;
  return launch_dw((const T*)g, (const float*)ao, dwproj, dbproj, rows, c, c,
                   stream);
}


// ------------------------------------------------- bf16 tensor-core kernels
// mma.sync m16n8k16 (bf16 in, fp32 accumulation) on ldmatrix fragments
// (csrc/mma_sync.cuh); a window's N <= 64 tokens padded to one 64-row
// tile, four warps of one 16-row tile each; hd in {16, 32, 48, 64}. The
// weight gradients run on wgmma (csrc/sm90.cuh), whose accumulator layout
// is mma.sync's: n8 tile nt of a warp's 16 rows is acc[nt][0..3].

constexpr int kTcThreads = 128;
constexpr int kKc = 32;         // k columns a pipeline stage
constexpr int kKp = kKc + 8;    // bf16 row pitch of a staged chunk
constexpr int kPipe = 2;        // stages of gemm_stream's pipeline
constexpr int kDwPipe = 3;      // and of the weight gradients'
constexpr int kProjCols = 64;   // output columns a projection pass
constexpr int kDwTile = 64;     // the weight gradients' output tile
constexpr int kRowBytes = 128;  // a dW operand row: 64 bf16, swizzled
constexpr int kBoxBytes = kTcRows * kRowBytes;  // a 64-row dW operand box
// blocks an SM the registers of the forward and heads kernels allow: three
// up to hd 32 (168 registers, no spills), where shared memory fits three
// at stages 1-3; two above
__host__ __device__ constexpr int min_blocks(int hd) {
  return hd <= 32 ? 3 : 2;
}

__host__ __device__ constexpr int ceil32(int v) { return (v + 31) / 32 * 32; }

// byte offset of 16-byte chunk c (0-7) of row r in 128-byte-swizzled rows,
// as TMA's 128-byte swizzle lays a box out (1024-byte period)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// wgmma descriptor of k16 step k of an MN-major swizzled box (K down the
// rows, 16 rows a step; 64-wide blocks of M or N kBoxBytes apart)
__device__ __forceinline__ uint64_t mnmajor(uint32_t box, int k) {
  return sm90::gmma_desc(box + 16 * kRowBytes * k, kBoxBytes, 1024);
}

// floats of the add_s region: n x n, at least the backward's four 16-row
// staging tiles of hd + 8 bf16 values that reuse it, a multiple of 4 (16
// bytes)
__host__ __device__ constexpr int add_floats(int n, int hd) {
  return ((n * n > 32 * (hd + 8) ? n * n : 32 * (hd + 8)) + 3) / 4 * 4;
}

// Where gemm_stream finds A: rows of a global matrix, streamed with B; a
// resident shared tile; or the cluster's shared tiles, one block of
// columns on each rank, copied chunk by chunk into the stage.
enum AFrom { kAGlobal, kAShared, kACluster };

// acc[NT][4] += A B^T for this warp's 16 rows m0 = 16 warp .. of a 64-row
// A and NT * 8 rows of B, over K columns (a multiple of 8). B's row j is
// b + ((j / b_group) * b_gstride + j % b_group) * ldb; rows j >= b_rows
// read as zero. B (and A but from kAShared) streams through `stage` in
// kKc-column chunks, kPipe deep. kAGlobal: A's row i is a + i * lda, rows
// i >= a_rows zero. kAShared: `a` is a shared tile of row pitch lda, its
// columns up to ceil32(K) readable and zero past K. kACluster: rank r of
// the cluster holds columns r a_rows .. of A at `a` in its own shared
// memory (row pitch lda). Every thread of the block calls it; it ends with
// the stage free.
template <int NT, AFrom A_FROM>
__device__ void gemm_stream(float (&acc)[NT][4],
                            const __nv_bfloat16* __restrict__ a, size_t lda,
                            int a_rows, const __nv_bfloat16* __restrict__ b,
                            size_t ldb, int b_group, size_t b_gstride,
                            int b_rows, int K, __nv_bfloat16* stage) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
  constexpr bool kAStream = A_FROM != kAShared;
  constexpr int A_ELEMS = kAStream ? kTcRows * kKp : 0;
  constexpr int BUF = A_ELEMS + NT * 8 * kKp;
  const int tid = threadIdx.x, lane = tid & 31, m0 = 16 * (tid >> 5);
  const int chunks = (K + kKc - 1) / kKc;
  auto load = [&](int ck) {
    if (ck < chunks) {
      __nv_bfloat16* buf = stage + (ck % kPipe) * BUF;
      const int k0 = ck * kKc;
      if constexpr (A_FROM == kAGlobal) {
        for (int e = tid; e < kTcRows * (kKc / 8); e += kTcThreads) {
          const int i = e / (kKc / 8), q = k0 + (e % (kKc / 8)) * 8;
          const bool ok = i < a_rows && q < K;
          cp_async16_zfill(buf + i * kKp + q - k0,
                           ok ? a + i * lda + q : a, ok);
        }
      } else if constexpr (A_FROM == kACluster) {
        // both 16-byte pieces of a thread are read before either is stored
        constexpr int kPer = kTcRows * (kKc / 8) / kTcThreads;
        cg::cluster_group cl = cg::this_cluster();
        uint4 v[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int e = tid + u * kTcThreads;
          const int i = e / (kKc / 8), q = k0 + (e % (kKc / 8)) * 8;
          const int rank = q / a_rows;
          v[u] = make_uint4(0, 0, 0, 0);
          if (q < K)
            v[u] = *reinterpret_cast<const uint4*>(
                cl.map_shared_rank(const_cast<__nv_bfloat16*>(a), rank) +
                i * lda + q - rank * a_rows);
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int e = tid + u * kTcThreads;
          *reinterpret_cast<uint4*>(buf + (e / (kKc / 8)) * kKp +
                                    (e % (kKc / 8)) * 8) = v[u];
        }
      }
      __nv_bfloat16* bb = buf + A_ELEMS;
      for (int e = tid; e < NT * 8 * (kKc / 8); e += kTcThreads) {
        const int j = e / (kKc / 8), q = k0 + (e % (kKc / 8)) * 8;
        const bool ok = j < b_rows && q < K;
        const __nv_bfloat16* row =
            b + ((size_t)(j / b_group) * b_gstride + j % b_group) * ldb;
        cp_async16_zfill(bb + j * kKp + q - k0, ok ? row + q : b, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ck = 0; ck < kPipe - 1; ++ck) load(ck);
  for (int ck = 0; ck < chunks; ++ck) {
    cp_async_wait<kPipe - 2>();
    __syncthreads();  // chunk ck is in; chunk ck - 1's buffer is free
    load(ck + kPipe - 1);
    const __nv_bfloat16* buf = stage + (ck % kPipe) * BUF;
    const __nv_bfloat16* as = kAStream ? buf : a + ck * kKc;
    const int pa = kAStream ? kKp : (int)lda;
    const __nv_bfloat16* bs = buf + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < kKc / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, frag_a(as, pa, m0, 16 * kk, lane));
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bf[4];
        ldsm_x4(bf, frag_b_nk(bs, kKp, 16 * jj, 16 * kk, lane));
        mma_bf16(acc[2 * jj], af, bf[0], bf[1]);
        mma_bf16(acc[2 * jj + 1], af, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// A warp's 16 x NT * 8 accumulator rounded to bf16 into rows m0 .. of a
// row-major shared tile of pitch `pitch` (4-byte stores).
template <int NT>
__device__ __forceinline__ void acc_to_smem(const float (&acc)[NT][4],
                                            __nv_bfloat16* dst, int pitch,
                                            int m0, int lane) {
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    __nv_bfloat16* p = dst + (m0 + gq) * pitch + nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<uint32_t*>(p + 8 * pitch) =
        pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// Head h's q, k, v (the warp's rows of x Wqkv^T for the head's 3 hd
// columns) plus bqkv, rounded to bf16 into three tiles of HD + 8 columns.
template <int HD>
__device__ __forceinline__ void qkv_to_tiles(const float (&acc)[3 * HD / 8][4],
                                             const float* __restrict__ bqkv,
                                             int c, int h,
                                             __nv_bfloat16* tiles, int m0,
                                             int lane) {
  constexpr int P = HD + 8, TILE = kTcRows * P;
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 3 * HD / 8; ++nt) {
    const int col = nt * 8 + 2 * t, part = col / HD, d = col % HD;
    const float* bb = bqkv + part * c + h * HD + d;
    const float b0 = __ldg(bb), b1 = __ldg(bb + 1);
    __nv_bfloat16* p = tiles + part * TILE + (m0 + gq) * P + d;
    *reinterpret_cast<uint32_t*>(p) =
        pack_bf16(acc[nt][0] + b0, acc[nt][1] + b1);
    *reinterpret_cast<uint32_t*>(p + 8 * P) =
        pack_bf16(acc[nt][2] + b0, acc[nt][3] + b1);
  }
}

// add_s (n x n fp32, shared) = bias_h + mask_w (mask_w may be null), read
// in coalesced loads by every thread of the block; the caller's next
// barrier publishes it.
__device__ __forceinline__ void stage_logit_add(
    float* add_s, const float* __restrict__ bias_h,
    const float* __restrict__ mask_w, int n) {
  for (int e = threadIdx.x; e < n * n; e += kTcThreads)
    add_s[e] = __ldg(bias_h + e) + (mask_w ? __ldg(mask_w + e) : 0.f);
}

// This warp's rows of P = softmax(scale q k^T + add_s) over the 64 padded
// keys (-inf past n), fp32 in the accumulator layout: the lane holds rows
// m0 + gq and m0 + gq + 8, columns 8 nt + 2 t + {0, 1}. Rows past n are
// zero. q_s and k_s are the head's bf16 tiles, add_s the head's bias plus
// the window's mask (stage_logit_add).
template <int HD>
__device__ __forceinline__ void head_probs(float (&s)[kTcKeyTiles][4],
                                           const __nv_bfloat16* q_s,
                                           const __nv_bfloat16* k_s,
                                           const float* add_s, int n,
                                           float scale, int m0, int lane) {
  constexpr int P = HD + 8;
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, frag_a(q_s, P, m0, 16 * kk, lane));
#pragma unroll
    for (int jj = 0; jj < kTcKeyTiles / 2; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, frag_b_nk(k_s, P, 16 * jj, 16 * kk, lane));
      mma_bf16(s[2 * jj], a, b[0], b[1]);
      mma_bf16(s[2 * jj + 1], a, b[2], b[3]);
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + gq + (e >> 1) * 8, j = nt * 8 + 2 * t + (e & 1);
      float v = -INFINITY;
      if (j < n) {
        v = s[nt][e] * scale;
        if (i < n) v += add_s[i * n + j];
      }
      s[nt][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  float sum[2] = {0.f, 0.f}, inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
      sum[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    inv[r] = m0 + gq + 8 * r < n ? 1.f / sum[r] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];
}

// o = round(P) v for this warp's rows, v_s the head's v tile.
template <int HD>
__device__ __forceinline__ void probs_times_v(
    float (&o)[HD / 8][4], const float (&s)[kTcKeyTiles][4],
    const __nv_bfloat16* v_s, int lane) {
  constexpr int P = HD + 8;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kTcRows / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, s, kk);
#pragma unroll
    for (int dd = 0; dd < HD / 16; ++dd) {
      uint32_t b[4];
      ldsm_x4_t(b, frag_b_kn(v_s, P, 16 * kk, 16 * dd, lane));
      mma_bf16(o[2 * dd], a, b[0], b[1]);
      mma_bf16(o[2 * dd + 1], a, b[2], b[3]);
    }
  }
}

// Row 12. A cluster of `cluster` blocks (blockIdx.x / cluster the window,
// blockIdx.x % cluster the block's rank) splits a window by heads: rank r
// forms q, k, v and the attention output of heads r heads .. (its
// `heads` hd columns of the 64 x C attention output) into a shared tile
// (ao, row pitch ceil32(heads hd) + 8). After a cluster barrier each
// block writes output columns r heads hd .. of out = ao Wproj^T + bproj,
// reading the attention output chunk by chunk from every rank's tile
// through distributed shared memory; a last barrier keeps every block's ao
// alive until the others have read it. wqkv and wproj are the bf16
// weights. Shared memory: ao, q, k, v tiles, the head's bias plus mask,
// the pipeline.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, min_blocks(HD))
wattn4_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wqkv,
                     const float* __restrict__ bqkv,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ wproj,
                     const float* __restrict__ bproj,
                     __nv_bfloat16* __restrict__ out, int n, int c,
                     int heads, int cluster, int nw, float scale) {
  constexpr int NQ = 3 * HD / 8, TILE = kTcRows * (HD + 8);
  extern __shared__ __align__(16) unsigned char v4_smem[];
  const int cols = heads * HD, ldo = ceil32(cols) + 8;
  __nv_bfloat16* ao = reinterpret_cast<__nv_bfloat16*>(v4_smem);
  __nv_bfloat16* tiles = ao + kTcRows * ldo;
  float* add_s = reinterpret_cast<float*>(tiles + 3 * TILE);
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(add_s + add_floats(n, HD));
  const int rank = blockIdx.x % cluster, win = blockIdx.x / cluster;
  const int tid = threadIdx.x, lane = tid & 31, m0 = 16 * (tid >> 5);
  const int gq = lane >> 2, t = lane & 3;
  // a block alone reads its ao up to column ceil32(C): zero past C
  const int pad = ceil32(cols) - cols;
  for (int e = tid; e < kTcRows * pad; e += kTcThreads)
    ao[(e / pad) * ldo + cols + e % pad] = __float2bfloat16(0.f);
  const __nv_bfloat16* xw = x + (size_t)win * n * c;
  const float* mask_w = mask ? mask + (size_t)(win % nw) * n * n : nullptr;

  for (int hl = 0; hl < heads; ++hl) {
    const int h = rank * heads + hl;
    stage_logit_add(add_s, bias + (size_t)h * n * n, mask_w, n);
    float acc[NQ][4] = {};
    gemm_stream<NQ, kAGlobal>(acc, xw, c, n, wqkv + (size_t)h * HD * c, c,
                              HD, c, 3 * HD, c, stage);
    qkv_to_tiles<HD>(acc, bqkv, c, h, tiles, m0, lane);
    __syncthreads();
    float s[kTcKeyTiles][4];
    head_probs<HD>(s, tiles, tiles + TILE, add_s, n, scale, m0, lane);
    float o[HD / 8][4];
    probs_times_v<HD>(o, s, tiles + 2 * TILE, lane);
    acc_to_smem<HD / 8>(o, ao + hl * HD, ldo, m0, lane);
    __syncthreads();  // the tiles and add_s take the next head
  }

  if (cluster > 1) cg::this_cluster().sync();  // every rank's ao is in
  const int o_begin = rank * cols;
  for (int o0 = o_begin; o0 < o_begin + cols; o0 += kProjCols) {
    const int nb = min(kProjCols, o_begin + cols - o0);
    float acc[kProjCols / 8][4] = {};
    if (cluster > 1)
      gemm_stream<kProjCols / 8, kACluster>(
          acc, ao, ldo, cols, wproj + (size_t)o0 * c, c, nb, 0, nb, c,
          stage);
    else
      gemm_stream<kProjCols / 8, kAShared>(
          acc, ao, ldo, kTcRows, wproj + (size_t)o0 * c, c, nb, 0, nb, c,
          stage);
#pragma unroll
    for (int nt = 0; nt < kProjCols / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (col >= nb) continue;
      const float b0 = __ldg(bproj + o0 + col);
      const float b1 = __ldg(bproj + o0 + col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + gq + 8 * r;
        if (row < n)
          *reinterpret_cast<uint32_t*>(out + ((size_t)win * n + row) * c +
                                       o0 + col) =
              pack_bf16(acc[nt][2 * r] + b0, acc[nt][2 * r + 1] + b1);
      }
    }
  }
  if (cluster > 1) cg::this_cluster().sync();  // the others read our ao
}

// Row 13, first kernel. Block (windows blockIdx.x * windows .., head
// blockIdx.y), per window: the head's q, k, v from x and Wqkv's rows (one
// streamed product of 3 hd columns), d(attn)_h = g Wproj[:, head] from g
// and Wproj^T's rows, each rounded to bf16 into a tile; then P in
// registers, o_h = round(P) v to ao (bf16, for dWproj), and the attention
// backward of csrc/window_attention.cu's row 7 (dP = d V^T, dS in fp32,
// summed into dBias, P and dS in bf16 for dV = P^T d and dK = scale dS^T Q,
// dQ = scale dS K) into dqkv (bf16). Shared memory: q, k, v, d tiles, P
// and dS (64 x kTcPitchP each), the window's bias plus mask (add_s), whose
// room the warps' staging tiles take once P is in registers, the
// pipeline.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, min_blocks(HD))
wattn4_bwd_heads_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ wqkv,
                           const float* __restrict__ bqkv,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           const __nv_bfloat16* __restrict__ wproj_t,
                           const __nv_bfloat16* __restrict__ g,
                           __nv_bfloat16* __restrict__ ao,
                           __nv_bfloat16* __restrict__ dqkv,
                           float* __restrict__ dbias, int b_, int n, int c,
                           int nw, int windows, float scale) {
  constexpr int P = HD + 8, TILE = kTcRows * P, NQ = 3 * HD / 8;
  extern __shared__ __align__(16) unsigned char v4_smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(v4_smem);
  const __nv_bfloat16* q_s = tiles;
  const __nv_bfloat16* k_s = tiles + TILE;
  const __nv_bfloat16* v_s = tiles + 2 * TILE;
  __nv_bfloat16* da_s = tiles + 3 * TILE;
  __nv_bfloat16* sp = tiles + 4 * TILE;
  __nv_bfloat16* sds = sp + kTcRows * kTcPitchP;
  const int h = blockIdx.y;
  const int w0 = blockIdx.x * windows, w_end = min(w0 + windows, b_);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3, m0 = 16 * warp;
  float* add_s = reinterpret_cast<float*>(sds + kTcRows * kTcPitchP);
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(add_s) + warp * 16 * P;
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(add_s + add_floats(n, HD));
  float db[kTcKeyTiles][4] = {};
  for (int win = w0; win < w_end; ++win) {
    stage_logit_add(add_s, bias + (size_t)h * n * n,
                    mask ? mask + (size_t)(win % nw) * n * n : nullptr, n);
    {
      float acc[NQ][4] = {};
      gemm_stream<NQ, kAGlobal>(acc, x + (size_t)win * n * c, c, n,
                                wqkv + (size_t)h * HD * c, c, HD, c, 3 * HD,
                                c, stage);
      qkv_to_tiles<HD>(acc, bqkv, c, h, tiles, m0, lane);
    }
    {
      float acc[HD / 8][4] = {};
      gemm_stream<HD / 8, kAGlobal>(
          acc, g + (size_t)win * n * c, c, n, wproj_t + (size_t)h * HD * c,
          c, HD, 0, HD, c, stage);
      acc_to_smem<HD / 8>(acc, da_s, P, m0, lane);
    }
    __syncthreads();  // q, k, v, d and add_s are in
    float pf[kTcKeyTiles][4];
    head_probs<HD>(pf, q_s, k_s, add_s, n, scale, m0, lane);
    __syncthreads();  // the staging tiles take add_s's room
    {
      float o[HD / 8][4];
      probs_times_v<HD>(o, pf, v_s, lane);
      store_tile<HD>(o, 1.f, st, ao + (size_t)win * n * c + h * HD, c, m0,
                     n, lane);
    }
    attention_bwd_tile<HD>(pf, q_s, k_s, v_s, da_s, sp, sds, st,
                           dqkv + (size_t)win * n * 3 * c + h * HD, c, db, n,
                           scale, m0, lane);
    __syncthreads();  // the tiles, P and dS take the next window
  }
  float* dbias_h = dbias + (size_t)h * n * n;
#pragma unroll
  for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + gq + (e >> 1) * 8, j = nt * 8 + 2 * t + (e & 1);
      if (i < n && j < n) atomicAdd(dbias_h + i * n + j, db[nt][e]);
    }
}

// Row 13, dx = dqkv Wqkv for a 64-row x NT * 8-column tile (blockIdx.y,
// blockIdx.x: the column tiles of a row tile run side by side, so its
// rows of dqkv come from device memory once): Wqkv^T (C, 3C) gives B's
// rows; no atomics, rounded once.
template <int NT>
__global__ void __launch_bounds__(kTcThreads)
wattn4_bwd_dx_tc_kernel(const __nv_bfloat16* __restrict__ dqkv,
                        const __nv_bfloat16* __restrict__ wqkv_t,
                        __nv_bfloat16* __restrict__ dx, int64_t rows, int c) {
  extern __shared__ __align__(16) unsigned char v4_smem[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(v4_smem);
  const int64_t r0 = (int64_t)blockIdx.y * kTcRows;
  const int c0 = blockIdx.x * NT * 8, c3 = 3 * c;
  const int nb = min(NT * 8, c - c0);
  const int lane = threadIdx.x & 31, m0 = 16 * (threadIdx.x >> 5);
  const int gq = lane >> 2, t = lane & 3;
  float acc[NT][4] = {};
  gemm_stream<NT, kAGlobal>(acc, dqkv + r0 * c3, c3,
                            rows - r0 < kTcRows ? (int)(rows - r0) : kTcRows,
                            wqkv_t + (size_t)c0 * c3, c3, nb, 0, nb, c3,
                            stage);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col >= nb) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t row = r0 + m0 + gq + 8 * r;
      if (row < rows)
        *reinterpret_cast<uint32_t*>(dx + row * c + c0 + col) =
            pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// Row 13, out (M, N) += a^T b over this block's split of the rows, for
// the 64 x 64 tile (blockIdx.x, blockIdx.y), one fp32 atomic per entry
// per split; blocks of the first column of tiles also add a's column sums
// into db. a (rows, M) and b (rows, N) are row-major bf16; 64-row chunks
// of both come in by cp.async as MN-major swizzled boxes (a row one row of
// a or b) and feed wgmma m64n64k16 with both operands transposed.
__global__ void __launch_bounds__(kTcThreads)
wattn4_bwd_dw_tc_kernel(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b,
                        float* __restrict__ out, float* __restrict__ db,
                        int64_t rows, int M, int N, int64_t per) {
  constexpr int BUF = 2 * kBoxBytes;
  extern __shared__ __align__(16) unsigned char v4_smem[];
  unsigned char* stage = align1024(v4_smem);
  const int m_base = blockIdx.x * kDwTile, n_base = blockIdx.y * kDwTile;
  const int64_t r_begin = (int64_t)blockIdx.z * per;
  const int64_t r_end = r_begin + per < rows ? r_begin + per : rows;
  const int chunks = (int)((r_end - r_begin + kTcRows - 1) / kTcRows);
  const int tid = threadIdx.x, lane = tid & 31, m0 = 16 * (tid >> 5);
  const int gq = lane >> 2, t = lane & 3;
  const bool sums = blockIdx.y == 0;
  auto load = [&](int ck) {
    if (ck < chunks) {
      unsigned char* buf = stage + (ck % kDwPipe) * BUF;
      const int64_t rk = r_begin + (int64_t)ck * kTcRows;
      for (int e = tid; e < 2 * kTcRows * 8; e += kTcThreads) {
        const int op = e / (kTcRows * 8), i = (e >> 3) % kTcRows, c = e & 7;
        const int col = (op ? n_base : m_base) + c * 8, width = op ? N : M;
        const bool ok = rk + i < r_end && col < width;
        const __nv_bfloat16* src = op ? b : a;
        cp_async16_zfill(buf + op * kBoxBytes + swz(i, c),
                         ok ? src + (rk + i) * width + col : src, ok);
      }
    }
    cp_async_commit();
  };
  float acc[kDwTile / 8][4] = {};
  float colsum = 0.f;
#pragma unroll
  for (int ck = 0; ck < kDwPipe - 1; ++ck) load(ck);
  for (int ck = 0; ck < chunks; ++ck) {
    cp_async_wait<kDwPipe - 2>();
    sm90::fence_proxy_async();
    __syncthreads();
    load(ck + kDwPipe - 1);
    const unsigned char* as = stage + (ck % kDwPipe) * BUF;
    const uint32_t at = sm90::smem_u32(as);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTcRows / 16; ++k)
      sm90::wgmma_m64n64k16<1, 1>(*reinterpret_cast<float(*)[32]>(&acc[0][0]),
                                  mnmajor(at, k), mnmajor(at + kBoxBytes, k),
                                  1);
    sm90::wgmma_commit();
    if (sums && tid < kDwTile)
      for (int i = 0; i < kTcRows; ++i)
        colsum += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
            as + swz(i, tid >> 3) + (tid & 7) * 2));
    sm90::wgmma_wait<0>();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int nt = 0; nt < kDwTile / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int m = m_base + m0 + gq + (e >> 1) * 8;
      const int k = n_base + nt * 8 + 2 * t;
      if (m < M && k < N)
        atomicAdd(reinterpret_cast<float2*>(out + (size_t)m * N + k),
                  make_float2(acc[nt][e], acc[nt][e + 1]));
    }
  if (sums && tid < kDwTile && m_base + tid < M)
    atomicAdd(db + m_base + tid, colsum);
}

// fp32 (rows, cols) w rounded to bf16, into `same` (rows, cols) and / or
// its transpose `tr` (cols, rows), either null; 32 x 32 tiles through
// shared memory so both stores are coalesced.
__global__ void wattn4_cast_kernel(const float* __restrict__ w, int rows,
                                   int cols, __nv_bfloat16* __restrict__ same,
                                   __nv_bfloat16* __restrict__ tr) {
  __shared__ __nv_bfloat16 tile[32][34];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, col = c0 + threadIdx.x;
    if (r < rows && col < cols) {
      const __nv_bfloat16 v = __float2bfloat16(w[(size_t)r * cols + col]);
      if (same) same[(size_t)r * cols + col] = v;
      tile[i][threadIdx.x] = v;
    }
  }
  if (!tr) return;
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int col = c0 + i, r = r0 + threadIdx.x;
    if (r < rows && col < cols)
      tr[(size_t)col * rows + r] = tile[threadIdx.x][i];
  }
}

cudaError_t launch_cast(const float* w, int rows, int cols,
                        __nv_bfloat16* same, __nv_bfloat16* tr,
                        cudaStream_t stream) {
  dim3 grid((cols + 31) / 32, (rows + 31) / 32);
  wattn4_cast_kernel<<<grid, dim3(32, 8), 0, stream>>>(w, rows, cols, same,
                                                       tr);
  return cudaGetLastError();
}

// Shared memory of the tensor-core kernels (ops/window_attention_v4.py
// tc_fwd_smem and tc_bwd_smem compute the same): the forward's columns of
// the attention output, q, k, v tiles, add_s and pipeline; the backward's
// q, k, v, d tiles, P and dS, add_s (or the staging tiles) and pipeline.
// The pipeline holds kPipe chunks of a 64-row A and the 3 hd rows of
// B, or the projection's kProjCols rows where those are more.
inline size_t tc_pipe_bytes(int hd) {
  return 2 * (size_t)kPipe *
         (kTcRows + (3 * hd > kProjCols ? 3 * hd : kProjCols)) * kKp;
}
inline size_t tc_fwd_smem(int n, int c, int hd, int cluster) {
  return 2 * ((size_t)kTcRows * (ceil32(c / cluster) + 8) +
              3 * kTcRows * (hd + 8)) +
         4 * (size_t)add_floats(n, hd) + tc_pipe_bytes(hd);
}
inline size_t tc_bwd_smem(int n, int hd) {
  return 2 * ((size_t)4 * kTcRows * (hd + 8) + 2 * kTcRows * kTcPitchP) +
         4 * (size_t)add_floats(n, hd) + tc_pipe_bytes(hd);
}

template <int HD>
int launch_fwd_tc(const __nv_bfloat16* x, const float* wqkv,
                  const float* bqkv, const float* bias, const float* mask,
                  const float* wproj, const float* bproj, __nv_bfloat16* out,
                  __nv_bfloat16* w16, int b_, int n, int c, int nh, int nw,
                  float scale, int cluster, cudaStream_t stream) {
  __nv_bfloat16* wqkv16 = w16;
  __nv_bfloat16* wproj16 = w16 + 3 * (size_t)c * c;
  cudaError_t e = launch_cast(wqkv, 3 * c, c, wqkv16, nullptr, stream);
  if (e == cudaSuccess) e = launch_cast(wproj, c, c, wproj16, nullptr, stream);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = tc_fwd_smem(n, c, HD, cluster);
  auto kernel = wattn4_fwd_tc_kernel<HD>;
  if ((e = allow_smem(kernel, smem)) != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b_ * cluster));
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, (const __nv_bfloat16*)wqkv16, bqkv,
                         bias, mask, (const __nv_bfloat16*)wproj16, bproj,
                         out, n, c, nh / cluster, cluster, nw, scale);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

cudaError_t launch_dw_tc(const __nv_bfloat16* a, const __nv_bfloat16* b,
                         float* out, float* db, int64_t rows, int M, int N,
                         int64_t per, cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)kDwPipe * 2 * kBoxBytes;
  cudaError_t e = allow_smem(wattn4_bwd_dw_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + kDwTile - 1) / kDwTile, (N + kDwTile - 1) / kDwTile,
            (unsigned)((rows + per - 1) / per));
  wattn4_bwd_dw_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      a, b, out, db, rows, M, N, per);
  return cudaGetLastError();
}

// dx = dqkv Wqkv in tiles of 96 columns where C is a multiple of 96
// (Swin-T/S), else 64.
template <int NT>
cudaError_t launch_dx_tc(const __nv_bfloat16* dqkv,
                         const __nv_bfloat16* wqkv_t, __nv_bfloat16* dx,
                         int64_t rows, int c, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kPipe * (kTcRows + NT * 8) * kKp;
  auto kernel = wattn4_bwd_dx_tc_kernel<NT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((c + NT * 8 - 1) / (NT * 8),
            (unsigned)((rows + kTcRows - 1) / kTcRows));
  kernel<<<grid, kTcThreads, smem, stream>>>(dqkv, wqkv_t, dx, rows, c);
  return cudaGetLastError();
}

template <int HD>
int launch_bwd_tc(const __nv_bfloat16* x, const float* wqkv,
                  const float* bqkv, const float* bias, const float* mask,
                  const float* wproj, const __nv_bfloat16* g,
                  __nv_bfloat16* ao, __nv_bfloat16* dqkv, __nv_bfloat16* w16,
                  __nv_bfloat16* dx, float* dwqkv, float* dbqkv,
                  float* dbias, float* dwproj, float* dbproj, int b_, int n,
                  int c, int nh, int nw, float scale, int windows,
                  int64_t qkv_split, int64_t proj_split,
                  cudaStream_t stream) {
  __nv_bfloat16* wqkv16 = w16;
  __nv_bfloat16* wqkv_t = w16 + 3 * (size_t)c * c;
  __nv_bfloat16* wproj_t = w16 + 6 * (size_t)c * c;
  cudaError_t e = launch_cast(wqkv, 3 * c, c, wqkv16, wqkv_t, stream);
  if (e == cudaSuccess) e = launch_cast(wproj, c, c, nullptr, wproj_t, stream);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = tc_bwd_smem(n, HD);
  auto heads = wattn4_bwd_heads_tc_kernel<HD>;
  if ((e = allow_smem(heads, smem)) != cudaSuccess) return (int)e;
  dim3 grid((b_ + windows - 1) / windows, nh);
  heads<<<grid, kTcThreads, smem, stream>>>(x, wqkv16, bqkv, bias, mask,
                                            wproj_t, g, ao, dqkv, dbias, b_,
                                            n, c, nw, windows, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t)b_ * n;
  e = c % 96 == 0 ? launch_dx_tc<12>(dqkv, wqkv_t, dx, rows, c, stream)
                  : launch_dx_tc<8>(dqkv, wqkv_t, dx, rows, c, stream);
  if (e != cudaSuccess) return (int)e;
  if ((e = launch_dw_tc(dqkv, x, dwqkv, dbqkv, rows, 3 * c, c, qkv_split,
                        stream)) != cudaSuccess)
    return (int)e;
  return (int)launch_dw_tc(g, ao, dwproj, dbproj, rows, c, c, proj_split,
                           stream);
}

}  // namespace swindet

// x (B_, N, C) of dtype (0 fp32, 1 bf16); wqkv (3C, C), bqkv (3C), bias
// (nH, N, N), wproj (C, C), bproj (C) fp32; mask (nW, N, N) fp32 or null;
// out (B_, N, C) of dtype.
SWINDET_EXPORT int swindet_window_attention_v4(
    const void* x, const float* wqkv, const float* bqkv, const float* bias,
    const float* mask, const float* wproj, const float* bproj, void* out,
    int b_, int n, int c, int nh, int nw, float scale, int dtype,
    void* stream) {
  using namespace swindet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_ == 0) return (int)cudaSuccess;
  if (dtype == kBFloat16)
    return launch_fwd<__nv_bfloat16>(x, wqkv, bqkv, bias, mask, wproj, bproj,
                                     out, b_, n, c, nh, nw, scale, s);
  if (dtype == kFloat32)
    return launch_fwd<float>(x, wqkv, bqkv, bias, mask, wproj, bproj, out, b_,
                             n, c, nh, nw, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The backward for the output gradient g (B_, N, C) of dtype. ao (B_, N, C)
// and dqkv (B_, N, 3C) are fp32 scratch; dx (B_, N, C) of dtype; dwqkv
// (3C, C), dbqkv (3C), dbias (nH, N, N), dwproj (C, C), dbproj (C) fp32,
// zeroed by the caller.
SWINDET_EXPORT int swindet_window_attention_v4_bwd(
    const void* x, const float* wqkv, const float* bqkv, const float* bias,
    const float* mask, const float* wproj, const void* g, float* ao,
    float* dqkv, void* dx, float* dwqkv, float* dbqkv, float* dbias,
    float* dwproj, float* dbproj, int b_, int n, int c, int nh, int nw,
    float scale, int dtype, void* stream) {
  using namespace swindet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_ == 0) return (int)cudaSuccess;
  if (dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16>(x, wqkv, bqkv, bias, mask, wproj, g, ao,
                                     dqkv, dx, dwqkv, dbqkv, dbias, dwproj,
                                     dbproj, b_, n, c, nh, nw, scale, s);
  if (dtype == kFloat32)
    return launch_bwd<float>(x, wqkv, bqkv, bias, mask, wproj, g, ao, dqkv,
                             dx, dwqkv, dbqkv, dbias, dwproj, dbproj, b_, n,
                             c, nh, nw, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core forward (row 12): as swindet_window_attention_v4 for
// bf16 x and out with N <= 64, hd in {16, 32, 48, 64} and C a multiple of
// 16, 16-byte aligned; w16 is bf16 scratch of 4 C^2 elements for the
// rounded weights; `cluster` blocks (a divisor of nH up to 8) share a
// window.
SWINDET_EXPORT int swindet_window_attention_v4_tc(
    const void* x, const float* wqkv, const float* bqkv, const float* bias,
    const float* mask, const float* wproj, const float* bproj, void* out,
    void* w16, int b_, int n, int c, int nh, int nw, float scale,
    int cluster, void* stream) {
  using namespace swindet;
  if (b_ == 0) return (int)cudaSuccess;
  if (n > kTcRows || cluster < 1 || cluster > 8 || nh % cluster)
    return (int)cudaErrorInvalidValue;
  return by_head_dim(c / nh, [&](auto hd) {
    return launch_fwd_tc<decltype(hd)::value>(
        static_cast<const __nv_bfloat16*>(x), wqkv, bqkv, bias, mask, wproj,
        bproj, static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(w16), b_, n, c, nh, nw, scale, cluster,
        static_cast<cudaStream_t>(stream));
  });
}

// The bf16 tensor-core backward (row 13): as
// swindet_window_attention_v4_bwd for bf16 x, g and dx with the shapes of
// swindet_window_attention_v4_tc; ao (B_, N, C) and dqkv (B_, N, 3C) are
// bf16 scratch, w16 bf16 scratch of 7 C^2 elements; `windows` windows a
// block of the heads kernel; the two weight gradients split their rows in
// runs of qkv_split and proj_split rows (multiples of 32).
SWINDET_EXPORT int swindet_window_attention_v4_bwd_tc(
    const void* x, const float* wqkv, const float* bqkv, const float* bias,
    const float* mask, const float* wproj, const void* g, void* ao,
    void* dqkv, void* w16, void* dx, float* dwqkv, float* dbqkv,
    float* dbias, float* dwproj, float* dbproj, int b_, int n, int c, int nh,
    int nw, float scale, int windows, int qkv_split, int proj_split,
    void* stream) {
  using namespace swindet;
  if (b_ == 0) return (int)cudaSuccess;
  if (n > kTcRows || windows < 1 || qkv_split < 1 || proj_split < 1)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  return by_head_dim(c / nh, [&](auto hd) {
    return launch_bwd_tc<decltype(hd)::value>(
        static_cast<const bf*>(x), wqkv, bqkv, bias, mask, wproj,
        static_cast<const bf*>(g), static_cast<bf*>(ao),
        static_cast<bf*>(dqkv), static_cast<bf*>(w16), static_cast<bf*>(dx),
        dwqkv, dbqkv, dbias, dwproj, dbproj, b_, n, c, nh, nw, scale,
        windows, qkv_split, proj_split, static_cast<cudaStream_t>(stream));
  });
}
