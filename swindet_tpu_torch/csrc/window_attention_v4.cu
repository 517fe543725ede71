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
// Numbers as on the TPU: x in the compute type, Wqkv (3C, C), bqkv, Wproj
// (C, C), bproj (nn.Linear layout), the relative-position bias (nH, N, N)
// and the shift mask (nW, N, N; window w reads mask[w mod nW]) read in
// fp32; qkv, the logits, P and the attention output are fp32 and stay on
// chip; the output is rounded once to x's type.
//
// Bound: operations. Per window the two projections cost 8 N C^2 flops
// (4.7 MFLOP at stage 1, C = 96; 231 MFLOP at stage 4, C = 768) on 2 N C
// elements in and out, 100 to 800 flops per byte, and the attention
// 4 N^2 C more. The TPU kept both weight matrices and a block of windows
// in VMEM; Wqkv alone is 7 MB in fp32 at stage 4, far over a block's
// 227 KB. Forward design (wattn4_fwd_kernel): one block per window loops
// over the heads. For head h it forms that head's q, k, v (N x 3hd) from x
// and the matching Wqkv rows, both streamed from device memory (L2 after
// the first window), into shared memory; the logits, softmax and P v run
// from there as in csrc/window_attention.cu, and the head's output lands
// in an N x C fp32 buffer in shared memory. Once every head is done the
// block multiplies that buffer by Wproj (streamed) and writes the rounded
// output. Shared memory is 4 (N C + 3 N (hd + 1) + max(N (N + 1), 2080))
// bytes: 225 KB at N = 49, C = 1,024, hd = 32 (Swin-B's stage 4); the
// wrapper refuses shapes over the 227 KB. The products run on the CUDA
// cores (SIMT fp32 FMA, csrc/tile_gemm.cuh): tensor cores are later work.
//
// Backward: the TPU recomputed qkv and P per window block and summed
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
//     -- the one device-memory round trip the TPU avoided, in fp32 so that
//     nothing is rounded -- and sums dS over its windows in shared memory,
//     adding that to dBias with one atomic per entry per group.
//  2. wattn4_bwd_dx_kernel: dx = dqkv Wqkv per 64-row tile, no atomics:
//     deterministic, rounded once to x's type.
//  3. wattn4_bwd_dw_kernel, twice: dWqkv = dqkv^T x with dbqkv, and
//     dWproj = g^T o with dbproj. Each block sums a 64 x 32 tile over one
//     split of the rows in registers and adds it with one fp32 atomic per
//     entry per split (the host picks splits for about two blocks per SM),
//     not one per entry per window. The atomics' order varies, so the
//     weight gradients and dBias vary in their last bits.
#include <algorithm>

#include "tile_gemm.cuh"

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
