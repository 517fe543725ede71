// Fused token MLP of the Swin blocks, over rows of tokens:
//   h   = x W1^T + b1          (fp32 accumulation, fp32 bias)
//   a   = GELU(h), rounded to x's type
//   out = a W2^T + b2          (fp32 accumulation, cast to x's type)
// x (R, C), W1 (H, C), W2 (Co, H) in x's type (nn.Linear layout), biases
// fp32. GELU is exact-erf with XLA's fp32 rational erf, as the TPU kernel
// evaluates it (swindet_tpu/ops/fused_mlp.py:28-50).
//
// Replaces: swindet_tpu/ops/fused_mlp.py · _mlp_kernel (via _mlp_fwd_impl,
// pallas_call at :95) and · _mlp_bwd_kernel (via _mlp_bwd_impl, pallas_call
// at :161), the SWINDET_FUSED_MLP=1 configuration of stages 1-3 of Swin-T:
// (R, C, H) = (67,200, 96, 384), (16,800, 192, 768), (4,200, 384, 1,536)
// per 800x1344 image.
//
// Bound: operations. Each row costs 4 C H flops in the forward for 2 C
// elements in and out, about 100 flops per byte at stage 1 and 400 at stage
// 3 in bf16, near or above the card's ridge; the point of fusing is that the
// (R, H) hidden, the largest activation of the block, never goes to device
// memory. The TPU kept the whole hidden of a row block and both weights in
// VMEM. Here a block holds a 64-row tile and loops over the hidden in
// chunks: the chunk's h is computed into registers, GELU'd, rounded and
// staged in shared memory, and multiplied into an fp32 output accumulator
// that stays in shared memory (64 x Co) until the tile is done.
//
// The products run on the CUDA cores (SIMT fp32 FMA, 4 x 4 register tiles
// per thread, K staged through shared memory 16 deep, as csrc/conv3x3.cu):
// one code path serves fp32 and bf16, and bf16 x bf16 products are exact in
// fp32, so the kernel sums the same products the TPU kernel does, in another
// order. Tensor cores (mma / wgmma on bf16) are the next step for speed.
//
// Backward, after _mlp_bwd_kernel (:115-149), recomputing the hidden:
//   h = x W1^T + b1, a = GELU(h)
//   dW2 = g^T round(a), db2 = sum g          (g, a in x's type; fp32 sums)
//   da = g W2, dh = round(da * GELU'(h))      (rounded to x's type)
//   dW1 = dh^T x, db1 = sum dh, dx = dh W1    (fp32 sums; dx cast)
// The TPU summed dW1, db1, dW2, db2 across its sequential grid. Blocks here
// run in parallel, so the backward is two kernels: mlp_bwd_dx_kernel, per
// 64-row tile like the forward (dx accumulates over hidden chunks in shared
// memory; no atomics, so dx is deterministic), and mlp_bwd_dw_kernel, per
// 32-wide hidden chunk and split of the rows, which sums its chunk's dW1 and
// dW2 columns over its rows in shared memory and adds them to the zeroed
// fp32 outputs with one fp32 atomicAdd per entry. The host picks the number
// of splits for about two blocks per SM; the order of the atomics varies,
// so the weight gradients vary in their last bits.
#include <algorithm>

#include "tile_gemm.cuh"

namespace swindet {

constexpr int kMlpThreads = kGemmThreads;
constexpr int kTileRows = 64;
constexpr int kChunk = 64;   // hidden chunk of the forward and of dx
constexpr int kDwChunk = 32; // hidden chunk of the weight gradients

// XLA's fp32 erf (ErfImpl32): x P(x^2) / Q(x^2) on x clamped to
// +-erfinv(1 - 2^-23)
__device__ __forceinline__ float erf_xla(float x) {
  x = fminf(fmaxf(x, -3.832506856900711f), 3.832506856900711f);
  const float x2 = x * x;
  float p = 0.00022905065861350646f;
  p = p * x2 + 0.0034082910107109506f;
  p = p * x2 + 0.050955695062380861f;
  p = p * x2 + 0.18520832239976145f;
  p = p * x2 + 1.128379143519084f;
  float q = -1.1791602954361697e-7f;
  q = q * x2 + 0.000023547966471313185f;
  q = q * x2 + 0.0010179625278914885f;
  q = q * x2 + 0.014070470171167667f;
  q = q * x2 + 0.11098505178285362f;
  q = q * x2 + 0.49746925110067538f;
  q = q * x2 + 1.0f;
  return (x * p) / q;
}

__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.0f + erf_xla(h * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_grad(float h) {
  const float cdf = 0.5f * (1.0f + erf_xla(h * 0.7071067811865476f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * h * h);
  return cdf + h * pdf;
}

// ----------------------------------------------------------------- forward
// Dynamic shared memory: acc (64 x co) fp32, a (64 x 65) fp32.
template <typename T>
__global__ void __launch_bounds__(kMlpThreads)
mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ out, int rows,
               int c, int hid, int co) {
  extern __shared__ float smem[];
  float* acc = smem;
  float* a_s = acc + kTileRows * co;
  __shared__ float As[kStage], Bs[kStage];
  const int64_t row0 = (int64_t)blockIdx.x * kTileRows;
  const Micro<64, 64, 4, 4> mt;
  for (int e = threadIdx.x; e < kTileRows * co; e += kMlpThreads) acc[e] = 0.f;
  auto xa = [&](int m, int k) {
    return row0 + m < rows ? to_f32(x[(row0 + m) * c + k]) : 0.f;
  };
  for (int j0 = 0; j0 < hid; j0 += kChunk) {
    float h[4][4] = {};
    tile_gemm<64, 64, 4, 4, false, false>(
        h, c, xa,
        [&](int n, int k) {
          return j0 + n < hid ? to_f32(w1[(int64_t)(j0 + n) * c + k]) : 0.f;
        },
        As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jn = j0 + mt.tn + j;
        a_s[(mt.tm + i) * (kChunk + 1) + mt.tn + j] =
            jn < hid ? round_to<T>(gelu(h[i][j] + b1[jn])) : 0.f;
      }
    __syncthreads();
    for (int o0 = 0; o0 < co; o0 += 64) {
      float o[4][4] = {};
      tile_gemm<64, 64, 4, 4, false, false>(
          o, min(kChunk, hid - j0),
          [&](int m, int k) { return a_s[m * (kChunk + 1) + k]; },
          [&](int n, int k) {
            return o0 + n < co ? to_f32(w2[(int64_t)(o0 + n) * hid + j0 + k])
                               : 0.f;
          },
          As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (o0 + mt.tn + j < co)
            acc[(mt.tm + i) * co + o0 + mt.tn + j] += o[i][j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTileRows * co; e += kMlpThreads) {
    const int m = e / co, oc = e % co;
    if (row0 + m < rows) out[(row0 + m) * co + oc] = from_f32<T>(acc[e] + b2[oc]);
  }
}

// -------------------------------------------------------------- backward
// dx per 64-row tile. Dynamic shared memory: acc (64 x c), dh (64 x 65).
template <typename T>
__global__ void __launch_bounds__(kMlpThreads)
mlp_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const T* __restrict__ g, T* __restrict__ dx, int rows,
                  int c, int hid, int co) {
  extern __shared__ float smem[];
  float* acc = smem;
  float* dh_s = acc + kTileRows * c;
  __shared__ float As[kStage], Bs[kStage];
  const int64_t row0 = (int64_t)blockIdx.x * kTileRows;
  const Micro<64, 64, 4, 4> mt;
  for (int e = threadIdx.x; e < kTileRows * c; e += kMlpThreads) acc[e] = 0.f;
  auto xa = [&](int m, int k) {
    return row0 + m < rows ? to_f32(x[(row0 + m) * c + k]) : 0.f;
  };
  auto ga = [&](int m, int k) {
    return row0 + m < rows ? to_f32(g[(row0 + m) * co + k]) : 0.f;
  };
  for (int j0 = 0; j0 < hid; j0 += kChunk) {
    float h[4][4] = {}, da[4][4] = {};
    tile_gemm<64, 64, 4, 4, false, false>(
        h, c, xa,
        [&](int n, int k) {
          return j0 + n < hid ? to_f32(w1[(int64_t)(j0 + n) * c + k]) : 0.f;
        },
        As, Bs);
    // da[m][n] = sum_o g[m][o] W2[o][j0 + n]
    tile_gemm<64, 64, 4, 4, false, true>(
        da, co, ga,
        [&](int n, int k) {
          return j0 + n < hid ? to_f32(w2[(int64_t)k * hid + j0 + n]) : 0.f;
        },
        As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jn = j0 + mt.tn + j;
        dh_s[(mt.tm + i) * (kChunk + 1) + mt.tn + j] =
            jn < hid ? round_to<T>(da[i][j] * gelu_grad(h[i][j] + b1[jn]))
                     : 0.f;
      }
    __syncthreads();
    // dx[m][cc] += sum_n dh[m][n] W1[j0 + n][cc]
    for (int c0 = 0; c0 < c; c0 += 64) {
      float t[4][4] = {};
      tile_gemm<64, 64, 4, 4, false, true>(
          t, min(kChunk, hid - j0),
          [&](int m, int k) { return dh_s[m * (kChunk + 1) + k]; },
          [&](int n, int k) {
            return c0 + n < c ? to_f32(w1[(int64_t)(j0 + k) * c + c0 + n])
                              : 0.f;
          },
          As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + mt.tn + j < c) acc[(mt.tm + i) * c + c0 + mt.tn + j] += t[i][j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTileRows * c; e += kMlpThreads) {
    const int m = e / c, cc = e % c;
    if (row0 + m < rows) dx[(row0 + m) * c + cc] = from_f32<T>(acc[e]);
  }
}

// dW1, db1, dW2, db2 per 32-wide hidden chunk (blockIdx.x) and split of
// rows (blockIdx.y). Dynamic shared memory: acc1 (32 x c), acc2 (co x 32),
// a (64 x 33), dh (64 x 33), db1 (32), db2 (co).
template <typename T>
__global__ void __launch_bounds__(kMlpThreads)
mlp_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const T* __restrict__ g, float* __restrict__ dw1,
                  float* __restrict__ db1, float* __restrict__ dw2,
                  float* __restrict__ db2, int rows, int c, int hid, int co,
                  int rows_per_split) {
  constexpr int HC = kDwChunk;
  extern __shared__ float smem[];
  float* acc1 = smem;                    // [HC][c]
  float* acc2 = acc1 + HC * c;           // [co][HC]
  float* a_s = acc2 + co * HC;           // [64][HC + 1]
  float* dh_s = a_s + kTileRows * (HC + 1);
  float* db1_s = dh_s + kTileRows * (HC + 1);
  float* db2_s = db1_s + HC;
  __shared__ float As[kStage], Bs[kStage];
  const int j0 = blockIdx.x * HC;
  const int64_t r_begin = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r_end = r_begin + rows_per_split < rows
                            ? r_begin + rows_per_split : rows;
  const bool first_chunk = blockIdx.x == 0;
  const int tid = threadIdx.x;
  const Micro<64, HC, 4, 2> mt;
  for (int e = tid; e < HC * c + co * HC; e += kMlpThreads) acc1[e] = 0.f;
  for (int e = tid; e < HC + co; e += kMlpThreads) db1_s[e] = 0.f;
  for (int64_t row0 = r_begin; row0 < r_end; row0 += kTileRows) {
    const int nrows = r_end - row0 < kTileRows ? (int)(r_end - row0)
                                                : kTileRows;
    float h[4][2] = {}, da[4][2] = {};
    tile_gemm<64, HC, 4, 2, false, false>(
        h, c,
        [&](int m, int k) {
          return m < nrows ? to_f32(x[(row0 + m) * c + k]) : 0.f;
        },
        [&](int n, int k) {
          return j0 + n < hid ? to_f32(w1[(int64_t)(j0 + n) * c + k]) : 0.f;
        },
        As, Bs);
    tile_gemm<64, HC, 4, 2, false, true>(
        da, co,
        [&](int m, int k) {
          return m < nrows ? to_f32(g[(row0 + m) * co + k]) : 0.f;
        },
        [&](int n, int k) {
          return j0 + n < hid ? to_f32(w2[(int64_t)k * hid + j0 + n]) : 0.f;
        },
        As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = mt.tm + i, n = mt.tn + j;
        float av = 0.f, dv = 0.f;
        if (m < nrows && j0 + n < hid) {
          const float hv = h[i][j] + b1[j0 + n];
          av = round_to<T>(gelu(hv));
          dv = round_to<T>(da[i][j] * gelu_grad(hv));
        }
        a_s[m * (HC + 1) + n] = av;
        dh_s[m * (HC + 1) + n] = dv;
      }
    __syncthreads();
    if (tid < HC) {
      float s = 0.f;
      for (int m = 0; m < nrows; ++m) s += dh_s[m * (HC + 1) + tid];
      db1_s[tid] += s;
    }
    if (first_chunk) {
      for (int o = tid; o < co; o += kMlpThreads) {
        float s = 0.f;
        for (int m = 0; m < nrows; ++m) s += to_f32(g[(row0 + m) * co + o]);
        db2_s[o] += s;
      }
    }
    // dW2[o][j0 + n] += sum_m g[m][o] a[m][n]
    for (int o0 = 0; o0 < co; o0 += 64) {
      float t[4][2] = {};
      tile_gemm<64, HC, 4, 2, true, true>(
          t, nrows,
          [&](int o, int k) {
            return o0 + o < co ? to_f32(g[(row0 + k) * co + o0 + o]) : 0.f;
          },
          [&](int n, int k) { return a_s[k * (HC + 1) + n]; }, As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (o0 + mt.tm + i < co)
            acc2[(o0 + mt.tm + i) * HC + mt.tn + j] += t[i][j];
    }
    // dW1[j0 + n][cc] += sum_m dh[m][n] x[m][cc]
    const Micro<HC, 64, 2, 4> mw;
    for (int c0 = 0; c0 < c; c0 += 64) {
      float t[2][4] = {};
      tile_gemm<HC, 64, 2, 4, true, true>(
          t, nrows, [&](int n, int k) { return dh_s[k * (HC + 1) + n]; },
          [&](int cc, int k) {
            return c0 + cc < c ? to_f32(x[(row0 + k) * c + c0 + cc]) : 0.f;
          },
          As, Bs);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + mw.tn + j < c)
            acc1[(mw.tm + i) * c + c0 + mw.tn + j] += t[i][j];
    }
    __syncthreads();
  }
  for (int e = tid; e < HC * c; e += kMlpThreads) {
    const int n = e / c, cc = e % c;
    if (j0 + n < hid) atomicAdd(dw1 + (int64_t)(j0 + n) * c + cc, acc1[e]);
  }
  for (int e = tid; e < co * HC; e += kMlpThreads) {
    const int o = e / HC, n = e % HC;
    if (j0 + n < hid) atomicAdd(dw2 + (int64_t)o * hid + j0 + n, acc2[e]);
  }
  if (tid < HC && j0 + tid < hid) atomicAdd(db1 + j0 + tid, db1_s[tid]);
  if (first_chunk)
    for (int o = tid; o < co; o += kMlpThreads) atomicAdd(db2 + o, db2_s[o]);
}

inline size_t fwd_smem(int co) {
  return sizeof(float) * ((size_t)kTileRows * co + kTileRows * (kChunk + 1));
}

inline size_t dw_smem(int c, int co) {
  return sizeof(float) *
         ((size_t)kDwChunk * c + (size_t)co * kDwChunk +
          2 * kTileRows * (kDwChunk + 1) + kDwChunk + co);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch_fwd(const void* x, const void* w1, const float* b1, const void* w2,
               const float* b2, void* out, int rows, int c, int hid, int co,
               cudaStream_t stream) {
  const size_t smem = fwd_smem(co);
  cudaError_t err = allow_smem(mlp_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + kTileRows - 1) / kTileRows;
  mlp_fwd_kernel<T><<<blocks, kMlpThreads, smem, stream>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, b2, (T*)out, rows, c, hid,
      co);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* w1, const float* b1, const void* w2,
               const void* g, void* dx, float* dw1, float* db1, float* dw2,
               float* db2, int rows, int c, int hid, int co,
               cudaStream_t stream) {
  const size_t smem_dx = fwd_smem(c);
  cudaError_t err = allow_smem(mlp_bwd_dx_kernel<T>, smem_dx);
  if (err != cudaSuccess) return err;
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  mlp_bwd_dx_kernel<T><<<tiles, kMlpThreads, smem_dx, stream>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, (const T*)g, (T*)dx, rows,
      c, hid, co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int chunks = (hid + kDwChunk - 1) / kDwChunk;
  const int splits =
      std::max(1, std::min(tiles, (2 * sms + chunks - 1) / chunks));
  const int rows_per_split =
      ((tiles + splits - 1) / splits) * kTileRows;  // whole tiles
  const int used = (rows + rows_per_split - 1) / rows_per_split;
  const size_t smem_dw = dw_smem(c, co);
  err = allow_smem(mlp_bwd_dw_kernel<T>, smem_dw);
  if (err != cudaSuccess) return err;
  mlp_bwd_dw_kernel<T><<<dim3(chunks, used), kMlpThreads, smem_dw,
                         stream>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, (const T*)g, dw1, db1, dw2,
      db2, rows, c, hid, co, rows_per_split);
  return cudaGetLastError();
}

}  // namespace swindet

// x (rows, c), w1 (hid, c), w2 (co, hid) of dtype (0 fp32, 1 bf16), b1
// (hid,) and b2 (co,) fp32; out (rows, co) of dtype.
SWINDET_EXPORT int swindet_fused_mlp(const void* x, const void* w1,
                                     const float* b1, const void* w2,
                                     const float* b2, void* out, int rows,
                                     int c, int hid, int co, int dtype,
                                     cudaStream_t stream) {
  using namespace swindet;
  if (rows == 0) return cudaGetLastError();
  return dtype == kBFloat16
             ? launch_fwd<__nv_bfloat16>(x, w1, b1, w2, b2, out, rows, c, hid,
                                         co, stream)
             : launch_fwd<float>(x, w1, b1, w2, b2, out, rows, c, hid, co,
                                 stream);
}

// g (rows, co) of dtype; dx (rows, c) of dtype; dw1 (hid, c), db1 (hid,),
// dw2 (co, hid), db2 (co,) fp32 and zeroed by the caller.
SWINDET_EXPORT int swindet_fused_mlp_bwd(const void* x, const void* w1,
                                         const float* b1, const void* w2,
                                         const void* g, void* dx, float* dw1,
                                         float* db1, float* dw2, float* db2,
                                         int rows, int c, int hid, int co,
                                         int dtype, cudaStream_t stream) {
  using namespace swindet;
  if (rows == 0) return cudaGetLastError();
  return dtype == kBFloat16
             ? launch_bwd<__nv_bfloat16>(x, w1, b1, w2, g, dx, dw1, db1, dw2,
                                         db2, rows, c, hid, co, stream)
             : launch_bwd<float>(x, w1, b1, w2, g, dx, dw1, db1, dw2, db2,
                                 rows, c, hid, co, stream);
}
