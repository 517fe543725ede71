// Fused token MLP of the Swin blocks, over rows of tokens:
//   h   = x W1^T + b1          (fp32 accumulation, fp32 bias)
//   a   = GELU(h), rounded to x's type
//   out = a W2^T + b2          (fp32 accumulation, cast to x's type)
// and its backward, after _mlp_bwd_kernel (:115-149), recomputing h:
//   dW2 = g^T round(a), db2 = sum g          (g, a in x's type; fp32 sums)
//   da = g W2, dh = round(da * GELU'(h))      (rounded to x's type)
//   dW1 = dh^T x, db1 = sum dh, dx = dh W1    (fp32 sums; dx cast)
// x (R, C), W1 (H, C), W2 (Co, H) in x's type (nn.Linear layout), biases
// fp32. GELU is exact-erf with XLA's fp32 rational erf, as the TPU kernel
// evaluates it (swindet_tpu/ops/fused_mlp.py:28-50).
//
// Replaces: swindet_tpu/ops/fused_mlp.py · _mlp_kernel (:78, via
// _mlp_fwd_impl, pallas_call at :95) with the forward kernels, and
// · _mlp_bwd_kernel (:115, via _mlp_bwd_impl, pallas_call at :161) with
// the dx and weight-gradient kernels; the SWINDET_FUSED_MLP=1
// configuration of stages 1-3 of Swin-T: (R, C, H) = (67,200, 96, 384),
// (16,800, 192, 768), (4,200, 384, 1,536) per 800x1344 image.
//
// Bound: operations, at every stage. A row costs 4 C H = 16 C^2 flops in
// the forward (40 C^2 in the backward) for 2 C bf16 elements in and out:
// 384 flops a byte at stage 1, 768 at stage 2 and 1,536 at stage 3 in the
// forward, above the card's ridge (~295). The point of fusing is that
// the (R, H) hidden, the largest activation of the block, never goes to
// device memory. The TPU kept a row block's whole hidden and both weights
// in VMEM; here a block holds 64-row tiles and loops over the hidden in
// 64-wide chunks.
//
// bf16: tensor cores (mlp_fwd_tc_kernel, mlp_bwd_dx_tc_kernel,
// mlp_bwd_dw_tc_kernel). Every product is a wgmma m64n64k16 on 64 x 64
// boxes of bf16 in 128-byte swizzled rows, as TMA leaves them (zero fill
// past C, H, Co or the rows). A producer warp streams the boxes a block
// does not keep through a 4-slot ring guarded by full / empty mbarriers;
// one wgmma group stays in flight while the next is issued.
//   Forward: one or two consumer warpgroups, each owning a 64-row tile of
//   x (resident), share each weight box. Per hidden chunk, h = x W1c^T
//   into registers, then + b1, GELU and the bf16 rounding in registers,
//   and the packed values are the A operand of out += a W2c^T (wgmma with
//   A from registers, as FlashAttention-3 feeds P): the hidden never
//   leaves the registers. The fp32 output accumulator takes 32 registers
//   a box, so a block owns two or three boxes of output columns (two
//   consumers and the producer warp are held to 168 registers a thread)
//   and recomputes h for each column tile: twice at stage 3, never at
//   stages 1-2.
//   dx: as the forward, with g resident beside x; per hidden chunk h and
//   da = g W2c (W2 boxes MN-major, through wgmma's transpose bit), dh in
//   registers as the A operand of dx += dh W1c (W1 boxes MN-major). No
//   atomics: dx is deterministic.
//   Weight gradients: a block owns one hidden chunk, with its W1 and W2
//   boxes resident, and a split of up to 16 row tiles. Per row tile, h and
//   da from the streamed x and g boxes, then a and dh, rounded, into
//   shared memory in the swizzled layout (and dh's column sums, db1); then
//   per 64-wide box of C and of Co, dW1c = dh^T x and dW2c = g^T a over the
//   split's rows with both operands MN-major, added to the zeroed fp32
//   outputs by one float2 atomic per entry pair. The order of those
//   atomics varies from run to run, so the weight gradients vary in their
//   last bits. db2, the column sums of g, comes from the blocks of chunk 0.
//   What bounds them: the GELU (and GELU') of every hidden value runs on
//   the CUDA cores, about 20-60 instructions against 2 C (forward) or
//   6 C (backward) tensor-core flops, so at stage 1 (C = 96) the CUDA
//   cores set the pace; erf_xla<true> takes the approximate division and
//   exponential there. Two consumers a block halve the weight boxes read
//   from L2 per row where there are enough row tiles to fill the card.
// TMA needs a 16-byte aligned base and strides that are multiples of 16
// bytes, so the bf16 kernels take C, H and Co in multiples of 8.
//
// fp32: the first SIMT kernels (mlp_fwd_kernel, mlp_bwd_dx_kernel,
// mlp_bwd_dw_kernel), kept for fp32 inputs, which the fp32 card-vs-CPU
// checks run (tensor cores in TF32 could not meet their 2e-6). A block
// holds a 64-row tile; each chunk's h is computed by 4 x 4 register tiles
// of fp32 FMAs with K staged through shared memory 16 deep (tile_gemm.cuh),
// GELU'd and staged in shared memory, and multiplied into an fp32 output
// accumulator in shared memory (64 x Co). The backward is mlp_bwd_dx_kernel
// per 64-row tile (no atomics) and mlp_bwd_dw_kernel per 32-wide hidden
// chunk and split of the rows, one fp32 atomicAdd per entry.
#include <algorithm>

#include "sm90.cuh"
#include "tile_gemm.cuh"

namespace swindet {

constexpr int kMlpThreads = kGemmThreads;
constexpr int kTileRows = 64;
constexpr int kChunk = 64;   // hidden chunk of the forward and of dx
constexpr int kDwChunk = 32; // hidden chunk of the weight gradients

// XLA's fp32 erf (ErfImpl32): x P(x^2) / Q(x^2) on x clamped to
// +-erfinv(1 - 2^-23). kFast (the bf16 tensor-core kernels, whose GELU
// runs on the CUDA cores beside the tensor cores and sets their pace at
// stage 1) takes the hardware's approximate division and exponential
// (__fdividef, __expf: a few ulps), which move a value that is then
// rounded to bf16 as rarely as another summation order does; the fp32
// kernels keep the IEEE operations.
template <bool kFast = false>
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
  return kFast ? __fdividef(x * p, q) : (x * p) / q;
}

template <bool kFast = false>
__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.0f + erf_xla<kFast>(h * 0.7071067811865476f));
}

template <bool kFast = false>
__device__ __forceinline__ float gelu_grad(float h) {
  const float cdf = 0.5f * (1.0f + erf_xla<kFast>(h * 0.7071067811865476f));
  const float pdf =
      0.3989422804014327f * (kFast ? __expf(-0.5f * h * h) : expf(-0.5f * h * h));
  return cdf + h * pdf;
}

// gelu<true>(h) and gelu_grad<true>(h) from one erf
__device__ __forceinline__ void gelu_and_grad(float h, float& a, float& d) {
  const float cdf = 0.5f * (1.0f + erf_xla<true>(h * 0.7071067811865476f));
  a = h * cdf;  // 0.5 h (1 + erf): the factor 0.5 scales exactly
  d = cdf + h * (0.3989422804014327f * __expf(-0.5f * h * h));
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


// ------------------------------------------------- bf16, tensor cores
namespace tc {

// A block is kConsumers warpgroups (threads 0 .. 128 kConsumers - 1) that
// run the wgmma, and one producer warp whose first thread issues every TMA
// load.
template <int kConsumers>
__host__ __device__ constexpr int threads() { return 128 * kConsumers + 32; }
constexpr int kBox = 64;        // a box: 64 x 64 bf16 in 128-byte swizzled rows
constexpr int kBoxBytes = kBox * kBox * 2;  // 8 KB
// Output columns of a row block, in boxes: two consumers and the producer
// warp are held to 168 registers a thread (registers are granted by four
// warps), which fit two boxes of fp32 accumulators beside h, da and the
// A registers; one consumer has up to 255, which fit three.
template <int kConsumers>
__host__ __device__ constexpr int tile_boxes() {
  return kConsumers == 2 ? 2 : 3;
}
// A block of two consumers halves the weight boxes read from L2 per row,
// but a grid of them fills the card only with many row tiles: two when a
// one-consumer grid has at least this many blocks an SM
constexpr int kTwoConsumerBlocksPerSm = 6;
constexpr int kMaxSlots = 4;    // boxes in flight between producer and consumer
constexpr int kMaxRowTiles = 16;  // 64-row tiles of a weight-gradient block
// shared memory a block may take, less the 1024-byte alignment of the
// boxes and the static barriers
constexpr int kSmemAvail = 232448 - 1024 - 256;

struct Shape {
  int rows, c, hid, co;
  int c_boxes, co_boxes, chunks;  // 64-wide boxes of C and Co, of H
};

inline Shape make_shape(int rows, int c, int hid, int co) {
  return Shape{rows, c, hid, co, (c + kBox - 1) / kBox, (co + kBox - 1) / kBox,
               (hid + kBox - 1) / kBox};
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = sm90::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// wgmma descriptors of k16 step k of a box: K-major (K along the 128-byte
// rows, 32 bytes a step) or MN-major (K down the rows, 16 rows a step)
__device__ __forceinline__ uint64_t kmajor(uint32_t box, int k) {
  return sm90::gmma_desc(box + 32 * k, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t box, int k) {
  return sm90::gmma_desc(box + 16 * kBox * 2 * k, kBoxBytes, 1024);
}

// Fragment of a 64 x 64 fp32 wgmma accumulator: value i of this thread sits
// in row warp * 16 + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (lane % 4) + i % 2. Values i and i + 1 (i even) are one row's column
// pair.
__device__ __forceinline__ int frag_row(int i) {
  return (threadIdx.x % 128 / 32) * 16 + (threadIdx.x % 32) / 4 +
         8 * ((i / 2) % 2);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A ring of `n` box slots from the producer thread to the consumer
// warpgroups, each of which reads every box. full[i] completes when slot
// i's box has landed, empty[i] when the wgmma of every consumer that read
// it has completed. One wgmma group stays in flight while the next is
// issued: a slot is freed once the group after its own has been committed
// and its own has completed.
struct Ring {
  uint8_t* slots;
  uint64_t* full;
  uint64_t* empty;
  int n, slot;
  uint32_t phase;
  int pending;  // the slot of the group that may still be in flight, or -1

  __device__ void advance() {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
  // producer: the box of `map` at (c0, c1) into the next slot
  __device__ void put(const CUtensorMap* map, int c0, int c1) {
    sm90::mbar_wait(&empty[slot], phase ^ 1);
    sm90::mbar_expect_tx(&full[slot], kBoxBytes);
    sm90::tma_load_2d(slots + slot * kBoxBytes, map, &full[slot], c0, c1);
    advance();
  }
  // consumer: the next slot's shared address once its box has landed;
  // then the wgmma reading it is fenced
  __device__ uint32_t take() {
    sm90::mbar_wait(&full[slot], phase);
    sm90::wgmma_fence();
    return sm90::smem_u32(slots + slot * kBoxBytes);
  }
  __device__ void free_pending() {
    if (pending >= 0 && threadIdx.x % 128 == 0)
      sm90::mbar_arrive(&empty[pending]);
    pending = -1;
  }
  // consumer: commit the wgmma issued since take(), and free the slot of
  // the group before it once that has completed
  __device__ void release() {
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    free_pending();
    pending = slot;
    advance();
  }
  // consumer: complete every wgmma in flight (before its accumulator or
  // register operand is touched) and free its slot
  __device__ void drain() {
    sm90::wgmma_wait<0>();
    free_pending();
  }
};

// Barriers of a block: the ring's, and `resident` for the boxes loaded
// once. Returns the ring over `slots` slots at `base`, read by
// `consumers` warpgroups.
__device__ __forceinline__ Ring init_ring(uint8_t* base, uint64_t* full,
                                         uint64_t* empty, uint64_t* resident,
                                         int slots, int consumers) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      sm90::mbar_init(&full[i], 1);  // the producer's expect_tx
      sm90::mbar_init(&empty[i], consumers);  // each consumer's release
    }
    sm90::mbar_init(resident, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  return Ring{base, full, empty, slots, 0, 0, -1};
}

// h (64 rows x hidden chunk j) = A (64 x C) W1c^T: A the resident K-major
// boxes at `a`, the W1 boxes from the ring
__device__ __forceinline__ void hidden(float (&h)[32], Ring& ring, uint32_t a,
                                       int boxes) {
  for (int kb = 0; kb < boxes; ++kb) {
    const uint32_t b = ring.take();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sm90::wgmma_m64n64k16<0, 0>(h, kmajor(a + kb * kBoxBytes, k),
                                  kmajor(b, k), kb > 0 || k > 0);
    ring.release();
  }
  ring.drain();
}

// da (64 rows x hidden chunk) = g (64 x Co) W2c, g in K-major boxes and
// W2c in MN-major ones (Co rows, hidden columns): with kGResident the g
// boxes are resident at `res` and the W2 boxes come from the ring, else
// the W2 boxes are resident at `res` and the g boxes come from the ring
template <bool kGResident>
__device__ __forceinline__ void grad_hidden(float (&da)[32], Ring& ring,
                                            uint32_t res, int boxes) {
  for (int ob = 0; ob < boxes; ++ob) {
    const uint32_t box = ring.take();
    const uint32_t ga = kGResident ? res + ob * kBoxBytes : box;
    const uint32_t b = kGResident ? box : res + ob * kBoxBytes;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sm90::wgmma_m64n64k16<0, 1>(da, kmajor(ga, k), mnmajor(b, k),
                                  ob > 0 || k > 0);
    ring.release();
  }
  ring.drain();
}

// Forward of kConsumers 64-row tiles (blockIdx.x; one a consumer, which
// share every weight box) and two 64-wide boxes of the output columns
// (blockIdx.y): out = GELU(x W1^T + b1) W2^T + b2.
template <int kConsumers>
__global__ void __launch_bounds__(threads<kConsumers>(), 1)
mlp_fwd_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap w1map,
                  const __grid_constant__ CUtensorMap w2map,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  __nv_bfloat16* __restrict__ out, Shape s, int slots) {
  constexpr int kProducer = 128 * kConsumers;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxSlots], empty[kMaxSlots], res;
  // each consumer's x, s.c_boxes boxes
  uint8_t* xs = align_1024(smem_raw);
  Ring ring = init_ring(xs + kConsumers * s.c_boxes * kBoxBytes, full,
                        empty, &res, slots, kConsumers);
  const int wg = threadIdx.x / 128;
  const int row0 = (blockIdx.x * kConsumers + wg) * kBox;
  constexpr int kTileBoxes = tile_boxes<kConsumers>();
  const int ob0 = blockIdx.y * kTileBoxes;
  const int nb = min(kTileBoxes, s.co_boxes - ob0);

  if (threadIdx.x == kProducer) {
    sm90::mbar_expect_tx(&res, kConsumers * s.c_boxes * kBoxBytes);
    for (int c = 0; c < kConsumers; ++c)
      for (int kb = 0; kb < s.c_boxes; ++kb)
        sm90::tma_load_2d(xs + (c * s.c_boxes + kb) * kBoxBytes, &xmap, &res,
                          kb * kBox, (blockIdx.x * kConsumers + c) * kBox);
    for (int j = 0; j < s.chunks; ++j) {
      for (int kb = 0; kb < s.c_boxes; ++kb)
        ring.put(&w1map, kb * kBox, j * kBox);
      for (int ob = 0; ob < nb; ++ob)
        ring.put(&w2map, j * kBox, (ob0 + ob) * kBox);
    }
  } else if (threadIdx.x < kProducer) {
    sm90::mbar_wait(&res, 0);
    const uint32_t xa = sm90::smem_u32(xs + wg * s.c_boxes * kBoxBytes);
    float o[kTileBoxes][32];  // the first chunk's wgmma overwrites it
    for (int j = 0; j < s.chunks; ++j) {
      float h[32];
      hidden(h, ring, xa, s.c_boxes);
      // a = GELU(h + b1) rounded to bf16, packed as wgmma's A registers
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int n = j * kBox + frag_col(i);
        a[i / 8][(i % 8) / 2] =
            n < s.hid ? pack_bf16(gelu<true>(h[i] + b1[n]),
                                  gelu<true>(h[i + 1] + b1[n + 1]))
                      : 0u;
      }
#pragma unroll
      for (int ob = 0; ob < kTileBoxes; ++ob) {
        if (ob < nb) {
          const uint32_t b = ring.take();
#pragma unroll
          for (int k = 0; k < 4; ++k)
            sm90::wgmma_m64n64k16_rs<0>(o[ob], a[k], kmajor(b, k),
                                        j > 0 || k > 0);
          ring.release();
        }
      }
    }
    ring.drain();
#pragma unroll
    for (int ob = 0; ob < kTileBoxes; ++ob) {
      if (ob >= nb) continue;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = row0 + frag_row(i), n = (ob0 + ob) * kBox + frag_col(i);
        if (r < s.rows && n < s.co)
          *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)r * s.co + n) =
              __floats2bfloat162_rn(o[ob][i] + b2[n], o[ob][i + 1] + b2[n + 1]);
      }
    }
  }
}

// dx of kConsumers 64-row tiles (blockIdx.x; one a consumer, which share
// every weight box) and two 64-wide boxes of its columns (blockIdx.y):
// dx = dh W1, dh = round(g W2 * GELU'(x W1^T + b1)), over every hidden
// chunk in this block; no atomics, so dx is deterministic.
template <int kConsumers>
__global__ void __launch_bounds__(threads<kConsumers>(), 1)
mlp_bwd_dx_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap w1map,
                     const __grid_constant__ CUtensorMap w2map,
                     const float* __restrict__ b1,
                     __nv_bfloat16* __restrict__ dx, Shape s, int slots) {
  constexpr int kProducer = 128 * kConsumers;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxSlots], empty[kMaxSlots], res;
  // each consumer's s.c_boxes boxes of x, then s.co_boxes boxes of g
  const int own = s.c_boxes + s.co_boxes;
  uint8_t* xs = align_1024(smem_raw);
  Ring ring = init_ring(xs + kConsumers * own * kBoxBytes, full, empty, &res,
                        slots, kConsumers);
  const int wg = threadIdx.x / 128;
  const int row0 = (blockIdx.x * kConsumers + wg) * kBox;
  constexpr int kTileBoxes = tile_boxes<kConsumers>();
  const int cb0 = blockIdx.y * kTileBoxes;
  const int nb = min(kTileBoxes, s.c_boxes - cb0);

  if (threadIdx.x == kProducer) {
    sm90::mbar_expect_tx(&res, kConsumers * own * kBoxBytes);
    for (int c = 0; c < kConsumers; ++c) {
      uint8_t* mine = xs + c * own * kBoxBytes;
      const int r = (blockIdx.x * kConsumers + c) * kBox;
      for (int kb = 0; kb < s.c_boxes; ++kb)
        sm90::tma_load_2d(mine + kb * kBoxBytes, &xmap, &res, kb * kBox, r);
      for (int ob = 0; ob < s.co_boxes; ++ob)
        sm90::tma_load_2d(mine + (s.c_boxes + ob) * kBoxBytes, &gmap, &res,
                          ob * kBox, r);
    }
    for (int j = 0; j < s.chunks; ++j) {
      for (int kb = 0; kb < s.c_boxes; ++kb)
        ring.put(&w1map, kb * kBox, j * kBox);
      for (int ob = 0; ob < s.co_boxes; ++ob)
        ring.put(&w2map, j * kBox, ob * kBox);
      for (int cb = 0; cb < nb; ++cb)
        ring.put(&w1map, (cb0 + cb) * kBox, j * kBox);
    }
  } else if (threadIdx.x < kProducer) {
    sm90::mbar_wait(&res, 0);
    float acc[kTileBoxes][32];  // the first chunk's wgmma overwrites it
    for (int j = 0; j < s.chunks; ++j) {
      float h[32], da[32];
      const uint32_t mine = sm90::smem_u32(xs + wg * own * kBoxBytes);
      hidden(h, ring, mine, s.c_boxes);
      grad_hidden<true>(da, ring, mine + s.c_boxes * kBoxBytes, s.co_boxes);
      uint32_t dh[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int n = j * kBox + frag_col(i);
        dh[i / 8][(i % 8) / 2] =
            n < s.hid
                ? pack_bf16(da[i] * gelu_grad<true>(h[i] + b1[n]),
                            da[i + 1] * gelu_grad<true>(h[i + 1] + b1[n + 1]))
                : 0u;
      }
      // dx += dh W1c: the W1 boxes (hidden rows, C columns) are MN-major
#pragma unroll
      for (int cb = 0; cb < kTileBoxes; ++cb) {
        if (cb < nb) {
          const uint32_t b = ring.take();
#pragma unroll
          for (int k = 0; k < 4; ++k)
            sm90::wgmma_m64n64k16_rs<1>(acc[cb], dh[k], mnmajor(b, k),
                                        j > 0 || k > 0);
          ring.release();
        }
      }
    }
    ring.drain();
#pragma unroll
    for (int cb = 0; cb < kTileBoxes; ++cb) {
      if (cb >= nb) continue;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = row0 + frag_row(i), n = (cb0 + cb) * kBox + frag_col(i);
        if (r < s.rows && n < s.c)
          *reinterpret_cast<__nv_bfloat162*>(dx + (int64_t)r * s.c + n) =
              __floats2bfloat162_rn(acc[cb][i], acc[cb][i + 1]);
      }
    }
  }
}

// Weight gradients of hidden chunk j (blockIdx.x) over a split of up to
// kMaxRowTiles 64-row tiles (blockIdx.y). Phase 1, per row tile: h and da
// from the x and g boxes against the chunk's W1 and W2 boxes (resident),
// then a and dh, rounded to bf16, into shared memory in the 128-byte
// swizzled layout a TMA box has, and dh's column sums (db1). Phase 2, per
// 64-wide box of C and of Co: dW1c = dh^T x and dW2c = g^T a over the
// split's rows, both operands MN-major, added to the zeroed fp32 outputs
// by one atomic per entry. db2, the column sums of g, comes from the
// blocks of chunk 0.
__global__ void __launch_bounds__(threads<1>(), 1)
mlp_bwd_dw_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap w1map,
                     const __grid_constant__ CUtensorMap w2map,
                     const float* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ g,
                     float* __restrict__ dw1, float* __restrict__ db1,
                     float* __restrict__ dw2, float* __restrict__ db2,
                     Shape s, int row_tiles, int slots) {
  constexpr int kProducer = 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxSlots], empty[kMaxSlots], res;
  uint8_t* w1s = align_1024(smem_raw);               // s.c_boxes boxes
  uint8_t* w2s = w1s + s.c_boxes * kBoxBytes;         // s.co_boxes boxes
  uint8_t* as = w2s + s.co_boxes * kBoxBytes;         // row_tiles boxes of a
  uint8_t* dhs = as + row_tiles * kBoxBytes;          // and of dh
  Ring ring = init_ring(dhs + row_tiles * kBoxBytes, full, empty, &res,
                        slots, 1);
  const int j0 = blockIdx.x * kBox;
  const int first = blockIdx.y * row_tiles;           // first row tile
  const int nt = min(row_tiles, (s.rows + kBox - 1) / kBox - first);

  if (threadIdx.x == kProducer) {
    sm90::mbar_expect_tx(&res, (s.c_boxes + s.co_boxes) * kBoxBytes);
    for (int kb = 0; kb < s.c_boxes; ++kb)
      sm90::tma_load_2d(w1s + kb * kBoxBytes, &w1map, &res, kb * kBox, j0);
    for (int ob = 0; ob < s.co_boxes; ++ob)
      sm90::tma_load_2d(w2s + ob * kBoxBytes, &w2map, &res, j0, ob * kBox);
    for (int t = 0; t < nt; ++t) {
      for (int kb = 0; kb < s.c_boxes; ++kb)
        ring.put(&xmap, kb * kBox, (first + t) * kBox);
      for (int ob = 0; ob < s.co_boxes; ++ob)
        ring.put(&gmap, ob * kBox, (first + t) * kBox);
    }
    for (int cb = 0; cb < s.c_boxes; ++cb)
      for (int t = 0; t < nt; ++t)
        ring.put(&xmap, cb * kBox, (first + t) * kBox);
    for (int ob = 0; ob < s.co_boxes; ++ob)
      for (int t = 0; t < nt; ++t)
        ring.put(&gmap, ob * kBox, (first + t) * kBox);
  } else if (threadIdx.x < kProducer) {
    sm90::mbar_wait(&res, 0);
    const uint32_t w1a = sm90::smem_u32(w1s), w2a = sm90::smem_u32(w2s);
    float db1p[16] = {};  // this thread's column sums of dh
    for (int t = 0; t < nt; ++t) {
      float h[32], da[32];
      // h from the x boxes (ring) against the resident W1 boxes
      for (int kb = 0; kb < s.c_boxes; ++kb) {
        const uint32_t xa = ring.take();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sm90::wgmma_m64n64k16<0, 0>(h, kmajor(xa, k),
                                      kmajor(w1a + kb * kBoxBytes, k),
                                      kb > 0 || k > 0);
        ring.release();
      }
      ring.drain();
      grad_hidden<false>(da, ring, w2a, s.co_boxes);
      uint8_t* a_box = as + t * kBoxBytes;
      uint8_t* dh_box = dhs + t * kBoxBytes;
      const int row0 = (first + t) * kBox;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = frag_row(i), n = frag_col(i);
        uint32_t av = 0u, dv = 0u;
        if (row0 + r < s.rows && j0 + n < s.hid) {
          float a0, a1, d0, d1;
          gelu_and_grad(h[i] + b1[j0 + n], a0, d0);
          gelu_and_grad(h[i + 1] + b1[j0 + n + 1], a1, d1);
          av = pack_bf16(a0, a1);
          dv = pack_bf16(da[i] * d0, da[i + 1] * d1);
          const __nv_bfloat162 d2 = *reinterpret_cast<__nv_bfloat162*>(&dv);
          db1p[(i / 4) * 2] += __low2float(d2);
          db1p[(i / 4) * 2 + 1] += __high2float(d2);
        }
        // 128-byte swizzle: 16-byte chunk n / 8 of row r lands at n / 8 ^ r % 8
        const int off = r * 128 + (((n >> 3) ^ (r & 7)) << 4) + (n & 7) * 2;
        *reinterpret_cast<uint32_t*>(a_box + off) = av;
        *reinterpret_cast<uint32_t*>(dh_box + off) = dv;
      }
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1, kProducer);

    // dW1c (hidden rows, C columns) += dh^T x, per 64-wide box of C
    for (int cb = 0; cb < s.c_boxes; ++cb) {
      float acc[32];
      for (int t = 0; t < nt; ++t) {
        const uint32_t xa = ring.take();
        const uint32_t da = sm90::smem_u32(dhs + t * kBoxBytes);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sm90::wgmma_m64n64k16<1, 1>(acc, mnmajor(da, k), mnmajor(xa, k),
                                      t > 0 || k > 0);
        ring.release();
      }
      ring.drain();
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int m = j0 + frag_row(i), n = cb * kBox + frag_col(i);
        if (m < s.hid && n < s.c)
          atomicAdd(reinterpret_cast<float2*>(dw1 + (int64_t)m * s.c + n),
                    make_float2(acc[i], acc[i + 1]));
      }
    }
    // dW2c (Co rows, hidden columns) += g^T a, per 64-wide box of Co
    for (int ob = 0; ob < s.co_boxes; ++ob) {
      float acc[32];
      for (int t = 0; t < nt; ++t) {
        const uint32_t ga = ring.take();
        const uint32_t aa = sm90::smem_u32(as + t * kBoxBytes);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sm90::wgmma_m64n64k16<1, 1>(acc, mnmajor(ga, k), mnmajor(aa, k),
                                      t > 0 || k > 0);
        ring.release();
      }
      ring.drain();
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int m = ob * kBox + frag_row(i), n = j0 + frag_col(i);
        if (m < s.co && n < s.hid)
          atomicAdd(reinterpret_cast<float2*>(dw2 + (int64_t)m * s.hid + n),
                    make_float2(acc[i], acc[i + 1]));
      }
    }
    // db1: this thread's column sums over the lanes of its columns (same
    // lane % 4), then one atomic per column and warp
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      float sum = db1p[v];
      for (int o = 4; o < 32; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const int n = j0 + 8 * (v / 2) + 2 * (threadIdx.x % 4) + v % 2;
      if (threadIdx.x % 32 < 4 && n < s.hid) atomicAdd(db1 + n, sum);
    }
    if (blockIdx.x == 0) {
      const int64_t r_end = min((int64_t)(first + nt) * kBox, (int64_t)s.rows);
      for (int o = threadIdx.x; o < s.co; o += kProducer) {
        float sum = 0.f;
        for (int64_t r = (int64_t)first * kBox; r < r_end; ++r)
          sum += __bfloat162float(g[r * s.co + o]);
        atomicAdd(db2 + o, sum);
      }
    }
  }
}

// 2-D map of a row-major (outer, inner) bf16 matrix in 64 x 64 boxes
inline bool box_map(CUtensorMap* map, const void* p, int outer, int inner) {
  const uint64_t dims[2] = {(uint64_t)inner, (uint64_t)outer};
  const uint32_t box[2] = {kBox, kBox};
  return sm90::bf16_tensor_map(map, p, 2, dims, box);
}

inline bool shape_ok(int c, int hid, int co) {
  return c > 0 && hid > 0 && co > 0 && c % 8 == 0 && hid % 8 == 0 &&
         co % 8 == 0;
}

// ring slots that fit beside `fixed` bytes of shared memory (0 if fewer
// than two)
inline int ring_slots(int fixed) {
  const int n = std::min(kMaxSlots, (kSmemAvail - fixed) / kBoxBytes);
  return n >= 2 ? n : 0;
}

// Whether a row kernel takes two consumers a block: their `resident`
// bytes each fit beside a full ring, and a one-consumer grid over `boxes`
// output boxes would have kTwoConsumerBlocksPerSm blocks an SM or more.
inline bool two_consumers(const Shape& s, int resident, int boxes) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t blocks = (int64_t)((s.rows + kBox - 1) / kBox) *
                         ((boxes + tile_boxes<1>() - 1) / tile_boxes<1>());
  return ring_slots(2 * resident) == kMaxSlots &&
         blocks >= (int64_t)kTwoConsumerBlocksPerSm * sms;
}

// Launch the forward with kConsumers consumer warpgroups a block.
template <int kConsumers>
cudaError_t launch_fwd(const CUtensorMap& xmap, const CUtensorMap& w1map,
                       const CUtensorMap& w2map, const float* b1,
                       const float* b2, void* out, const Shape& s,
                       cudaStream_t stream) {
  const int fixed = kConsumers * s.c_boxes * kBoxBytes;
  const int slots = ring_slots(fixed);
  if (!slots) return cudaErrorInvalidValue;
  const int smem = fixed + slots * kBoxBytes + 1024;
  cudaError_t err = allow_smem(mlp_fwd_tc_kernel<kConsumers>, smem);
  if (err != cudaSuccess) return err;
  const int rows = kConsumers * kBox;
  const dim3 grid((s.rows + rows - 1) / rows,
                  (s.co_boxes + tile_boxes<kConsumers>() - 1) /
                      tile_boxes<kConsumers>());
  mlp_fwd_tc_kernel<kConsumers>
      <<<grid, threads<kConsumers>(), smem, stream>>>(
          xmap, w1map, w2map, b1, b2, static_cast<__nv_bfloat16*>(out), s,
          slots);
  return cudaGetLastError();
}

// Launch the dx kernel with kConsumers consumer warpgroups a block.
template <int kConsumers>
cudaError_t launch_dx(const CUtensorMap& xmap, const CUtensorMap& gmap,
                      const CUtensorMap& w1map, const CUtensorMap& w2map,
                      const float* b1, __nv_bfloat16* dx, const Shape& s,
                      cudaStream_t stream) {
  const int fixed = kConsumers * (s.c_boxes + s.co_boxes) * kBoxBytes;
  const int slots = ring_slots(fixed);
  if (!slots) return cudaErrorInvalidValue;
  const int smem = fixed + slots * kBoxBytes + 1024;
  cudaError_t err = allow_smem(mlp_bwd_dx_tc_kernel<kConsumers>, smem);
  if (err != cudaSuccess) return err;
  const int rows = kConsumers * kBox;
  const dim3 grid((s.rows + rows - 1) / rows,
                  (s.c_boxes + tile_boxes<kConsumers>() - 1) /
                      tile_boxes<kConsumers>());
  mlp_bwd_dx_tc_kernel<kConsumers>
      <<<grid, threads<kConsumers>(), smem, stream>>>(
          xmap, gmap, w1map, w2map, b1, dx, s, slots);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace swindet

// fp32 x (rows, c), w1 (hid, c), w2 (co, hid), b1 (hid,), b2 (co,); out
// (rows, co), on the CUDA cores.
SWINDET_EXPORT int swindet_fused_mlp(const void* x, const void* w1,
                                     const float* b1, const void* w2,
                                     const float* b2, void* out, int rows,
                                     int c, int hid, int co,
                                     cudaStream_t stream) {
  using namespace swindet;
  if (rows == 0) return cudaGetLastError();
  return launch_fwd<float>(x, w1, b1, w2, b2, out, rows, c, hid, co, stream);
}

// fp32 g (rows, co) and dx (rows, c); dw1 (hid, c), db1 (hid,), dw2
// (co, hid), db2 (co,) fp32 and zeroed by the caller; on the CUDA cores.
SWINDET_EXPORT int swindet_fused_mlp_bwd(const void* x, const void* w1,
                                         const float* b1, const void* w2,
                                         const void* g, void* dx, float* dw1,
                                         float* db1, float* dw2, float* db2,
                                         int rows, int c, int hid, int co,
                                         cudaStream_t stream) {
  using namespace swindet;
  if (rows == 0) return cudaGetLastError();
  return launch_bwd<float>(x, w1, b1, w2, g, dx, dw1, db1, dw2, db2, rows, c,
                           hid, co, stream);
}

// bf16 x (rows, c), w1 (hid, c), w2 (co, hid), out (rows, co); fp32 b1
// (hid,), b2 (co,); on the tensor cores. Requires c, hid and co multiples
// of 8 and 16-byte aligned x, w1 and w2; returns cudaErrorInvalidValue
// otherwise.
SWINDET_EXPORT int swindet_fused_mlp_tc(const void* x, const void* w1,
                                        const float* b1, const void* w2,
                                        const float* b2, void* out, int rows,
                                        int c, int hid, int co,
                                        cudaStream_t stream) {
  using namespace swindet;
  if (rows == 0) return cudaGetLastError();
  if (!tc::shape_ok(c, hid, co)) return cudaErrorInvalidValue;
  const tc::Shape s = tc::make_shape(rows, c, hid, co);
  CUtensorMap xmap, w1map, w2map;
  if (!tc::box_map(&xmap, x, rows, c) || !tc::box_map(&w1map, w1, hid, c) ||
      !tc::box_map(&w2map, w2, co, hid))
    return cudaErrorInvalidValue;
  return tc::two_consumers(s, s.c_boxes * tc::kBoxBytes, s.co_boxes)
             ? tc::launch_fwd<2>(xmap, w1map, w2map, b1, b2, out, s, stream)
             : tc::launch_fwd<1>(xmap, w1map, w2map, b1, b2, out, s, stream);
}

// bf16 x, w1, w2 as for swindet_fused_mlp_tc, g (rows, co) and dx
// (rows, c); dw1 (hid, c), db1 (hid,), dw2 (co, hid), db2 (co,) fp32 and
// zeroed by the caller; on the tensor cores, with the requirements of
// swindet_fused_mlp_tc and a 16-byte aligned g.
SWINDET_EXPORT int swindet_fused_mlp_bwd_tc(
    const void* x, const void* w1, const float* b1, const void* w2,
    const void* g, void* dx, float* dw1, float* db1, float* dw2, float* db2,
    int rows, int c, int hid, int co, cudaStream_t stream) {
  using namespace swindet;
  if (rows == 0) return cudaGetLastError();
  if (!tc::shape_ok(c, hid, co)) return cudaErrorInvalidValue;
  const tc::Shape s = tc::make_shape(rows, c, hid, co);
  const int tiles = (rows + tc::kBox - 1) / tc::kBox;
  const int fixed = (s.c_boxes + s.co_boxes) * tc::kBoxBytes;
  // the weight-gradient block keeps an a and a dh box per row tile: as
  // many row tiles as fit beside a full ring (fewer atomics per entry)
  int row_tiles = std::min(tc::kMaxRowTiles, tiles);
  while (row_tiles > 1 && fixed + (2 * row_tiles + tc::kMaxSlots) *
                                      tc::kBoxBytes > tc::kSmemAvail)
    --row_tiles;
  const int slots_dw = tc::ring_slots(fixed + 2 * row_tiles * tc::kBoxBytes);
  CUtensorMap xmap, gmap, w1map, w2map;
  if (!slots_dw || !tc::box_map(&xmap, x, rows, c) ||
      !tc::box_map(&gmap, g, rows, co) || !tc::box_map(&w1map, w1, hid, c) ||
      !tc::box_map(&w2map, w2, co, hid))
    return cudaErrorInvalidValue;

  __nv_bfloat16* dxp = static_cast<__nv_bfloat16*>(dx);
  cudaError_t err =
      tc::two_consumers(s, fixed, s.c_boxes)
          ? tc::launch_dx<2>(xmap, gmap, w1map, w2map, b1, dxp, s, stream)
          : tc::launch_dx<1>(xmap, gmap, w1map, w2map, b1, dxp, s, stream);
  if (err != cudaSuccess) return err;

  const int smem_dw = fixed + (2 * row_tiles + slots_dw) * tc::kBoxBytes +
                      1024;
  err = allow_smem(tc::mlp_bwd_dw_tc_kernel, smem_dw);
  if (err != cudaSuccess) return err;
  const dim3 grid_dw(s.chunks, (tiles + row_tiles - 1) / row_tiles);
  tc::mlp_bwd_dw_tc_kernel<<<grid_dw, tc::threads<1>(), smem_dw, stream>>>(
      xmap, gmap, w1map, w2map, b1, static_cast<const __nv_bfloat16*>(g),
      dw1, db1, dw2, db2, s, row_tiles, slots_dw);
  return cudaGetLastError();
}
