// LayerNorm over the last axis: bf16 (or fp32) in and out, fp32 statistics
// and fp32 affine.
//
// Replaces: swindet_tpu/ops/layer_norm.py · _ln_kernel (via _ln_fwd_impl,
// pallas_call at :83), used by every Swin norm (patch-embed, norm1/norm2 of
// every block, the merge norms and the output norms).
//
// Bound: device memory. Each element is read once from DRAM and written
// once (2 + 2 bytes in bf16) against ~8 flops, far below the card's ~295
// flop/byte ridge, so the kernel's job is to keep enough loads in flight to
// stream every row once at full bandwidth. The statistics take two passes
// over the row (mean, then the centred variance) where the TPU kernel used
// E[x^2] - mean^2, as the plain version does.
//
// layer_norm_vec_kernel (C a multiple of the 16-byte vector: 8 bf16 or 4
// fp32 values; every Swin width, C = 96 ... 1536, and Swin-B's 2048): a
// group of G lanes holds a row in registers, K 16-byte chunks a lane, G the
// largest power of two up to 32 that divides C / 8 (C / 4 in fp32), so no
// lane idles and 32 / G rows share a warp (C = 96 bf16: G = 4, K = 3).
// Lane g of a group reads chunks g, g + G, ..: one warp load covers G
// contiguous chunks of each of its 32 / G rows. Each lane takes R rows
// (4, 2 or 1 as K grows: R K <= 8 where K <= 8), all R K loads issued before
// the first reduction; the sums reduce with shuffles inside the group; the
// output leaves in 16-byte stores. A lane's fp32 weight and bias slice is
// loaded once into registers where it is at most 32 values a tensor (bf16
// K <= 4, fp32 K <= 8) and read from L1 with 16-byte loads beside each
// chunk otherwise. Warps walk row tiles (32 / G x R rows) with a grid
// stride; ops/layer_norm.py ln_geometry sizes the grid (two blocks an SM at
// most, fewer where the rows run out) and gives G, K and R.
// layer_norm_kernel (any other width, or a base off 16 bytes; the first
// kernel, kept as written): one warp a row, lanes striding over the
// channels with scalar loads, the row read three times (the second and
// third reads hit L1).
#include "common.cuh"

namespace swindet {

constexpr int kLnThreads = 256;  // the first kernel: 8 rows per block

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                  const float* __restrict__ bias, T* __restrict__ y,
                  int64_t rows, int cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * cols;
  T* yr = y + row * cols;

  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / cols;

  float ss = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    ss += d * d;
  }
  const float inv = rsqrtf(warp_sum(ss) / cols + eps);

  for (int c = lane; c < cols; c += 32) {
    const float v = (to_f32(xr[c]) - mean) * inv;
    yr[c] = from_f32<T>(v * weight[c] + bias[c]);
  }
}

// ------------------------------------------------------- the vector kernel
// 16 bytes of x as fp32 values, and back
template <typename T>
constexpr int kLnVec = 16 / sizeof(T);

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// round-to-nearest-even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// rows a lane takes, R, for K chunks a lane (ops/layer_norm.py
// ln_rows_per_thread)
__host__ __device__ constexpr int ln_rows_per_thread(int k) {
  return k <= 2 ? 4 : (k <= 4 ? 2 : 1);
}

// The sum over a group of `group` lanes (a power of two dividing 32).
__device__ __forceinline__ float group_sum(float v, int group) {
  for (int o = group >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V fp32 values of a at 16-byte aligned a + at
template <int V>
__device__ __forceinline__ void ldg_f32(const float* a, int at,
                                        float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(a + at) + i);
    f[4 * i] = q.x;
    f[4 * i + 1] = q.y;
    f[4 * i + 2] = q.z;
    f[4 * i + 3] = q.w;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kLnThreads, 2)
layer_norm_vec_kernel(const T* __restrict__ x,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int64_t rows, int cols, int group, float eps) {
  constexpr int V = kLnVec<T>, R = ln_rows_per_thread(K);
  constexpr bool kAffineInRegs = K * V <= 32;
  const int lane = threadIdx.x & 31;
  const int g = lane & (group - 1), slots = 32 / group;
  const int slot = lane / group;
  const int64_t tile_rows = (int64_t)slots * R;
  const int64_t tiles = (rows + tile_rows - 1) / tile_rows;
  const int64_t warps = (int64_t)gridDim.x * (kLnThreads / 32);
  const float inv_cols = 1.f / cols;

  float w[kAffineInRegs ? K : 1][V], b[kAffineInRegs ? K : 1][V];
  if constexpr (kAffineInRegs) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ldg_f32<V>(weight, (k * group + g) * V, w[k]);
      ldg_f32<V>(bias, (k * group + g) * V, b[k]);
    }
  }

  // warp w of block b: tiles b + w B, b + (w + 8) B, .. (B blocks), so a
  // launch of few tiles gives each block a few and leaves none idle
  for (int64_t t = blockIdx.x + (int64_t)gridDim.x * (threadIdx.x >> 5);
       t < tiles; t += warps) {
    // every load of the tile's R rows before the first reduction; a row
    // past the end reads zeros and stores nothing, but its lanes still
    // take part in the group's shuffles
    uint4 raw[R][K];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = t * tile_rows + r * slots + slot;
#pragma unroll
      for (int k = 0; k < K; ++k)
        raw[r][k] = row < rows
                        ? __ldg(reinterpret_cast<const uint4*>(
                              x + row * cols + (k * group + g) * V))
                        : make_uint4(0, 0, 0, 0);
    }
    float mean[R], inv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float f[V];
        unpack(raw[r][k], f);
#pragma unroll
        for (int i = 0; i < V; ++i) s += f[i];
      }
      mean[r] = group_sum(s, group) * inv_cols;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float f[V];
        unpack(raw[r][k], f);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = f[i] - mean[r];
          ss += d * d;
        }
      }
      inv[r] = rsqrtf(group_sum(ss, group) * inv_cols + eps);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = t * tile_rows + r * slots + slot;
      if (row >= rows) continue;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int at = (k * group + g) * V;
        float f[V], wk[V], bk[V];
        unpack(raw[r][k], f);
        if constexpr (kAffineInRegs) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            wk[i] = w[k][i];
            bk[i] = b[k][i];
          }
        } else {
          ldg_f32<V>(weight, at, wk);
          ldg_f32<V>(bias, at, bk);
        }
#pragma unroll
        for (int i = 0; i < V; ++i)
          f[i] = (f[i] - mean[r]) * inv[r] * wk[i] + bk[i];
        *reinterpret_cast<uint4*>(y + row * cols + at) = pack(f);
      }
    }
  }
}

template <typename T>
static int launch(const void* x, const float* w, const float* b, void* y,
                  int64_t rows, int cols, float eps, cudaStream_t stream) {
  const int rows_per_block = kLnThreads / 32;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  layer_norm_kernel<T><<<(unsigned)blocks, kLnThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), rows, cols, eps);
  return (int)cudaGetLastError();
}

template <typename T, int K>
static int launch_vec_k(const void* x, const float* w, const float* b,
                        void* y, int64_t rows, int cols, float eps, int group,
                        int blocks, cudaStream_t stream) {
  layer_norm_vec_kernel<T, K><<<blocks, kLnThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), rows, cols, group,
      eps);
  return (int)cudaGetLastError();
}

// K = cols / (G V) chunks a lane, one of ops/layer_norm.py
// LN_PER_LANE[T]: the K that the Swin configs' widths reach
template <typename T>
static int launch_vec(const void* x, const float* w, const float* b, void* y,
                      int64_t rows, int cols, float eps, int group,
                      int blocks, cudaStream_t stream) {
  constexpr int V = kLnVec<T>;
  if (group < 1 || group > 32 || (group & (group - 1)) || blocks < 1 ||
      cols % (group * V))
    return (int)cudaErrorInvalidValue;
  switch (cols / (group * V)) {
#define SWINDET_LN_K(k)                                                    \
  case k:                                                                  \
    return launch_vec_k<T, k>(x, w, b, y, rows, cols, eps, group, blocks, \
                              stream);
    SWINDET_LN_K(1) SWINDET_LN_K(2) SWINDET_LN_K(3) SWINDET_LN_K(4)
    SWINDET_LN_K(6) SWINDET_LN_K(8)
  }
  if constexpr (sizeof(T) == 4) {
    switch (cols / (group * V)) { SWINDET_LN_K(12) SWINDET_LN_K(16) }
  }
#undef SWINDET_LN_K
  return (int)cudaErrorInvalidValue;
}

}  // namespace swindet

// x (rows, cols) in `dtype`, weight and bias (cols,) fp32. group > 0 runs
// the vector kernel with `group` lanes a row on `blocks` blocks (x, y,
// weight and bias 16-byte aligned; ops/layer_norm.py ln_geometry), group 0
// the first kernel.
SWINDET_EXPORT int swindet_layer_norm(const void* x, const float* weight,
                                      const float* bias, void* y,
                                      int64_t rows, int cols, float eps,
                                      int dtype, int group, int blocks,
                                      void* stream) {
  using namespace swindet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return (int)cudaSuccess;
  if (dtype == kBFloat16)
    return group ? launch_vec<__nv_bfloat16>(x, weight, bias, y, rows, cols,
                                             eps, group, blocks, s)
                 : launch<__nv_bfloat16>(x, weight, bias, y, rows, cols, eps,
                                         s);
  if (dtype == kFloat32)
    return group ? launch_vec<float>(x, weight, bias, y, rows, cols, eps,
                                     group, blocks, s)
                 : launch<float>(x, weight, bias, y, rows, cols, eps, s);
  return (int)cudaErrorInvalidValue;
}
