// 3x3 stride-1 SAME convolution over NHWC, HWIO weight, fp32 bias and an
// optional fused ReLU:
//   out[b, y, x, o] = act(bias[o] + sum_{dy, dx, c} in[b, y+dy-1, x+dx-1, c]
//                                                  * w[dy, dx, c, o])
//
// Replaces: swindet_tpu/ops/conv3x3.py · _conv_kernel (via conv3x3_fwd,
// pallas_call at :71): the FPN output convs, the RPN conv (with ReLU) and
// the four mask-head convs (with ReLU).
//
// Bound: arithmetic. At 256 -> 256 channels a pixel costs 2 * 9 * 256 * 256
// = 1.18 MFLOP for ~1 KB of input and output, far above the ridge, so the
// work is a GEMM of M = B*H*W pixels by N = Co by K = 9*C taps. Design: an
// implicit GEMM -- the im2col matrix is never written. A block owns a
// 64-pixel x 64-channel output tile; for each 16-deep slice of K (one tap,
// 16 input channels; C % 16 == 0 keeps a slice inside one tap) it stages
// the shifted input rows and the matching weight rows in shared memory,
// loading zeros for taps that fall in the one-pixel halo outside the image,
// and each of its 256 threads accumulates a 4 x 4 register tile in fp32.
// Inputs stay in their own type in DRAM; the products are exact in fp32
// (bf16 x bf16 fits a 24-bit mantissa), as the TPU kernel accumulates them.
// This first version runs on the CUDA cores; the tensor cores (wgmma) are
// the obvious next step.
//
// Filter gradient (the backward's dw; its dx is the forward above applied
// to g with the weight rotated by 180 degrees):
//   dw[dy, dx, c, o] = sum over pixels (b, y, x) of
//                      in[b, y+dy-1, x+dx-1, c] * g[b, y, x, o]
// with zeros outside the image, in fp32.
//
// Replaces: swindet_tpu/ops/conv3x3.py · _dw_kernel (via _conv3x3_dw,
// pallas_call at :157), called from conv3x3_bwd_pallas (:196).
//
// Bound: arithmetic, as the forward: a GEMM of M = C by N = Co per tap
// with K = B*H*W pixels (134,400 at FPN P2 of a 2 x 800x1344 batch). The
// TPU kernel accumulates the whole (3, 3, C, Co) block across its
// sequential grid (:130-139). Design: split K. A block owns a 64 x 64
// (C, Co) tile of one tap over one chunk of pixels, stages 16 pixels of
// the shifted input and of g per step in shared memory (threads load four
// consecutive channels of one pixel, so each pixel row is one coalesced
// read), accumulates a 4 x 4 register tile per thread in fp32, and adds it
// to the zeroed fp32 dw with one atomicAdd per entry. The host picks the
// chunk count so that about eight blocks per SM are in flight; the order
// of the chunks' atomics varies, so dw varies in its last bits.
#include "common.cuh"

namespace swindet {

constexpr int kBM = 64, kBN = 64, kBK = 16, kConvThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out,
               int batch, int height, int width, int cin, int cout,
               int relu) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int64_t m_total = (int64_t)batch * height * width;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's A-load slot: one pixel, four consecutive channels
  const int a_m = tid >> 2;          // 0..63
  const int a_k = (tid & 3) * 4;     // 0, 4, 8, 12
  const int64_t pm = m0 + a_m;
  const bool pm_ok = pm < m_total;
  int py = 0, px = 0;
  int64_t pb = 0;
  if (pm_ok) {
    px = (int)(pm % width);
    const int64_t t = pm / width;
    py = (int)(t % height);
    pb = t / height;
  }
  // this thread's B-load slot: one K row, four consecutive output channels
  const int b_k = tid >> 4;          // 0..15
  const int b_n = (tid & 15) * 4;    // 0..60

  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};

  const int k_total = 9 * cin;
  for (int k0 = 0; k0 < k_total; k0 += kBK) {
    const int tap = k0 / cin;
    const int c0 = k0 - tap * cin;
    const int yy = py + tap / 3 - 1;
    const int xx = px + tap % 3 - 1;
    const bool in_img =
        pm_ok && yy >= 0 && yy < height && xx >= 0 && xx < width;
    if (in_img) {
      const T* src = x + ((pb * height + yy) * width + xx) * cin + c0 + a_k;
#pragma unroll
      for (int i = 0; i < 4; ++i) As[a_k + i][a_m] = to_f32(src[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) As[a_k + i][a_m] = 0.f;
    }

    const T* wsrc = w + (int64_t)(k0 + b_k) * cout + n0 + b_n;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Bs[b_k][b_n + j] = (n0 + b_n + j < cout) ? to_f32(wsrc[j]) : 0.f;
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= cout) continue;
      float v = acc[i][j] + bias[n];
      if (relu) v = fmaxf(v, 0.f);
      out[m * cout + n] = from_f32<T>(v);
    }
  }
}

template <typename T>
static void launch(const void* x, const void* w, const float* bias, void* out,
                   int batch, int height, int width, int cin, int cout,
                   int relu, cudaStream_t stream) {
  const int64_t m_total = (int64_t)batch * height * width;
  dim3 grid((unsigned)((m_total + kBM - 1) / kBM), (cout + kBN - 1) / kBN);
  conv3x3_kernel<T><<<grid, kConvThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), batch, height, width, cin, cout, relu);
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv3x3_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ dw, int batch, int height, int width,
                  int cin, int cout, int64_t chunk) {
  __shared__ __align__(16) float As[kBK][kBM];   // [pixel][input channel]
  __shared__ __align__(16) float Bs[kBK][kBN];   // [pixel][output channel]

  const int tid = threadIdx.x;
  const int c_tiles = (cin + kBM - 1) / kBM;
  const int tap = blockIdx.x / c_tiles;
  const int c0 = (blockIdx.x % c_tiles) * kBM;
  const int o0 = blockIdx.y * kBN;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int64_t m_total = (int64_t)batch * height * width;
  const int64_t p_begin = (int64_t)blockIdx.z * chunk;
  const int64_t p_end =
      p_begin + chunk < m_total ? p_begin + chunk : m_total;

  // this thread's load slot: one pixel, four consecutive channels
  const int l_p = tid >> 4;          // 0..15
  const int l_c = (tid & 15) * 4;    // 0..60
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};

  for (int64_t p0 = p_begin; p0 < p_end; p0 += kBK) {
    const int64_t pm = p0 + l_p;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    float b[4] = {0.f, 0.f, 0.f, 0.f};
    if (pm < p_end) {
      const int px = (int)(pm % width);
      const int64_t t = pm / width;
      const int py = (int)(t % height);
      const int64_t pb = t / height;
      const int yy = py + dy, xx = px + dx;
      if (yy >= 0 && yy < height && xx >= 0 && xx < width) {
        const T* src = x + ((pb * height + yy) * width + xx) * cin;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ci = c0 + l_c + i;
          if (ci < cin) a[i] = to_f32(src[ci]);
        }
      }
      const T* gsrc = g + pm * cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int oj = o0 + l_c + j;
        if (oj < cout) b[j] = to_f32(gsrc[oj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[l_p][l_c + i] = a[i];
      Bs[l_p][l_c + i] = b[i];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = c0 + ty * 4 + i;
    if (ci >= cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oj = o0 + tx * 4 + j;
      if (oj < cout)
        atomicAdd(&dw[((size_t)tap * cin + ci) * cout + oj], acc[i][j]);
    }
  }
}

template <typename T>
static void launch_dw(const void* x, const void* g, float* dw, int batch,
                      int height, int width, int cin, int cout,
                      cudaStream_t stream) {
  const int64_t m_total = (int64_t)batch * height * width;
  const int c_tiles = (cin + kBM - 1) / kBM;
  const int o_tiles = (cout + kBN - 1) / kBN;
  const int64_t tiles = 9LL * c_tiles * o_tiles;
  // about 8 blocks per SM over 132 SMs, and at least 64 pixels a chunk
  const int64_t want = (8 * 132 + tiles - 1) / tiles;
  const int64_t most = (m_total + 63) / 64;
  const int64_t chunks = want < 1 ? 1 : (want > most ? most : want);
  int64_t chunk = (m_total + chunks - 1) / chunks;
  chunk = (chunk + kBK - 1) / kBK * kBK;
  dim3 grid((unsigned)(9 * c_tiles), (unsigned)o_tiles,
            (unsigned)((m_total + chunk - 1) / chunk));
  conv3x3_dw_kernel<T><<<grid, kConvThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), dw, batch, height,
      width, cin, cout, chunk);
}

}  // namespace swindet

// x (B, H, W, C) and g (B, H, W, Co) in `dtype`; adds the filter gradient
// into dw (3, 3, C, Co) fp32, which the caller zeroes.
SWINDET_EXPORT int swindet_conv3x3_dw(const void* x, const void* g, float* dw,
                                      int batch, int height, int width,
                                      int cin, int cout, int dtype,
                                      void* stream) {
  using namespace swindet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)batch * height * width == 0) return (int)cudaSuccess;
  if (dtype == kBFloat16)
    launch_dw<__nv_bfloat16>(x, g, dw, batch, height, width, cin, cout, s);
  else if (dtype == kFloat32)
    launch_dw<float>(x, g, dw, batch, height, width, cin, cout, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x (B, H, W, C) and w (3, 3, C, Co) in `dtype`, bias (Co,) fp32, out
// (B, H, W, Co) in `dtype`. Requires C % 16 == 0.
SWINDET_EXPORT int swindet_conv3x3(const void* x, const void* w,
                                   const float* bias, void* out, int batch,
                                   int height, int width, int cin, int cout,
                                   int relu, int dtype, void* stream) {
  using namespace swindet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)batch * height * width == 0) return (int)cudaSuccess;
  if (cin % kBK != 0) return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    launch<__nv_bfloat16>(x, w, bias, out, batch, height, width, cin, cout,
                          relu, s);
  else if (dtype == kFloat32)
    launch<float>(x, w, bias, out, batch, height, width, cin, cout, relu, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
