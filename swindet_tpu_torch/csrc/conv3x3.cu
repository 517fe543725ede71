// 3x3 stride-1 SAME convolution over NHWC, HWIO weight, fp32 bias and an
// optional fused ReLU:
//   out[b, y, x, o] = act(bias[o] + sum_{dy, dx, c} in[b, y+dy-1, x+dx-1, c]
//                                                  * w[dy, dx, c, o])
// and its filter gradient (the backward's dw; its dx is the forward applied
// to g with the weight rotated by 180 degrees):
//   dw[dy, dx, c, o] = sum over pixels (b, y, x) of
//                      in[b, y+dy-1, x+dx-1, c] * g[b, y, x, o]
// with zeros outside the image, accumulated in fp32.
//
// Replaces: swindet_tpu/ops/conv3x3.py · _conv_kernel (:25, via
// conv3x3_fwd, pallas_call at :71): the FPN output convs, the RPN conv
// (with ReLU) and the four mask-head convs (with ReLU); and _dw_kernel
// (:112, via _conv3x3_dw, pallas_call at :157), called from
// conv3x3_bwd_pallas (:196).
//
// Bound: arithmetic. At 256 -> 256 channels an output pixel costs
// 2 * 9 * 256 * 256 = 1.18 MFLOP for ~1 KB of input and output, far above
// the card's ridge (~295 bf16 operations a byte). The forward is a GEMM of
// M = B*H*W pixels by N = Co by K = 9*C (tap, channel); the filter
// gradient, per tap, a GEMM of M = C by N = Co by K = B*H*W pixels (134,400
// at FPN P2 of a 2 x 800x1344 batch). Neither writes an im2col matrix.
//
// Two kernels each, picked by the wrapper by dtype alone:
//
// bf16: tensor cores (conv3x3_tc_kernel, conv3x3_dw_tc_kernel). A block
// of 384 threads is three warpgroups: one producer warp issues TMA tensor
// loads (cp.async.bulk.tensor) into a ring of kStages = 4 stages of
// 48 KB, guarded by full/empty mbarriers; two consumer warpgroups each
// run wgmma.mma_async m64n256k16 with a 64 x 256 fp32 accumulator in
// registers (setmaxnreg moves registers from the producer, 40, to the
// consumers, 232). A stage is two 64 x 64 A boxes, one per consumer, and a
// 64 (K) x 256 B tile loaded as four 64 x 64 boxes; every box has 64
// channels (128 bytes) in its rows and lands with 128-byte swizzle, the
// layout wgmma reads. The image is read as a 4-D tensor map (C, W, H, B)
// in spatial boxes of 64 pixels -- 1 x 64, 2 x 32, 4 x 16 or 8 x 8, the
// wrapper picks the one that pads the map least -- and TMA fills every
// element outside the tensor (negative coordinates, past H, W or C) with
// zeros: that is the one-pixel SAME halo, with no halo code.
//   Forward: a block owns two boxes (128 output pixels) by 256 output
//   channels. Its K loop runs over the 9 taps x ceil(C / 64) channel
//   blocks; for tap (dy, dx) the A box is the image box shifted by
//   (dy - 1, dx - 1). A is K-major; B, the HWIO weight read as a 3-D map
//   (Co, C, 9) in place, is MN-major and read with wgmma's transpose bit,
//   so no transposed copy of the weight is made. Epilogue: fp32 accumulator
//   + fp32 bias, optional ReLU, rounded once to bf16, stored with masks on
//   rows past W, H or the batch and channels past Co.
//   Filter gradient: a block owns one tap by 128 input channels by 256
//   output channels over a chunk of the pixel boxes (split K). For each
//   box, A is x's box shifted by the tap (two 64-channel boxes) and B is
//   g's unshifted box (four 64-channel boxes), both MN-major (channels
//   contiguous, pixels outer) and read with the transpose bits; pixels
//   outside the image read as zero in g and add nothing. The chunks are
//   reduced by fp32 atomics (red.global.add) into the zeroed dw: the
//   wrapper picks the chunk count so that about three waves of blocks
//   fill the SMs, so each dw entry takes one atomic per chunk (22 at
//   256 -> 256 on 132 SMs) and the order of the additions varies from run
//   to run in the last bits.
// TMA needs a 16-byte aligned base and strides that are multiples of 16
// bytes, so the bf16 kernels take C % 8 == 0 and Co % 8 == 0.
//
// fp32: the first SIMT kernels (conv3x3_kernel, conv3x3_dw_kernel), kept
// for fp32 inputs: the card-vs-CPU checks run the detector in fp32 and
// hold its losses to 2e-6 relative, which tensor cores in TF32 (10-bit
// mantissa) could not meet. A block owns a 64-pixel x 64-channel output
// tile (or a 64 x 64 (C, Co) tile of one tap over a chunk of pixels),
// stages 16-deep K slices in shared memory (C % 16 == 0 keeps a slice
// inside one tap), loading zeros in the halo, and each of its 256 threads
// accumulates a 4 x 4 register tile in fp32; the filter gradient adds its
// tile to the zeroed dw with one atomicAdd per entry.
#include "common.cuh"
#include "sm90.cuh"

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

// ------------------------------------------------- bf16, tensor cores
namespace tc {

constexpr int kStages = 4;
constexpr int kThreads = 384;               // producer + two consumers
constexpr int kBox = 64;                    // pixels of a spatial box
constexpr int kChan = 64;                   // channels of a box row
constexpr int kBoxBytes = kBox * kChan * 2;           // 8 KB
constexpr int kBN = 256;                    // output channels of a block
constexpr int kBBoxes = kBN / kChan;                  // 4
constexpr int kStageBytes = (2 + kBBoxes) * kBoxBytes;  // 48 KB
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment
constexpr int kKSteps = kChan / 16;         // wgmma k16 steps of a stage

struct Shape {
  int batch, height, width, cin, cout;
  int box_h, box_w, nbx, nby, nboxes;
};

// box index -> its first column, first row and image
__device__ __forceinline__ void box_origin(const Shape& s, int box, int& x0,
                                           int& y0, int& b) {
  x0 = (box % s.nbx) * s.box_w;
  const int t = box / s.nbx;
  y0 = (t % s.nby) * s.box_h;
  b = t / s.nby;
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = sm90::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void init_barriers(uint64_t* full,
                                              uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);   // the producer's expect_tx
      sm90::mbar_init(&empty[i], 2);  // one arrival per consumer
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
}

// The consumers' main loop, shared by both kernels: `steps` stages, each
// kKSteps wgmma k16 steps of this warpgroup's A box (a_k_bytes apart
// along K; K-major when kTransA is 0) and the block's 4-box B tile
// (MN-major, boxes kBoxBytes apart, 2 KB per k16 step). A stage is
// released to the producer once the wgmmas reading it have completed:
// one group stays in flight while the next stage's group is issued.
template <int kTransA>
__device__ __forceinline__ void consume(float (&acc)[128], uint8_t* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int steps, int ci) {
  constexpr uint32_t a_k_bytes = kTransA ? 16 * kChan * 2 : 32;
  // MN-major A has one 64-wide block: lbo is unused, as sbo is for
  // K-major; both are set to the 8-row group stride
  constexpr uint32_t a_lbo = kTransA ? 1024 : 16;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < steps; ++kt) {
    sm90::mbar_wait(&full[stage], phase);
    uint8_t* st = smem + stage * kStageBytes;
    const uint32_t a = sm90::smem_u32(st + ci * kBoxBytes);
    const uint32_t b = sm90::smem_u32(st + 2 * kBoxBytes);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKSteps; ++k)
      sm90::wgmma_m64n256k16<kTransA, 1>(
          acc, sm90::gmma_desc(a + k * a_k_bytes, a_lbo, 1024),
          sm90::gmma_desc(b + k * 16 * kChan * 2, kBoxBytes, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (kt > 0 && threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  sm90::wgmma_wait<0>();
}

// Forward: blockIdx.x owns boxes 2x and 2x + 1 (one per consumer),
// blockIdx.y 256 output channels.
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, Shape s, int relu) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* smem = align_1024(smem_raw);
  const int wg = threadIdx.x / 128;
  const int n0 = blockIdx.y * kBN;
  const int cblocks = (s.cin + kChan - 1) / kChan;
  const int steps = 9 * cblocks;
  init_barriers(full, empty);

  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int x0[2], y0[2], bb[2];
      for (int j = 0; j < 2; ++j)
        box_origin(s, 2 * blockIdx.x + j, x0[j], y0[j], bb[j]);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < steps; ++kt) {
        const int tap = kt / cblocks, c0 = (kt % cblocks) * kChan;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_expect_tx(&full[stage], kStageBytes);
        uint8_t* st = smem + stage * kStageBytes;
        for (int j = 0; j < 2; ++j)
          sm90::tma_load_4d(st + j * kBoxBytes, &xmap, &full[stage], c0,
                            x0[j] + dx, y0[j] + dy, bb[j]);
        for (int j = 0; j < kBBoxes; ++j)
          sm90::tma_load_3d(st + (2 + j) * kBoxBytes, &wmap, &full[stage],
                            n0 + j * kChan, c0, tap);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int ci = wg - 1;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    consume<0>(acc, smem, full, empty, steps, ci);

    // accumulator fragment: warp w holds rows 16w .. 16w+15; lane l holds
    // rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1) for j < 32
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    int x0, y0, b;
    box_origin(s, 2 * blockIdx.x + ci, x0, y0, b);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + lane / 4 + 8 * half;
      const int y = y0 + r / s.box_w, x = x0 + r % s.box_w;
      if (b >= s.batch || y >= s.height || x >= s.width) continue;
      __nv_bfloat16* row =
          out + (((int64_t)b * s.height + y) * s.width + x) * s.cout;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int n = n0 + 8 * j + 2 * (lane % 4);
        if (n >= s.cout) continue;
        float v0 = acc[4 * j + 2 * half] + bias[n];
        float v1 = acc[4 * j + 2 * half + 1] + bias[n + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(row + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Filter gradient: blockIdx.x is (tap, 128-channel tile, 256-channel
// tile), blockIdx.y a chunk of `chunk` pixel boxes.
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_dw_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap gmap,
                     float* __restrict__ dw, Shape s, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* smem = align_1024(smem_raw);
  const int wg = threadIdx.x / 128;
  const int ctiles = (s.cin + 2 * kChan - 1) / (2 * kChan);
  const int otiles = (s.cout + kBN - 1) / kBN;
  const int tap = blockIdx.x / (ctiles * otiles);
  const int c0 = (blockIdx.x / otiles % ctiles) * 2 * kChan;
  const int o0 = blockIdx.x % otiles * kBN;
  const int first = blockIdx.y * chunk;
  const int steps = min(chunk, s.nboxes - first);
  init_barriers(full, empty);

  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < steps; ++kt) {
        int x0, y0, b;
        box_origin(s, first + kt, x0, y0, b);
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_expect_tx(&full[stage], kStageBytes);
        uint8_t* st = smem + stage * kStageBytes;
        for (int j = 0; j < 2; ++j)
          sm90::tma_load_4d(st + j * kBoxBytes, &xmap, &full[stage],
                            c0 + j * kChan, x0 + dx, y0 + dy, b);
        for (int j = 0; j < kBBoxes; ++j)
          sm90::tma_load_4d(st + (2 + j) * kBoxBytes, &gmap, &full[stage],
                            o0 + j * kChan, x0, y0, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int ci = wg - 1;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    consume<1>(acc, smem, full, empty, steps, ci);

    // rows are input channels, columns output channels
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + ci * kChan + warp * 16 + lane / 4 + 8 * half;
      if (c >= s.cin) continue;
      float* row = dw + ((int64_t)tap * s.cin + c) * s.cout;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int o = o0 + 8 * j + 2 * (lane % 4);
        if (o >= s.cout) continue;
        atomicAdd(row + o, acc[4 * j + 2 * half]);
        atomicAdd(row + o + 1, acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

// 4-D map of a (B, H, W, C) bf16 tensor, read in (64 channels, box_w,
// box_h, 1) boxes
inline bool image_map(CUtensorMap* map, const void* p, const Shape& s,
                      int channels) {
  const uint64_t dims[4] = {(uint64_t)channels, (uint64_t)s.width,
                            (uint64_t)s.height, (uint64_t)s.batch};
  const uint32_t box[4] = {kChan, (uint32_t)s.box_w, (uint32_t)s.box_h, 1};
  return sm90::bf16_tensor_map(map, p, 4, dims, box);
}

inline Shape make_shape(int batch, int height, int width, int cin, int cout,
                        int box_h, int box_w) {
  Shape s{batch, height, width, cin, cout, box_h, box_w, 0, 0, 0};
  s.nbx = (width + box_w - 1) / box_w;
  s.nby = (height + box_h - 1) / box_h;
  s.nboxes = batch * s.nby * s.nbx;
  return s;
}

inline bool shape_ok(int cin, int cout, int box_h, int box_w) {
  return cin % 8 == 0 && cout % 8 == 0 && box_h * box_w == kBox &&
         box_w >= 1 && box_w <= kBox;
}

}  // namespace tc

}  // namespace swindet

// fp32 x (B, H, W, C) and g (B, H, W, Co); adds the filter gradient into
// dw (3, 3, C, Co) fp32, which the caller zeroes.
SWINDET_EXPORT int swindet_conv3x3_dw(const float* x, const float* g,
                                      float* dw, int batch, int height,
                                      int width, int cin, int cout,
                                      void* stream) {
  using namespace swindet;
  if ((int64_t)batch * height * width == 0) return (int)cudaSuccess;
  launch_dw<float>(x, g, dw, batch, height, width, cin, cout,
                   static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// fp32 x (B, H, W, C) and w (3, 3, C, Co), bias (Co,), out (B, H, W, Co).
// Requires C % 16 == 0.
SWINDET_EXPORT int swindet_conv3x3(const float* x, const float* w,
                                   const float* bias, float* out, int batch,
                                   int height, int width, int cin, int cout,
                                   int relu, void* stream) {
  using namespace swindet;
  if ((int64_t)batch * height * width == 0) return (int)cudaSuccess;
  if (cin % kBK != 0) return (int)cudaErrorInvalidValue;
  launch<float>(x, w, bias, out, batch, height, width, cin, cout, relu,
                static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// bf16 x (B, H, W, C) and w (3, 3, C, Co), fp32 bias (Co,), bf16 out
// (B, H, W, Co), on the tensor cores; the image is read in box_h x box_w
// boxes (box_h * box_w == 64). Requires C % 8 == 0, Co % 8 == 0 and
// 16-byte aligned x and w; returns cudaErrorInvalidValue otherwise.
SWINDET_EXPORT int swindet_conv3x3_tc(const void* x, const void* w,
                                      const float* bias, void* out,
                                      int batch, int height, int width,
                                      int cin, int cout, int relu,
                                      int box_h, int box_w, void* stream) {
  using namespace swindet;
  if ((int64_t)batch * height * width == 0) return (int)cudaSuccess;
  if (!tc::shape_ok(cin, cout, box_h, box_w))
    return (int)cudaErrorInvalidValue;
  const tc::Shape s =
      tc::make_shape(batch, height, width, cin, cout, box_h, box_w);
  CUtensorMap xmap, wmap;
  const uint64_t wdims[3] = {(uint64_t)cout, (uint64_t)cin, 9};
  const uint32_t wbox[3] = {tc::kChan, tc::kChan, 1};
  if (!tc::image_map(&xmap, x, s, cin) ||
      !sm90::bf16_tensor_map(&wmap, w, 3, wdims, wbox))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(tc::conv3x3_tc_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       tc::kSmemBytes);
  dim3 grid((unsigned)((s.nboxes + 1) / 2),
            (unsigned)((cout + tc::kBN - 1) / tc::kBN));
  tc::conv3x3_tc_kernel<<<grid, tc::kThreads, tc::kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, bias, static_cast<__nv_bfloat16*>(out), s, relu);
  return (int)cudaGetLastError();
}

// bf16 x (B, H, W, C) and g (B, H, W, Co); adds the filter gradient into
// dw (3, 3, C, Co) fp32, which the caller zeroes, on the tensor cores. The
// pixels are read in box_h x box_w boxes, `chunk` boxes a block. Requires
// C % 8 == 0, Co % 8 == 0 and 16-byte aligned x and g.
SWINDET_EXPORT int swindet_conv3x3_dw_tc(const void* x, const void* g,
                                         float* dw, int batch, int height,
                                         int width, int cin, int cout,
                                         int box_h, int box_w, int chunk,
                                         void* stream) {
  using namespace swindet;
  if ((int64_t)batch * height * width == 0) return (int)cudaSuccess;
  if (!tc::shape_ok(cin, cout, box_h, box_w) || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const tc::Shape s =
      tc::make_shape(batch, height, width, cin, cout, box_h, box_w);
  CUtensorMap xmap, gmap;
  if (!tc::image_map(&xmap, x, s, cin) || !tc::image_map(&gmap, g, s, cout))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(tc::conv3x3_dw_tc_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       tc::kSmemBytes);
  const int ctiles = (cin + 2 * tc::kChan - 1) / (2 * tc::kChan);
  const int otiles = (cout + tc::kBN - 1) / tc::kBN;
  dim3 grid((unsigned)(9 * ctiles * otiles),
            (unsigned)((s.nboxes + chunk - 1) / chunk));
  tc::conv3x3_dw_tc_kernel<<<grid, tc::kThreads, tc::kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      xmap, gmap, dw, s, chunk);
  return (int)cudaGetLastError();
}
