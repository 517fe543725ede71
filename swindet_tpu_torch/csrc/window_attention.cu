// Swin window attention: the inference forward, the training forward that
// also writes the softmax, and the backward.
//
// Forward:
//   out[w, :, h] = softmax(q_h k_h^T * hd^-1/2 + bias[h] + mask[w mod nW]) v_h
// for every window w and head h, reading the packed qkv projection
// (B_, N, 3C) = [q | k | v] with heads contiguous inside each third, and
// writing head h's lanes of the packed (B_, N, C) output directly.
//
// Replaces: swindet_tpu/ops/window_attention_v3.py · _wattn3_kernel (via
// _wattn3_fwd_impl, pallas_call at :293), called from every Swin block
// (models/backbones/swin.py:265-274); with the softmax saved,
// _wattn3_kernel_p (:209, via _wattn3_fwd_p_impl, pallas_call at :253).
//
// Bound: at N = 49 tokens and hd = 32 one (window, head) pair does ~0.31
// MFLOP on ~9.4 KB of bf16 q/k/v, ~33 flop/byte: memory-bound against the
// card's ~295 flop/byte ridge, and far too small for a tensor-core tile.
// Writing the fp32 softmax (9.6 KB per pair) doubles the training
// forward's bytes. Design: one block per (window, head) -- 4,176 blocks at
// stage 1 of an 800x1344 canvas, enough to fill 132 SMs. The block stages
// its head's q (pre-scaled, fp32), k and v in shared memory with rows
// padded by one float so the column walks are free of bank conflicts,
// forms the N x N logits in shared memory, adds the relative-position bias
// and the shift mask, runs the softmax one warp per row in fp32 (writing
// the fp32 probabilities with coalesced stores when they are saved),
// rounds the probabilities to the input type (as the TPU kernel feeds P
// in the compute type to the second matmul), and accumulates P v in fp32.
// Every DRAM byte is read once.
//
// Backward: replaces _wattn3_bwd_kernel (:119, via _wattn3_bwd_impl,
// pallas_call at :189). From the saved fp32 P and the output gradient g:
//   dV = P^T g, dP = g V^T, dS = P * (dP - rowsum(dP * P)),
//   dQ = scale * dS K, dK = dS^T (scale * Q), dBias[h] = sum_w dS.
// Bound: bytes again -- per pair it reads q, k, v, g and the 9.6 KB fp32
// P and writes dq, dk, dv, for ~0.6 MFLOP. Design: one block per
// (group of kBwdWindows windows, head); per window it stages q, k, v, g
// and P in shared memory and computes the five products above from there
// in fp32. The TPU kernel carries dBias across its sequential grid
// (:135-137); blocks here run in no order, so each block sums dS of its
// windows in shared memory (one warp owns each row, so no two threads
// touch one entry) and adds that partial to the zeroed fp32 dBias with
// one atomicAdd per entry: kBwdWindows times fewer atomics than one per
// window. The atomics' order varies between runs, so dBias varies in its
// last bits.
//
// The same forward body serves two more TPU kernels that only the JAX
// package's op tests run, each reading its own layout through a source
// policy (PackedQkv above, HeadMajorQkv, SwinMap):
// - swindet_window_attention_heads replaces swindet_tpu/ops/
//   window_attention.py · _wattn_kernel (:30, via
//   _window_attention_fwd_impl, pallas_call at :141): the v1 attention over
//   head-major (B_, nH, N, hd) q, k, v. The TPU padded N to a sublane
//   multiple and masked the padded keys with -1e30; here the loops stop at
//   N, and window w reads mask[w mod nW] with no tiled copy.
// - swindet_swin_attention replaces swindet_tpu/ops/swin_attention.py ·
//   _swin_attn_kernel (:46, via _swin_attn_fwd_impl, pallas_call at :149):
//   the cyclic roll, window partition and attention over the padded qkv map
//   (B, Hp, Wp, 3C) in one pass. Each block reads its window's tokens at
//   the rolled positions with wrap-around (the TPU read row blocks i and
//   i + 1 mod nHb), rebuilds the -100 shift mask from region ids in rolled
//   coordinates, and writes the output in rolled coordinates.
// Both are bound by bytes as the forward above. Their backward recomputes
// through the plain version in PyTorch, as the JAX package's does.
#include "common.cuh"

namespace swindet {

constexpr int kAttnThreads = 128;
constexpr int kBwdWindows = 8;

// Where the kernel finds one window's q, k and v, its additive mask and
// its output. Window `win` is blockIdx.x; head h's values of token i are
// channel d of that head.

// The packed projection (B_, N, 3C) = [q | k | v], heads contiguous in each
// third, the mask (nW, N, N) or null, the output (B_, N, C).
template <typename T>
struct PackedQkv {
  const T* qkv;
  const float* mask;
  T* out;
  int n, c, hd, nw;
  __device__ void load(int win, int h, int i, int d, float& q, float& k,
                       float& v) const {
    const T* row = qkv + ((size_t)win * n + i) * 3 * c + h * hd + d;
    q = to_f32(row[0]);
    k = to_f32(row[c]);
    v = to_f32(row[2 * c]);
  }
  __device__ float add(int win, int i, int j) const {
    return mask ? mask[((size_t)(win % nw) * n + i) * n + j] : 0.f;
  }
  __device__ T* dst(int win, int h, int i) const {
    return out + ((size_t)win * n + i) * c + h * hd;
  }
};

// Head-major q, k, v, each (B_, nH, N, hd), as the v1 kernel reads them;
// the mask (nW, N, N) or null; the output (B_, N, C).
template <typename T>
struct HeadMajorQkv {
  const T *q, *k, *v;
  const float* mask;
  T* out;
  int n, c, hd, nh, nw;
  __device__ void load(int win, int h, int i, int d, float& qv, float& kv,
                       float& vv) const {
    const size_t at = (((size_t)win * nh + h) * n + i) * hd + d;
    qv = to_f32(q[at]);
    kv = to_f32(k[at]);
    vv = to_f32(v[at]);
  }
  __device__ float add(int win, int i, int j) const {
    return mask ? mask[((size_t)(win % nw) * n + i) * n + j] : 0.f;
  }
  __device__ T* dst(int win, int h, int i) const {
    return out + ((size_t)win * n + i) * c + h * hd;
  }
};

// The padded qkv map (B, Hp, Wp, 3C) of a shifted block. Window win is
// (image, window row, window column); its token (r, s) sits at rolled
// position (y, x) = (row ws + r, col ws + s) and reads map pixel
// ((y + shift) mod Hp, (x + shift) mod Wp): the cyclic roll with
// wrap-around. The output (B, Hp, Wp, C) stays in rolled coordinates. The
// shift mask is -100 between tokens of different regions, the region of a
// rolled row y being 0 below Hp - ws, 1 below Hp - shift and 2 above (the
// same for columns), as the reference's img_mask slices.
template <typename T>
struct SwinMap {
  const T* qkv;
  T* out;
  int hp, wp, c, hd, ws, shift;
  __device__ void pos(int win, int i, int& b, int& y, int& x) const {
    const int nwx = wp / ws, per_img = (hp / ws) * nwx;
    b = win / per_img;
    const int w = win % per_img;
    y = (w / nwx) * ws + i / ws;
    x = (w % nwx) * ws + i % ws;
  }
  __device__ void load(int win, int h, int i, int d, float& q, float& k,
                       float& v) const {
    int b, y, x;
    pos(win, i, b, y, x);
    const int sy = (y + shift) % hp, sx = (x + shift) % wp;
    const T* px =
        qkv + (((size_t)b * hp + sy) * wp + sx) * 3 * c + h * hd + d;
    q = to_f32(px[0]);
    k = to_f32(px[c]);
    v = to_f32(px[2 * c]);
  }
  __device__ int region(int win, int i) const {
    int b, y, x;
    pos(win, i, b, y, x);
    const int ry = y < hp - ws ? 0 : (y < hp - shift ? 1 : 2);
    const int rx = x < wp - ws ? 0 : (x < wp - shift ? 1 : 2);
    return 3 * ry + rx;
  }
  __device__ float add(int win, int i, int j) const {
    return shift && region(win, i) != region(win, j) ? -100.f : 0.f;
  }
  __device__ T* dst(int win, int h, int i) const {
    int b, y, x;
    pos(win, i, b, y, x);
    return out + (((size_t)b * hp + y) * wp + x) * c + h * hd;
  }
};

template <typename T, bool kSaveP, typename Src>
__global__ void __launch_bounds__(kAttnThreads)
window_attention_kernel(const Src src, const float* __restrict__ bias,
                        float* __restrict__ p_out, int n, int hd,
                        float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;          // padded row of q, k, v
  const int lds = n + 1;          // padded row of the logits
  float* q = smem;
  float* k = q + n * ld;
  float* v = k + n * ld;
  float* s = v + n * ld;

  const int win = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < n * hd; idx += kAttnThreads) {
    const int i = idx / hd, d = idx % hd;
    float qv, kv, vv;
    src.load(win, h, i, d, qv, kv, vv);
    q[i * ld + d] = qv * scale;
    k[i * ld + d] = kv;
    v[i * ld + d] = vv;
  }
  __syncthreads();

  const float* bias_h = bias + (size_t)h * n * n;
  for (int idx = tid; idx < n * n; idx += kAttnThreads) {
    const int i = idx / n, j = idx % n;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc += q[i * ld + d] * k[j * ld + d];
    acc += bias_h[idx];
    acc += src.add(win, i, j);
    s[i * lds + j] = acc;
  }
  __syncthreads();

  // P laid out (nH, B_, N, N): this pair's N x N block
  float* p_w = kSaveP ? p_out + ((size_t)h * gridDim.x + win) * n * n
                      : nullptr;
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < n; i += kAttnThreads / 32) {
    float* row = s + i * lds;
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
    for (int j = lane; j < n; j += 32) {
      const float pv = row[j] * inv;
      if (kSaveP) p_w[i * n + j] = pv;
      row[j] = to_f32(from_f32<T>(pv));
    }
  }
  __syncthreads();

  for (int idx = tid; idx < n * hd; idx += kAttnThreads) {
    const int i = idx / hd, d = idx % hd;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc += s[i * lds + j] * v[j * ld + d];
    src.dst(win, h, i)[d] = from_f32<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
window_attention_bwd_kernel(const T* __restrict__ qkv,
                            const float* __restrict__ p,
                            const T* __restrict__ g, T* __restrict__ dqkv,
                            float* __restrict__ dbias, int b_, int n, int c,
                            int nh, float scale) {
  extern __shared__ float smem[];
  const int hd = c / nh;
  const int ld = hd + 1;
  const int lds = n + 1;
  float* q = smem;                // scale * q
  float* k = q + n * ld;
  float* v = k + n * ld;
  float* gs = v + n * ld;
  float* ps = gs + n * ld;        // P, padded rows
  float* ds = ps + n * lds;       // dP, then dS
  float* db = ds + n * lds;       // this block's sum of dS, n x n

  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int c3 = 3 * c;
  for (int idx = tid; idx < n * n; idx += kAttnThreads) db[idx] = 0.f;

  const int w_end = min((int)(blockIdx.x + 1) * kBwdWindows, b_);
  for (int win = blockIdx.x * kBwdWindows; win < w_end; ++win) {
    const T* base = qkv + (size_t)win * n * c3 + h * hd;
    const T* g_base = g + (size_t)win * n * c + h * hd;
    for (int idx = tid; idx < n * hd; idx += kAttnThreads) {
      const int i = idx / hd, d = idx % hd;
      const T* row = base + (size_t)i * c3 + d;
      q[i * ld + d] = to_f32(row[0]) * scale;
      k[i * ld + d] = to_f32(row[c]);
      v[i * ld + d] = to_f32(row[2 * c]);
      gs[i * ld + d] = to_f32(g_base[(size_t)i * c + d]);
    }
    const float* p_w = p + ((size_t)h * b_ + win) * n * n;
    for (int idx = tid; idx < n * n; idx += kAttnThreads)
      ps[(idx / n) * lds + idx % n] = p_w[idx];
    __syncthreads();

    T* d_base = dqkv + (size_t)win * n * c3 + h * hd;
    // dV[j, d] = sum_i P[i, j] g[i, d]
    for (int idx = tid; idx < n * hd; idx += kAttnThreads) {
      const int j = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc += ps[i * lds + j] * gs[i * ld + d];
      d_base[(size_t)j * c3 + 2 * c + d] = from_f32<T>(acc);
    }
    // dP[i, j] = sum_d g[i, d] v[j, d]
    for (int idx = tid; idx < n * n; idx += kAttnThreads) {
      const int i = idx / n, j = idx % n;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc += gs[i * ld + d] * v[j * ld + d];
      ds[i * lds + j] = acc;
    }
    __syncthreads();

    // dS = P * (dP - rowsum(dP * P)), one warp per row
    for (int i = warp; i < n; i += kAttnThreads / 32) {
      const float* pr = ps + i * lds;
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

    // dQ[i, d] = scale * sum_j dS[i, j] k[j, d];
    // dK[i, d] = sum_j dS[j, i] (scale q)[j, d]
    for (int idx = tid; idx < n * hd; idx += kAttnThreads) {
      const int i = idx / hd, d = idx % hd;
      float acc_q = 0.f, acc_k = 0.f;
      for (int j = 0; j < n; ++j) {
        acc_q += ds[i * lds + j] * k[j * ld + d];
        acc_k += ds[j * lds + i] * q[j * ld + d];
      }
      d_base[(size_t)i * c3 + d] = from_f32<T>(acc_q * scale);
      d_base[(size_t)i * c3 + c + d] = from_f32<T>(acc_k);
    }
    __syncthreads();  // the next window overwrites shared memory
  }

  float* dbias_h = dbias + (size_t)h * n * n;
  for (int idx = tid; idx < n * n; idx += kAttnThreads)
    atomicAdd(dbias_h + idx, db[idx]);
}

template <typename K>
static cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, bool kSaveP, typename Src>
static int launch_fwd(const Src& src, const float* bias, float* p, int b_,
                      int n, int hd, int nh, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * n * (hd + 1) + n * (n + 1));
  auto kernel = window_attention_kernel<T, kSaveP, Src>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b_, nh);
  kernel<<<grid, kAttnThreads, smem, stream>>>(src, bias, p, n, hd, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool kSaveP>
static int launch_packed(const void* qkv, const float* bias,
                         const float* mask, void* out, float* p, int b_,
                         int n, int c, int nh, int nw, float scale,
                         cudaStream_t stream) {
  const PackedQkv<T> src{static_cast<const T*>(qkv), mask,
                         static_cast<T*>(out), n, c, c / nh, nw};
  return launch_fwd<T, kSaveP>(src, bias, p, b_, n, c / nh, nh, scale,
                               stream);
}

template <typename T>
static int launch_bwd(const void* qkv, const float* p, const void* g,
                      void* dqkv, float* dbias, int b_, int n, int c, int nh,
                      float scale, cudaStream_t stream) {
  const int hd = c / nh;
  const size_t smem =
      sizeof(float) * (4 * n * (hd + 1) + 2 * n * (n + 1) + n * n);
  auto kernel = window_attention_bwd_kernel<T>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((b_ + kBwdWindows - 1) / kBwdWindows, nh);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(qkv), p, static_cast<const T*>(g),
      static_cast<T*>(dqkv), dbias, b_, n, c, nh, scale);
  return (int)cudaGetLastError();
}

}  // namespace swindet

// mask may be null (no shift); otherwise it is (nW, N, N) fp32 and window w
// of the batch reads mask[w % nW].
SWINDET_EXPORT int swindet_window_attention(const void* qkv, const float* bias,
                                            const float* mask, void* out,
                                            int b_, int n, int c, int nh,
                                            int nw, float scale, int dtype,
                                            void* stream) {
  using namespace swindet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_ == 0) return (int)cudaSuccess;
  if (dtype == kBFloat16)
    return launch_packed<__nv_bfloat16, false>(qkv, bias, mask, out, nullptr,
                                               b_, n, c, nh, nw, scale, s);
  if (dtype == kFloat32)
    return launch_packed<float, false>(qkv, bias, mask, out, nullptr, b_, n,
                                       c, nh, nw, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The same forward, which also writes the fp32 softmax p (nH, B_, N, N).
SWINDET_EXPORT int swindet_window_attention_fwd_p(
    const void* qkv, const float* bias, const float* mask, void* out,
    float* p, int b_, int n, int c, int nh, int nw, float scale, int dtype,
    void* stream) {
  using namespace swindet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_ == 0) return (int)cudaSuccess;
  if (dtype == kBFloat16)
    return launch_packed<__nv_bfloat16, true>(qkv, bias, mask, out, p, b_, n,
                                              c, nh, nw, scale, s);
  if (dtype == kFloat32)
    return launch_packed<float, true>(qkv, bias, mask, out, p, b_, n, c, nh,
                                      nw, scale, s);
  return (int)cudaErrorInvalidValue;
}

// qkv (B_, N, 3C) and g (B_, N, C) in `dtype`, p (nH, B_, N, N) fp32;
// writes dqkv (B_, N, 3C) in `dtype` and adds dBias into dbias (nH, N, N)
// fp32, which the caller zeroes.
SWINDET_EXPORT int swindet_window_attention_bwd(
    const void* qkv, const float* p, const void* g, void* dqkv, float* dbias,
    int b_, int n, int c, int nh, float scale, int dtype, void* stream) {
  using namespace swindet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_ == 0) return (int)cudaSuccess;
  if (dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16>(qkv, p, g, dqkv, dbias, b_, n, c, nh,
                                     scale, s);
  if (dtype == kFloat32)
    return launch_bwd<float>(qkv, p, g, dqkv, dbias, b_, n, c, nh, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The v1 forward over head-major q, k, v (B_, nH, N, hd) of `dtype`; mask
// (nW, N, N) fp32 or null, window w reading mask[w % nW]; out (B_, N, C).
SWINDET_EXPORT int swindet_window_attention_heads(
    const void* q, const void* k, const void* v, const float* bias,
    const float* mask, void* out, int b_, int n, int c, int nh, int nw,
    float scale, int dtype, void* stream) {
  using namespace swindet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_ == 0) return (int)cudaSuccess;
  const int hd = c / nh;
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    const HeadMajorQkv<T> src{static_cast<const T*>(q),
                              static_cast<const T*>(k),
                              static_cast<const T*>(v), mask,
                              static_cast<T*>(out), n, c, hd, nh, nw};
    return launch_fwd<T, false>(src, bias, nullptr, b_, n, hd, nh, scale, s);
  }
  if (dtype == kFloat32) {
    const HeadMajorQkv<float> src{static_cast<const float*>(q),
                                  static_cast<const float*>(k),
                                  static_cast<const float*>(v), mask,
                                  static_cast<float*>(out), n, c, hd, nh,
                                  nw};
    return launch_fwd<float, false>(src, bias, nullptr, b_, n, hd, nh, scale,
                                    s);
  }
  return (int)cudaErrorInvalidValue;
}

// Shifted-window attention over the padded qkv map (B, Hp, Wp, 3C) of
// `dtype`, Hp and Wp multiples of ws: out (B, Hp, Wp, C) in rolled
// coordinates.
SWINDET_EXPORT int swindet_swin_attention(const void* qkv, const float* bias,
                                          void* out, int b, int hp, int wp,
                                          int c, int nh, int ws, int shift,
                                          float scale, int dtype,
                                          void* stream) {
  using namespace swindet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int windows = b * (hp / ws) * (wp / ws);
  if (windows == 0) return (int)cudaSuccess;
  const int hd = c / nh, n = ws * ws;
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    const SwinMap<T> src{static_cast<const T*>(qkv), static_cast<T*>(out),
                         hp, wp, c, hd, ws, shift};
    return launch_fwd<T, false>(src, bias, nullptr, windows, n, hd, nh,
                                scale, s);
  }
  if (dtype == kFloat32) {
    const SwinMap<float> src{static_cast<const float*>(qkv),
                             static_cast<float*>(out), hp, wp, c, hd, ws,
                             shift};
    return launch_fwd<float, false>(src, bias, nullptr, windows, n, hd, nh,
                                    scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
