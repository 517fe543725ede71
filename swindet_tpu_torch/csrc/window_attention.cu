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
#include "common.cuh"

namespace swindet {

constexpr int kAttnThreads = 128;
constexpr int kBwdWindows = 8;

template <typename T, bool kSaveP>
__global__ void __launch_bounds__(kAttnThreads)
window_attention_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ out,
                        float* __restrict__ p_out, int n, int c, int nh,
                        int nw, float scale) {
  extern __shared__ float smem[];
  const int hd = c / nh;
  const int ld = hd + 1;          // padded row of q, k, v
  const int lds = n + 1;          // padded row of the logits
  float* q = smem;
  float* k = q + n * ld;
  float* v = k + n * ld;
  float* s = v + n * ld;

  const int win = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const T* base = qkv + (size_t)win * n * 3 * c + h * hd;

  for (int idx = tid; idx < n * hd; idx += kAttnThreads) {
    const int i = idx / hd, d = idx % hd;
    const T* row = base + (size_t)i * 3 * c + d;
    q[i * ld + d] = to_f32(row[0]) * scale;
    k[i * ld + d] = to_f32(row[c]);
    v[i * ld + d] = to_f32(row[2 * c]);
  }
  __syncthreads();

  const float* bias_h = bias + (size_t)h * n * n;
  const float* mask_w = mask ? mask + (size_t)(win % nw) * n * n : nullptr;
  for (int idx = tid; idx < n * n; idx += kAttnThreads) {
    const int i = idx / n, j = idx % n;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc += q[i * ld + d] * k[j * ld + d];
    acc += bias_h[idx];
    if (mask_w) acc += mask_w[idx];
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

  T* out_base = out + (size_t)win * n * c + h * hd;
  for (int idx = tid; idx < n * hd; idx += kAttnThreads) {
    const int i = idx / hd, d = idx % hd;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc += s[i * lds + j] * v[j * ld + d];
    out_base[(size_t)i * c + d] = from_f32<T>(acc);
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

template <typename T, bool kSaveP>
static int launch_fwd(const void* qkv, const float* bias, const float* mask,
                      void* out, float* p, int b_, int n, int c, int nh,
                      int nw, float scale, cudaStream_t stream) {
  const int hd = c / nh;
  const size_t smem = sizeof(float) * (3 * n * (hd + 1) + n * (n + 1));
  auto kernel = window_attention_kernel<T, kSaveP>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b_, nh);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(qkv), bias, mask, static_cast<T*>(out), p, n, c,
      nh, nw, scale);
  return (int)cudaGetLastError();
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
    return launch_fwd<__nv_bfloat16, false>(qkv, bias, mask, out, nullptr,
                                            b_, n, c, nh, nw, scale, s);
  if (dtype == kFloat32)
    return launch_fwd<float, false>(qkv, bias, mask, out, nullptr, b_, n, c,
                                    nh, nw, scale, s);
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
    return launch_fwd<__nv_bfloat16, true>(qkv, bias, mask, out, p, b_, n, c,
                                           nh, nw, scale, s);
  if (dtype == kFloat32)
    return launch_fwd<float, true>(qkv, bias, mask, out, p, b_, n, c, nh, nw,
                                   scale, s);
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
