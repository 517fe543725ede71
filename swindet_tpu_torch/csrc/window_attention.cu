// Swin window attention: the inference forward, the training forward that
// also writes the softmax, and the backward.
//
// Forward:
//   out[w, :, h] = softmax(q_h k_h^T * hd^-1/2 + bias[h] + mask[w mod nW]) v_h
// for every window w and head h, reading the packed qkv projection
// (B_, N, 3C) = [q | k | v] with heads contiguous inside each third, and
// writing head h's lanes of the packed (B_, N, C) output directly.
// Backward, from the saved fp32 softmax P and the output gradient g:
//   dV = P^T g, dP = g V^T, dS = P * (dP - rowsum(dP * P)),
//   dQ = scale * dS K, dK = dS^T (scale * Q), dBias[h] = sum_w dS.
//
// Replaces: swindet_tpu/ops/window_attention_v3.py · _wattn3_kernel (:38,
// via _wattn3_fwd_impl, pallas_call at :293), called from every Swin block
// (models/backbones/swin.py:265-274); with the softmax saved,
// _wattn3_kernel_p (:209, via _wattn3_fwd_p_impl, pallas_call at :253);
// the backward, _wattn3_bwd_kernel (:119, via _wattn3_bwd_impl,
// pallas_call at :189).
//
// Bound: bytes. At N = 49 tokens and hd = 32 one (window, head) pair of
// the forward does ~0.31 MFLOP on ~9.4 KB of bf16 q/k/v (~33 flop/byte,
// against the card's ~295 flop/byte ridge); the backward ~0.77 MFLOP on
// q, k, v, g and the 9.6 KB fp32 P in, dq, dk, dv out. Every main-path
// stage of Swin-T/S/B has N = 49 and hd = 32: N pads to one 64-row tile
// and hd is two k16 steps, so the products suit the tensor cores.
//
// bf16 with hd a multiple of 16 up to 64 (the main path): tensor cores,
// mma.sync m16n8k16 (bf16 in, fp32 accumulation) on ldmatrix fragments.
// A head's tokens are padded to 64 rows with zeros in shared memory and
// four warps own its four 16-row tiles.
//   wattn_fwd_tc_kernel (row 2): one block per window and group of up to
//   three heads (ops/window_attention_v3.py fwd_geometry picks the group
//   so the grid fills the card). The block stages the group's q, k and v
//   rows with 16-byte cp.async copies (each row of a head is 2 hd
//   contiguous bytes), its heads' bias, and the window's mask once for all
//   its heads, all issued before it waits. A warp's S = Q K^T stays in
//   its accumulator registers, is multiplied by scale in fp32, gets the
//   head's bias and the mask, -inf past column N, and the softmax in fp32
//   with the row max and sum over the four lanes that share a row. P is
//   rounded to bf16 (as the TPU kernel feeds P in the
//   compute type to the second product) and repacked in place as the A
//   operand of P V (FlashAttention-2's register trick); the output is
//   staged in the warp's own q rows and leaves in 16-byte stores.
//   With kSaveP (row 6, the training forward) the same kernel also writes
//   the fp32 P, the normalised logits in registers before the bf16
//   rounding. A warp's 16 rows of p[h, w] are one contiguous span of
//   16 N floats that starts on a 4-byte boundary only (N x N blocks of
//   odd N), so float2 or float4 stores straight from the accumulator
//   layout would be misaligned for half the rows, and scalar stores from
//   it touch eight rows per instruction. Instead each warp stages its
//   span in shared memory and leaves it in coalesced 4-byte stores, 128
//   contiguous bytes an instruction: every byte of P is written once, in
//   full sectors but at the span's two ends. The staging reuses the k
//   tiles, the bias and the mask, which no warp reads once the logits
//   are in registers (one barrier after the logits): for that the P
//   variant orders the tiles q, v, k, so that the k tiles, the bias and
//   the mask are one region (tc_fwd_smem counts a larger block only
//   where that region is smaller than the staging, which no Swin shape
//   asks for).
//   wattn_bwd_tc_kernel (row 7): one block per head and group of windows
//   (bwd_geometry), the next window's q, k, v and g copied into a second
//   buffer while the block works on the current one. Per window and
//   16-row tile: dP = g V^T; dS in fp32 from the fp32 P, read into the
//   accumulator layout; P and dS rounded to bf16 into shared memory;
//   dQ = scale dS K with dS repacked as the A operand; then, once every
//   tile's P and dS are in, dV = P^T g and dK = scale dS^T Q with the
//   transposed operands through ldmatrix.trans. dBias sums the fp32 dS
//   (never a rounded copy) in registers over the block's windows and adds
//   that partial to the zeroed fp32 dBias with one atomicAdd per entry.
//   The atomics' order varies between runs, so dBias varies in its last
//   bits.
//
// fp32 and other head widths: the SIMT kernels, kept as first written.
// window_attention_kernel runs one block per (window, head): q (pre-scaled,
// fp32), k and v in shared memory with rows padded by one float, the N x N
// logits in shared memory, the softmax one warp per row in fp32 (writing
// the fp32 probabilities with coalesced stores when they are saved, for
// the training forward off the tensor cores), the probabilities rounded
// to the input type, and P v accumulated in fp32. window_attention_bwd_kernel
// runs one block per (group of kBwdWindows windows, head) and computes the
// five products from shared memory in fp32; the TPU kernel carries dBias
// across its sequential grid (:135-137), here each block sums dS of its
// windows in shared memory and adds it with one atomicAdd per entry.
//
// Two more TPU kernels that only the JAX package's op tests run:
// - swindet_window_attention_heads replaces swindet_tpu/ops/
//   window_attention.py · _wattn_kernel (:30, via
//   _window_attention_fwd_impl, pallas_call at :141): the v1 attention over
//   head-major (B_, nH, N, hd) q, k, v. The TPU padded N to a sublane
//   multiple and masked the padded keys with -1e30; here the loops stop at
//   N (the tensor-core kernel sets the padded keys to -inf), and window w
//   reads mask[w mod nW] with no tiled copy. It computes row 2's function
//   from another layout, so it runs row 2's kernels: in bf16 with hd in
//   {16, 32, 48, 64}, swindet_window_attention_heads_tc, which is
//   wattn_fwd_tc_kernel with the HeadMajorTc staging policy (each
//   (window, head)'s q, k and v is one contiguous n x hd span, copied in
//   16-byte cp.async chunks along it; everything after the staging, and
//   the packed (B_, N, C) output, is row 2's); otherwise the SIMT
//   window_attention_kernel with the HeadMajorQkv source policy.
// - swindet_swin_attention replaces swindet_tpu/ops/swin_attention.py ·
//   _swin_attn_kernel (:46, via _swin_attn_fwd_impl, pallas_call at :149):
//   the cyclic roll, window partition and attention over the padded qkv map
//   (B, Hp, Wp, 3C) in one pass, the output written in rolled coordinates
//   (the TPU read row blocks i and i + 1 mod nHb). Its arithmetic is row
//   2's at the same windows, so it runs row 2's kernels too: in
//   bf16 with hd in {16, 32, 48, 64}, swindet_swin_attention_tc, which is
//   wattn_fwd_tc_kernel with the SwinMapTc staging policy. A pixel's row of
//   the map is laid out as a token row of the packed projection, so the
//   copies are PackedTc's, each starting at the wrapped pixel (a
//   conditional subtract: only the last window row and column wrap). The
//   map has no mask input: only windows of the last window row or column
//   mix shift regions, so only there (one uniform branch a block) does the
//   block build its tokens' region ids in shared memory (n bytes) and add
//   -100 to the logits where a row's and a column's ids differ. The
//   epilogue's 16-byte stores go to each token's rolled pixel (store_tile
//   with a row address). Otherwise the SIMT window_attention_kernel with the
//   SwinMap source policy, which reads each element at its rolled position
//   and rebuilds the mask from region ids per logit.
// The SIMT forward body reads each layout through a source policy
// (PackedQkv above, HeadMajorQkv, SwinMap). Both kernels are bound by
// bytes as the forward above. Their backward recomputes through the plain
// version in PyTorch, as the JAX package's does.
#include "mma_sync.cuh"

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

// ------------------------------------------------- bf16 tensor-core kernels
// N <= 64 tokens padded to kTcRows, hd in {16, 32, 48, 64}. Each head's q,
// k, v (and g) tile is 64 rows of hd + 8 bf16 values: the 16 extra bytes a
// row put the eight rows an ldmatrix phase reads on distinct banks and
// keep every row on a 16-byte boundary for cp.async.

constexpr int kTcWarpsPerHead = kTcRows / 16;
constexpr int kTcHeadThreads = 32 * kTcWarpsPerHead;
constexpr int kTcMaxHeads = 3;            // heads per forward block

// Zero rows n .. kTcRows - 1 of `ntiles` consecutive tiles of HD + 8
// columns, with `threads` threads.
template <int HD>
__device__ __forceinline__ void zero_pad_rows(__nv_bfloat16* tiles,
                                              int ntiles, int n,
                                              int threads) {
  constexpr int P = HD + 8, RC = P / 8;  // 16-byte chunks a row
  const int per_tile = (kTcRows - n) * RC;
  for (int e = threadIdx.x; e < ntiles * per_tile; e += threads) {
    const int tile = e / per_tile, r = e % per_tile;
    *reinterpret_cast<uint4*>(tiles + (size_t)tile * kTcRows * P +
                              (n + r / RC) * P + (r % RC) * 8) =
        make_uint4(0, 0, 0, 0);
  }
}

// Where a tensor-core forward block finds its heads' q (part 0), k (1) and
// v (2), and where it writes its output. `window` turns the block's window
// index into the policy's handle w of that window, made once a block.
// `split` names 16-byte chunk e of the group's 3 x heads x n x CH chunks by
// (part, head hl of the group, row i, column d), numbered so that
// consecutive threads copy consecutive bytes of the source; `at` is that
// chunk's address for head h of window w; `out_row` is where token i of
// window w writes its C outputs. With kRegions the policy has no mask
// input: `mixed` tells whether window w mixes shift regions, and `region`
// gives token i's region there.

// The packed projection (B_, N, 3C), heads contiguous in each third (rows
// 2 and 6): a token's row holds the group's q, k and v chunks side by side.
struct PackedTc {
  static constexpr bool kRegions = false;
  const __nv_bfloat16* qkv;
  int c;
  __device__ __forceinline__ int window(int win) const { return win; }
  __device__ __forceinline__ void split(int e, int heads, int n, int ch,
                                        int& part, int& hl, int& i,
                                        int& d) const {
    const int row_chunks = 3 * heads * ch, r = e % row_chunks;
    i = e / row_chunks;
    part = r / (heads * ch);
    hl = (r / ch) % heads;
    d = (r % ch) * 8;
  }
  __device__ __forceinline__ const __nv_bfloat16* at(int win, int h,
                                                     int part, int i, int d,
                                                     int n, int hd) const {
    return qkv + ((size_t)win * n + i) * 3 * c + part * c + h * hd + d;
  }
  __device__ __forceinline__ __nv_bfloat16* out_row(__nv_bfloat16* out,
                                                    int win, int i,
                                                    int n) const {
    return out + ((size_t)win * n + i) * c;
  }
};

// Head-major q, k and v, each (B_, nH, N, hd) (row 14): a (window, head)'s
// q, k or v is one contiguous n x hd span, walked chunk after chunk.
struct HeadMajorTc {
  static constexpr bool kRegions = false;
  const __nv_bfloat16 *q, *k, *v;
  int nh, c;
  __device__ __forceinline__ int window(int win) const { return win; }
  __device__ __forceinline__ void split(int e, int heads, int n, int ch,
                                        int& part, int& hl, int& i,
                                        int& d) const {
    const int span = n * ch, r = e % span;
    part = e / (heads * span);
    hl = (e / span) % heads;
    i = r / ch;
    d = (r % ch) * 8;
  }
  __device__ __forceinline__ const __nv_bfloat16* at(int win, int h,
                                                     int part, int i, int d,
                                                     int n, int hd) const {
    const __nv_bfloat16* base = part == 0 ? q : (part == 1 ? k : v);
    return base + (((size_t)win * nh + h) * n + i) * hd + d;
  }
  __device__ __forceinline__ __nv_bfloat16* out_row(__nv_bfloat16* out,
                                                    int win, int i,
                                                    int n) const {
    return out + ((size_t)win * n + i) * c;
  }
};

// The padded qkv map (B, Hp, Wp, 3C) of a shifted block (row 15), the
// output (B, Hp, Wp, C) in rolled coordinates. A pixel's row is laid out as
// a token row of the packed projection, so `split` is PackedTc's. Window
// win is (image b, window row wy, window column wx), row-major; its token i
// sits at rolled position (y, x) = (ws wy + i / ws, ws wx + i % ws) and
// reads map pixel (y + shift, x + shift), less Hp or Wp where that passes
// the edge (only the last window row and column wrap). The region of a
// rolled row y is 0 below Hp - ws, 1 below Hp - shift and 2 above, the
// same for columns (the reference's img_mask slices), so only windows of
// the last window row or column mix regions, and none without a shift.
struct SwinMapTc : PackedTc {
  static constexpr bool kRegions = true;
  // nwy x nwx windows an image; ws_inv = ceil(2^16 / ws), so that
  // (i ws_inv) >> 16 = i / ws for every token i < 64 (the error,
  // i / 2^16 < 1 / 1024, stays under the 1 / ws to the next integer)
  int hp, wp, ws, shift, nwy, nwx, ws_inv;
  // a window: its image and the rolled position of its token 0
  struct Window {
    int b, y0, x0;
  };
  __device__ __forceinline__ Window window(int win) const {
    const int per_img = nwy * nwx, b = win / per_img, w = win - b * per_img;
    const int wy = w / nwx;
    return {b, wy * ws, (w - wy * nwx) * ws};
  }
  // token i's rolled position
  __device__ __forceinline__ void pos(const Window& w, int i, int& y,
                                      int& x) const {
    const int r = (i * ws_inv) >> 16;
    y = w.y0 + r;
    x = w.x0 + i - r * ws;
  }
  __device__ __forceinline__ const __nv_bfloat16* at(const Window& w, int h,
                                                     int part, int i, int d,
                                                     int n, int hd) const {
    int y, x;
    pos(w, i, y, x);
    y += shift;
    if (y >= hp) y -= hp;
    x += shift;
    if (x >= wp) x -= wp;
    return qkv + (((size_t)w.b * hp + y) * wp + x) * 3 * c + part * c +
           h * hd + d;
  }
  __device__ __forceinline__ bool mixed(const Window& w) const {
    return shift && (w.y0 == hp - ws || w.x0 == wp - ws);
  }
  __device__ __forceinline__ unsigned char region(const Window& w,
                                                  int i) const {
    int y, x;
    pos(w, i, y, x);
    const int ry = y < hp - ws ? 0 : (y < hp - shift ? 1 : 2);
    const int rx = x < wp - ws ? 0 : (x < wp - shift ? 1 : 2);
    return (unsigned char)(3 * ry + rx);
  }
  __device__ __forceinline__ __nv_bfloat16* out_row(__nv_bfloat16* out,
                                                    const Window& w, int i,
                                                    int n) const {
    int y, x;
    pos(w, i, y, x);
    return out + (((size_t)w.b * hp + y) * wp + x) * c;
  }
};

// Shared memory of the two kernels (ops/window_attention_v3.py
// tc_fwd_smem and tc_bwd_smem compute the same). With regions (row 15, no
// mask) the window's n region ids, a byte each, follow the bias. With
// save_p the P staging, 16 rows of n floats for each of the block's 4
// heads warps, starts at the k tiles (the tiles ordered q, v, k) and may
// run past the mask: the block is the larger of the two.
template <int HD>
size_t tc_fwd_smem(int heads, int n, bool masked, bool save_p,
                   bool regions = false) {
  const size_t tiles = 2 * 3 * (size_t)heads * kTcRows * (HD + 8);
  const size_t base = tiles + 4 * (size_t)(heads + masked) * n * n +
                      (regions ? n : 0);
  if (!save_p) return base;
  const size_t staged = tiles / 3 * 2 +
                        4 * (size_t)heads * kTcWarpsPerHead * 16 * n;
  return base > staged ? base : staged;
}

template <int HD>
size_t tc_bwd_smem() {
  return 2 * (2 * 4 * (size_t)kTcRows * (HD + 8)  // q, k, v, g, twice
              + 2 * kTcRows * kTcPitchP            // P and dS in bf16
              + kTcWarpsPerHead * 16 * (HD + 8));  // staging tiles
}

// Row 2 (Src PackedTc), with kSaveP row 6, row 14 (Src HeadMajorTc) and
// row 15 (Src SwinMapTc). Block (window blockIdx.x, heads blockIdx.y *
// heads ..): warp w owns rows 16 (w % 4) .. of head w / 4 of the group.
// Shared memory: the group's q tiles, then its k tiles, then its v tiles
// (with kSaveP q, v, k), then the group's bias (heads x n x n fp32), then
// the window's mask (n x n fp32) where there is one, or with
// Src::kRegions the window's region ids (n bytes) where it mixes regions.
// Every byte comes in by cp.async before the block waits. With kSaveP, p
// is the fp32 softmax (nH, B_, N, N), B_ = gridDim.x.
template <int HD, bool kSaveP, typename Src>
__global__ void __launch_bounds__(kTcMaxHeads * kTcHeadThreads, 2)
wattn_fwd_tc_kernel(const Src src, const float* __restrict__ bias,
                    const float* __restrict__ mask,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ p,
                    int n, int c, int nw, int heads, float scale) {
  constexpr int P = HD + 8, TILE = kTcRows * P, CH = HD / 8;
  // tile slots of k and v: the P variant puts k last, beside the bias and
  // mask whose room it shares with the P staging
  constexpr int kSlotK = kSaveP ? 2 : 1, kSlotV = kSaveP ? 1 : 2;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  float* bsm = reinterpret_cast<float*>(sm + 3 * heads * TILE);
  float* msk = bsm + heads * n * n;
  [[maybe_unused]] unsigned char* reg =
      reinterpret_cast<unsigned char*>(msk);
  const int win = blockIdx.x, h0 = blockIdx.y * heads;
  const int threads = heads * kTcHeadThreads;
  const auto w = src.window(win);

  // the group's q, k and v rows, 16 bytes a copy
  for (int e = threadIdx.x; e < 3 * heads * n * CH; e += threads) {
    int part, hl, i, d;
    src.split(e, heads, n, CH, part, hl, i, d);
    const int slot = kSaveP ? (3 - part) % 3 : part;
    cp_async16(sm + (slot * heads + hl) * TILE + i * P + d,
               src.at(w, h0 + hl, part, i, d, n, HD));
  }
  // the group's bias and the window's mask, 4 bytes a copy (an n x n
  // block of odd n starts on no 16-byte boundary)
  const float* bg = bias + (size_t)h0 * n * n;
  for (int e = threadIdx.x; e < heads * n * n; e += threads)
    cp_async4(bsm + e, bg + e);
  if (mask) {
    const float* mw = mask + (size_t)(win % nw) * n * n;
    for (int e = threadIdx.x; e < n * n; e += threads)
      cp_async4(msk + e, mw + e);
  }
  cp_async_commit();
  zero_pad_rows<HD>(sm, 3 * heads, n, threads);
  // the shift mask of a window that mixes regions, from its region ids:
  // one uniform branch a block
  [[maybe_unused]] bool mixed = false;
  if constexpr (Src::kRegions) {
    mixed = src.mixed(w);
    if (mixed)
      for (int e = threadIdx.x; e < n; e += threads)
        reg[e] = src.region(w, e);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hl = warp / kTcWarpsPerHead, m0 = 16 * (warp % kTcWarpsPerHead);
  const int gq = lane >> 2, t = lane & 3;
  __nv_bfloat16* q_s = sm + hl * TILE;
  const __nv_bfloat16* k_s = sm + (kSlotK * heads + hl) * TILE;
  const __nv_bfloat16* v_s = sm + (kSlotV * heads + hl) * TILE;

  // S = Q K^T over the 64 padded keys
  float s[kTcKeyTiles][4] = {};
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

  // logits and softmax in fp32: this lane holds rows m0 + gq and
  // m0 + gq + 8, columns 8 nt + 2 t + {0, 1}
  const float* bias_h = bsm + hl * n * n;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + gq + (e >> 1) * 8, j = nt * 8 + 2 * t + (e & 1);
      float v = -INFINITY;
      if (j < n) {
        v = s[nt][e] * scale;
        if (i < n) {
          v += bias_h[i * n + j];
          if (mask) v += msk[i * n + j];
        }
      }
      s[nt][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  if constexpr (Src::kRegions) {
    // the shift mask, after the bias as the reference adds it, in the
    // windows that mix regions only: the others skip the pass
    if (mixed) {
      mx[0] = mx[1] = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = m0 + gq + (e >> 1) * 8, j = nt * 8 + 2 * t + (e & 1);
          if (i < n && j < n && reg[i] != reg[j]) s[nt][e] += -100.f;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
    }
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
    inv[r] = 1.f / sum[r];
  }
#pragma unroll
  for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];

  if constexpr (kSaveP) {
    // every warp's logits are in registers: the k tiles, the bias and the
    // mask are free. This warp's rows of the fp32 P (before the bf16
    // rounding below) go to its 16 x n staging span there, then to
    // p[h, w] rows m0 .. in coalesced stores.
    __syncthreads();
    float* st = reinterpret_cast<float*>(sm + 2 * heads * TILE) +
                warp * 16 * n;
#pragma unroll
    for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gq + (e >> 1) * 8, j = nt * 8 + 2 * t + (e & 1);
        if (m0 + r < n && j < n) st[r * n + j] = s[nt][e];
      }
    __syncwarp();
    float* dst = p + ((size_t)(h0 + hl) * gridDim.x + win) * n * n +
                 (size_t)m0 * n;
    const int count = min(16, n - m0) * n;
    for (int e = lane; e < count; e += 32) dst[e] = st[e];
  }

  // O = round(P) V
  float o[HD / 8][4] = {};
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
  // this warp's q rows, which no other warp reads, stage its output
  store_tile<HD>(
      o, 1.f, q_s + m0 * P,
      [=](int i) { return src.out_row(out, w, i, n) + (h0 + hl) * HD; },
      m0, n, lane);
}

// Row 7. Block (windows blockIdx.x * windows .., head blockIdx.y): warp w
// owns rows 16 w .. of the head's tiles. Shared memory: two buffers of the
// q, k, v and g tiles, then P and dS in bf16 (64 x kTcPitchP each), then
// one staging tile a warp.
template <int HD>
__global__ void __launch_bounds__(kTcHeadThreads, 3)
wattn_bwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                    const float* __restrict__ p,
                    const __nv_bfloat16* __restrict__ g,
                    __nv_bfloat16* __restrict__ dqkv,
                    float* __restrict__ dbias, int b_, int n, int c,
                    int windows, float scale) {
  constexpr int P = HD + 8, TILE = kTcRows * P, CH = HD / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sp = bufs + 8 * TILE;
  __nv_bfloat16* sds = sp + kTcRows * kTcPitchP;
  const int h = blockIdx.y;
  const int w0 = blockIdx.x * windows, w_end = min(w0 + windows, b_);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3, m0 = 16 * warp;
  __nv_bfloat16* st = sds + kTcRows * kTcPitchP + warp * 16 * P;

  // the q, k, v and g rows of window win into buffer b (tiles 4 b ..)
  auto stage = [&](int win, int b) {
    const __nv_bfloat16* base = qkv + (size_t)win * n * 3 * c + h * HD;
    const __nv_bfloat16* gb = g + (size_t)win * n * c + h * HD;
    for (int e = threadIdx.x; e < n * 4 * CH; e += kTcHeadThreads) {
      const int i = e / (4 * CH), part = (e / CH) % 4, d = (e % CH) * 8;
      const __nv_bfloat16* from =
          part < 3 ? base + (size_t)i * 3 * c + part * c + d
                   : gb + (size_t)i * c + d;
      cp_async16(bufs + (4 * b + part) * TILE + i * P + d, from);
    }
    cp_async_commit();
  };
  stage(w0, 0);
  zero_pad_rows<HD>(bufs, 8, n, kTcHeadThreads);

  float db[kTcKeyTiles][4] = {};
  for (int win = w0, b = 0; win < w_end; ++win, b ^= 1) {
    const bool more = win + 1 < w_end;
    if (more) stage(win + 1, b ^ 1);
    // this lane's entries of the fp32 P, zero outside N x N
    const float* pw = p + ((size_t)h * b_ + win) * n * n;
    float pf[kTcKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + gq + (e >> 1) * 8, j = nt * 8 + 2 * t + (e & 1);
        pf[nt][e] = i < n && j < n ? __ldg(pw + i * n + j) : 0.f;
      }
    if (more)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16* q_s = bufs + 4 * b * TILE;
    const __nv_bfloat16* k_s = q_s + TILE;
    const __nv_bfloat16* v_s = k_s + TILE;
    const __nv_bfloat16* g_s = v_s + TILE;

    attention_bwd_tile<HD>(pf, q_s, k_s, v_s, g_s, sp, sds, st,
                           dqkv + (size_t)win * n * 3 * c + h * HD, c, db, n,
                           scale, m0, lane);
    __syncthreads();  // buffer b, P and dS are free for the next windows
  }

  // this block's sum of dS over its windows, one atomic per entry
  float* dbias_h = dbias + (size_t)h * n * n;
#pragma unroll
  for (int nt = 0; nt < kTcKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + gq + (e >> 1) * 8, j = nt * 8 + 2 * t + (e & 1);
      if (i < n && j < n) atomicAdd(dbias_h + i * n + j, db[nt][e]);
    }
}

template <int HD, bool kSaveP, typename Src>
static int launch_fwd_tc(const Src& src, const float* bias,
                         const float* mask, void* out, float* p, int b_,
                         int n, int c, int nh, int nw, float scale,
                         int heads, cudaStream_t stream) {
  const size_t smem =
      tc_fwd_smem<HD>(heads, n, mask != nullptr, kSaveP, Src::kRegions);
  auto kernel = wattn_fwd_tc_kernel<HD, kSaveP, Src>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b_, nh / heads);
  kernel<<<grid, heads * kTcHeadThreads, smem, stream>>>(
      src, bias, mask, static_cast<__nv_bfloat16*>(out), p, n, c, nw, heads,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch_bwd_tc(const void* qkv, const float* p, const void* g,
                         void* dqkv, float* dbias, int b_, int n, int c,
                         int nh, float scale, int windows,
                         cudaStream_t stream) {
  const size_t smem = tc_bwd_smem<HD>();
  auto kernel = wattn_bwd_tc_kernel<HD>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((b_ + windows - 1) / windows, nh);
  kernel<<<grid, kTcHeadThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), p,
      static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(dqkv), dbias, b_, n, c, windows, scale);
  return (int)cudaGetLastError();
}

}  // namespace swindet

// The bf16 tensor-core forward (row 2): as swindet_window_attention for
// bf16 qkv with N <= 64 and hd in {16, 32, 48, 64}, 16-byte aligned qkv
// and out; `heads` heads a block (1-3, dividing nH).
SWINDET_EXPORT int swindet_window_attention_tc(
    const void* qkv, const float* bias, const float* mask, void* out, int b_,
    int n, int c, int nh, int nw, float scale, int heads, void* stream) {
  using namespace swindet;
  if (b_ == 0) return (int)cudaSuccess;
  if (n > kTcRows || heads < 1 || heads > kTcMaxHeads || nh % heads)
    return (int)cudaErrorInvalidValue;
  const PackedTc src{static_cast<const __nv_bfloat16*>(qkv), c};
  return by_head_dim(c / nh, [&](auto hd) {
    return launch_fwd_tc<decltype(hd)::value, false>(
        src, bias, mask, out, nullptr, b_, n, c, nh, nw, scale, heads,
        static_cast<cudaStream_t>(stream));
  });
}

// The bf16 tensor-core training forward (row 6): as
// swindet_window_attention_fwd_p with the shapes, alignment and `heads`
// of swindet_window_attention_tc.
SWINDET_EXPORT int swindet_window_attention_fwd_p_tc(
    const void* qkv, const float* bias, const float* mask, void* out,
    float* p, int b_, int n, int c, int nh, int nw, float scale, int heads,
    void* stream) {
  using namespace swindet;
  if (b_ == 0) return (int)cudaSuccess;
  if (n > kTcRows || heads < 1 || heads > kTcMaxHeads || nh % heads)
    return (int)cudaErrorInvalidValue;
  const PackedTc src{static_cast<const __nv_bfloat16*>(qkv), c};
  return by_head_dim(c / nh, [&](auto hd) {
    return launch_fwd_tc<decltype(hd)::value, true>(
        src, bias, mask, out, p, b_, n, c, nh, nw, scale, heads,
        static_cast<cudaStream_t>(stream));
  });
}

// The bf16 tensor-core backward (row 7): as swindet_window_attention_bwd
// for bf16 qkv and g with N <= 64 and hd in {16, 32, 48, 64}, 16-byte
// aligned; `windows` windows a block.
SWINDET_EXPORT int swindet_window_attention_bwd_tc(
    const void* qkv, const float* p, const void* g, void* dqkv, float* dbias,
    int b_, int n, int c, int nh, float scale, int windows, void* stream) {
  using namespace swindet;
  if (b_ == 0) return (int)cudaSuccess;
  if (n > kTcRows || windows < 1) return (int)cudaErrorInvalidValue;
  return by_head_dim(c / nh, [&](auto hd) {
    return launch_bwd_tc<decltype(hd)::value>(
        qkv, p, g, dqkv, dbias, b_, n, c, nh, scale, windows,
        static_cast<cudaStream_t>(stream));
  });
}

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

// The bf16 tensor-core v1 forward (row 14): as
// swindet_window_attention_heads for bf16 q, k, v with N <= 64 and hd in
// {16, 32, 48, 64}, 16-byte aligned q, k, v and out; `heads` heads a block
// (1-3, dividing nH), as swindet_window_attention_tc.
SWINDET_EXPORT int swindet_window_attention_heads_tc(
    const void* q, const void* k, const void* v, const float* bias,
    const float* mask, void* out, int b_, int n, int c, int nh, int nw,
    float scale, int heads, void* stream) {
  using namespace swindet;
  if (b_ == 0) return (int)cudaSuccess;
  if (n > kTcRows || heads < 1 || heads > kTcMaxHeads || nh % heads)
    return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  const HeadMajorTc src{static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), nh, c};
  return by_head_dim(c / nh, [&](auto hd) {
    return launch_fwd_tc<decltype(hd)::value, false>(
        src, bias, mask, out, nullptr, b_, n, c, nh, nw, scale, heads,
        static_cast<cudaStream_t>(stream));
  });
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

// The bf16 tensor-core form of swindet_swin_attention (row 15): bf16 qkv
// with ws^2 <= 64 and hd in {16, 32, 48, 64}, 16-byte aligned qkv and out;
// `heads` heads a block (1-3, dividing nH), as swindet_window_attention_tc.
SWINDET_EXPORT int swindet_swin_attention_tc(
    const void* qkv, const float* bias, void* out, int b, int hp, int wp,
    int c, int nh, int ws, int shift, float scale, int heads, void* stream) {
  using namespace swindet;
  const int windows = b * (hp / ws) * (wp / ws);
  if (windows == 0) return (int)cudaSuccess;
  const int n = ws * ws;
  if (n > kTcRows || heads < 1 || heads > kTcMaxHeads || nh % heads ||
      shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  const SwinMapTc src{{static_cast<const __nv_bfloat16*>(qkv), c},
                      hp, wp, ws, shift, hp / ws, wp / ws,
                      (65536 + ws - 1) / ws};
  return by_head_dim(c / nh, [&](auto hd) {
    return launch_fwd_tc<decltype(hd)::value, false>(
        src, bias, nullptr, out, nullptr, windows, n, c, nh, 1, scale, heads,
        static_cast<cudaStream_t>(stream));
  });
}
