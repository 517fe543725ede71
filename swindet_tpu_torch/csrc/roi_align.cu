// Multilevel RoIAlign, forward and backward (mmcv semantics: aligned=True,
// adaptive sampling_ratio=0 with the per-axis sample count capped at g_max,
// or a fixed ratio), over NHWC FPN levels, one level per roi:
//   out[r, py, px, c] = mean over the bin's gy x gx samples of the bilinear
//                       tap of level lvl[r] at (y, x), channel c
//
// Replaces: swindet_tpu/ops/roi_align_pallas.py · _roi_align_kernel +
// _compute (via _roi_align_pallas_impl, pallas_call at :311) and
// _roi_align_bwd_kernel (via _roi_align_pallas_bwd_impl, pallas_call at
// :513), called from models/roi_heads/roi_extractor.py:78-86 for the bbox
// (7x7) and mask (14x14) extractors. Their contract is
// swindet_tpu/ops/roi_align.py:93 for every roi; the TPU kernels' strip
// passes and exact fallback tails served the TPU's DMA engine and have no
// counterpart here: every roi takes the same path.
//
// The separable form. A sample's validity (y < -1 or y > H drops it), its
// border clamp and its bilinear weights are each a product of a y part and
// an x part, and so is the bin's weight 1 / (gy gx). So
//   out[r] = A_y . F[level, image] . A_x^T,
// where A_y[py, y] sums, over the samples of bin row py, (1 / gy) times the
// y weight of each of the (at most two) cells y the sample touches, and A_x
// likewise; the backward is the transpose, dF += A_y^T . g[r] . A_x. A row
// of A holds at most 2 g nonzeros. Sample positions are computed once per
// roi, axis and sample with the plain version's separately rounded
// operations (sample_pos), and every sum is taken in fp32.
//
// Bound: memory. The forward reads the cells the samples touch (C values a
// cell) and writes the output; the backward reads g and writes every level
// once (the levels are mostly zeros: at batch 2 their writes are about 3/4
// of its bound). Both run far from it: the forward is held back by the
// per-block build of the lists and the latency of its loads, the backward
// by the fp32 multiply-adds of its per-roi sums, each tile cell taking
// one per channel and bin row that touches it.
//
// Forward design: a block per roi and group of 8 bins (C = 256), a warp
// per output bin, lanes over 8-channel groups. The block first builds, in
// shared memory, one sorted list of (cell, weight) per bin row and per bin
// column (the nonzeros of A_y and A_x); a warp then sums
// A_y[py, y] A_x[px, x] F[y, x, :] over its bin's two lists, issuing the
// 16-byte loads of two cell rows by two cell columns at once (a warp reads
// one 512-byte bf16 cell row per load at C = 256).
//
// Backward design: no atomics. A block per (level, image, 16 x 16 cell
// tile, 64-channel chunk), coarsest level first. It scans the rois in index
// order, all their loads issued together, and keeps those on its level and
// image whose window may overlap its tile. For up to 32 kept rois at a time
// it builds A_y and A_x restricted to the tile (a thread per roi, axis and
// bin) and, per tile row and column, the run of bins touching it; then each
// warp sums those rois, in index order and with no barrier, into the 4 x 8
// cells it holds in registers:
//   tile[y, x, :] += sum_py A_y[py, y] sum_px A_x[px, x] g[py, px, :],
// loading g in blocks of up to 4 x 2 bins at once and skipping the rows a
// bin row does not touch. It writes the tile once, in the features' dtype:
// cells that no roi touches are written as zeros. A tile whose scan keeps
// more than kDefer rois (rois piled on a few boxes, as a trained model's
// mask rois are) would sum them alone on one SM while most SMs idle: its
// block leaves it to a second kernel, in which a cluster of kSplit blocks
// on kSplit SMs sums it, each block a contiguous run of the kept rois, and
// adds the blocks' sums in rank order through distributed shared memory.
// The order
// of the adds is fixed by the roi index and the rank, so two runs are
// equal bit for bit, and no scratch level, zero fill or cast is needed.
// Routing (lvl) is computed by the caller so that the kernels and the
// plain versions route every roi identically.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace swindet {

namespace cg = cooperative_groups;

constexpr int kMaxLevels = 8;
constexpr int kVec = 8;            // channels a thread carries (C % 8 == 0)
constexpr int kFwdThreads = 256;
constexpr int kXUnroll = 2;        // cell columns a forward warp loads at once
constexpr int kTile = 16;          // backward tile: kTile x kTile cells
constexpr int kBwdGroups = 8;      // 8-channel groups a backward block takes
constexpr int kBwdChunk = kBwdGroups * kVec;  // 64 channels
constexpr int kBwdThreads = 256;
constexpr int kWarpRows = 4;       // a backward warp holds 4 x 8 cells
constexpr int kWarpCols = 8;
constexpr int kLaneCols = kWarpCols * kBwdGroups / 32;  // 2 a thread
static_assert(kWarpRows * kWarpCols * (kBwdThreads / 32) == kTile * kTile,
              "the warps of a backward block hold its tile");
constexpr int kGroup = 32;         // most rois a backward block builds at once
constexpr int kMaxBwdBins = 64;    // out_size of the backward
constexpr int kScanRounds = 4;     // rois a backward thread tests at once
constexpr int kScan = kScanRounds * kBwdThreads;
constexpr int kDefer = 64;         // more kept rois: a tile is split
constexpr int kSplit = 4;          // blocks (a cluster) a split tile takes
constexpr int kSplitClusters = 32;  // clusters of the split kernel
constexpr int kFlagsPerThread = 4;  // split kernel: flags a thread reads
constexpr int kFlagChunk = kFlagsPerThread * kBwdThreads;
// split kernel's dynamic shared memory: its sums (64 KB) and more than
// half an SM, so that a cluster's blocks run on kSplit SMs
constexpr size_t kSplitSmem = 100 * 1024;

struct Levels {
  void* feat[kMaxLevels];  // forward: the features; backward: their grads
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
  int tile_start[kMaxLevels];  // backward: first tile of each level
};

// start + (bin + (k + 0.5) / g) * bin_size, each operation rounded on its
// own as in the plain version: a fused multiply-add would move a sample by
// one ulp of its coordinate (3e-5 cells at x ~ 300), which random feature
// maps turn into output differences of ~1e-4.
__device__ __forceinline__ float sample_pos(float start, int bin, int k,
                                            float g, float bin_size) {
  const float off = __fadd_rn((float)bin, __fdiv_rn((float)k + 0.5f, g));
  return __fadd_rn(start, __fmul_rn(off, bin_size));
}

// One axis of a roi on its level: the first edge, the bin size, the
// per-axis sample count g and the map's extent along the axis.
struct Axis {
  float start, bin, g, inv_g, extent;
  int n, size;
};

__device__ __forceinline__ Axis make_axis(float lo, float hi, float scale,
                                          int size, int out_size, int ratio,
                                          int g_max) {
  Axis a;
  a.start = __fsub_rn(__fmul_rn(lo, scale), 0.5f);
  const float end = __fsub_rn(__fmul_rn(hi, scale), 0.5f);
  a.bin = __fdiv_rn(__fsub_rn(end, a.start), (float)out_size);
  a.g = ratio > 0 ? (float)ratio
                  : fminf(fmaxf(ceilf(a.bin), 1.f), (float)g_max);
  a.inv_g = __fdiv_rn(1.f, a.g);
  a.n = (int)a.g;
  a.size = size;
  a.extent = (float)size;
  return a;
}

// Sample k of bin p: false if it lies outside [-1, extent] (or is NaN);
// else its two cells (equal at the far border) and their weights, each
// times 1 / g.
__device__ __forceinline__ bool axis_taps(const Axis& a, int p, int k,
                                          int& c0, int& c1, float& w0,
                                          float& w1) {
  float v = sample_pos(a.start, p, k, a.g, a.bin);
  if (!(v >= -1.f && v <= a.extent)) return false;
  v = fminf(fmaxf(v, 0.f), a.extent - 1.f);
  const float f = floorf(v);
  c0 = (int)f;
  c1 = min(c0 + 1, a.size - 1);
  const float l = v - f;
  w0 = __fmul_rn(1.f - l, a.inv_g);
  w1 = __fmul_rn(l, a.inv_g);
  return true;
}

// 8 channels as fp32: 16 bytes of bf16 or 32 of fp32 (16-byte aligned)
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)  // round to nearest even, as torch
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// 8 channels as loaded (16 bytes of bf16, 32 of fp32), from read-only
// global memory, and their weighted add into fp32 sums
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Raw8<float> {
  float4 a, b;
};
__device__ __forceinline__ Raw8<__nv_bfloat16> ldg_raw(
    const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ Raw8<float> ldg_raw(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)),
          __ldg(reinterpret_cast<const float4*>(p) + 1)};
}
__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& r,
                                       float (&v)[kVec]) {
  unpack8(r.u, v);
}
__device__ __forceinline__ void unpack(const Raw8<float>& r,
                                       float (&v)[kVec]) {
  v[0] = r.a.x, v[1] = r.a.y, v[2] = r.a.z, v[3] = r.a.w;
  v[4] = r.b.x, v[5] = r.b.y, v[6] = r.b.z, v[7] = r.b.w;
}
template <typename T>
__device__ __forceinline__ void fma8(float (&acc)[kVec], float w,
                                     const Raw8<T>& r) {
  float v[kVec];
  unpack(r, v);
#pragma unroll
  for (int q = 0; q < kVec; ++q) acc[q] = fmaf(w, v[q], acc[q]);
}

// Adds weight w of cell c to a bin's list, kept sorted by cell with one
// entry a cell. The adds of a cell come in sample order, as the backward's.
__device__ __forceinline__ void list_add(int* cells, float* wts, int& n,
                                         int c, float w) {
  int i = n;
  while (i > 0 && cells[i - 1] > c) --i;
  if (i > 0 && cells[i - 1] == c) {
    wts[i - 1] += w;
    return;
  }
  for (int j = n; j > i; --j) {
    cells[j] = cells[j - 1];
    wts[j] = wts[j - 1];
  }
  cells[i] = c;
  wts[i] = w;
  ++n;
}

// ---------------------------------------------------------------- forward
// grid (R, bin groups), block slots x (C / 8) threads, a slot per bin;
// dynamic shared memory: per axis and bin a list of `cap` (cell, weight)
// entries and its length.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
roi_align_fwd_kernel(Levels lv, int num_levels, int batch,
                     const float* __restrict__ rois,
                     const int32_t* __restrict__ lvl,
                     const uint8_t* __restrict__ valid, T* __restrict__ out,
                     int c, int out_size, int ratio, int g_max, int cap,
                     int slots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wts = reinterpret_cast<float*>(smem_raw);    // [2][out][cap]
  int* cells = reinterpret_cast<int*>(wts + 2 * out_size * cap);
  int* counts = cells + 2 * out_size * cap;           // [2][out]

  const int r = blockIdx.x;
  const int groups = c / kVec;
  const int slot = threadIdx.x / groups, cg = threadIdx.x % groups;
  const float* roi = rois + (size_t)r * 5;
  const int b = (int)roi[0];
  const int l = min(max(lvl[r], 0), num_levels - 1);
  const bool zero = (valid != nullptr && !valid[r]) || b < 0 || b >= batch;
  const int h = lv.height[l], w = lv.width[l];
  if (!zero) {
    for (int i = threadIdx.x; i < 2 * out_size; i += blockDim.x) {
      const int axis = i / out_size, p = i % out_size;  // 0: y, 1: x
      const Axis a = make_axis(roi[axis ? 1 : 2], roi[axis ? 3 : 4],
                               lv.scale[l], axis ? w : h, out_size, ratio,
                               g_max);
      int* lc = cells + i * cap;
      float* lw = wts + i * cap;
      int n = 0;
      for (int k = 0; k < a.n; ++k) {
        int c0, c1;
        float w0, w1;
        if (!axis_taps(a, p, k, c0, c1, w0, w1)) continue;
        list_add(lc, lw, n, c0, w0);
        list_add(lc, lw, n, c1, w1);
      }
      counts[i] = n;
    }
  }
  __syncthreads();

  const int bin = blockIdx.y * slots + slot;
  if (slot >= slots || bin >= out_size * out_size) return;
  const int py = bin / out_size, px = bin % out_size;
  float acc[kVec] = {};
  if (!zero) {
    // out = sum_y sum_x A_y[py, y] A_x[px, x] F[y, x, :] over the two
    // lists, two cell rows and kXUnroll cell columns of loads at a time
    const int ny = counts[py], nx = counts[out_size + px];
    const int* yc = cells + py * cap;
    const float* yw = wts + py * cap;
    const int* xc = cells + (out_size + px) * cap;
    const float* xw = wts + (out_size + px) * cap;
    const T* f = static_cast<const T*>(lv.feat[l]) + (size_t)b * h * w * c +
                 cg * kVec;
    for (int a = 0; a < ny; a += 2) {
      const int a1 = min(a + 1, ny - 1);
      const float wy0 = yw[a], wy1 = a + 1 < ny ? yw[a + 1] : 0.f;
      const T* row0 = f + (size_t)yc[a] * w * c;
      const T* row1 = f + (size_t)yc[a1] * w * c;
      for (int j0 = 0; j0 < nx; j0 += kXUnroll) {
        Raw8<T> v0[kXUnroll], v1[kXUnroll];
        float wx[kXUnroll];
#pragma unroll
        for (int j = 0; j < kXUnroll; ++j) {
          const int x = xc[min(j0 + j, nx - 1)];
          wx[j] = j0 + j < nx ? xw[j0 + j] : 0.f;
          v0[j] = ldg_raw(row0 + (size_t)x * c);
          v1[j] = ldg_raw(row1 + (size_t)x * c);
        }
#pragma unroll
        for (int j = 0; j < kXUnroll; ++j) {
          fma8(acc, wy0 * wx[j], v0[j]);
          fma8(acc, wy1 * wx[j], v1[j]);
        }
      }
    }
  }
  store8(out + ((size_t)r * out_size * out_size + bin) * c + cg * kVec, acc);
}

// --------------------------------------------------------------- backward
// A block's static shared memory: the kept rois of a scan round and, per
// roi of the group being summed, axis and tile row / column, the run of
// bins that touch it.
struct BwdShared {
  float4 box[kScan];  // the kept rois' corners in image pixels
  int kept[kScan];    // their indices, ascending
  int warp_kept[kScanRounds][kBwdThreads / 32];
  signed char lo[kGroup][2][kTile], hi[kGroup][2][kTile];
};

// Where item t of the backward grid lies: (tiles of every level and
// image, coarsest level first) x channel chunks, chunk fastest.
struct BwdTile {
  int l, image, ty0, tx0, ch0, h, w;
  float scale;
};

__device__ __forceinline__ BwdTile bwd_tile(const Levels& lv, int num_levels,
                                            int batch, int item,
                                            int chunks) {
  BwdTile at;
  int t = item / chunks;
  at.l = 0;
  for (int i = 0; i < num_levels; ++i) {
    const int n = batch * ((lv.height[i] + kTile - 1) / kTile) *
                  ((lv.width[i] + kTile - 1) / kTile);
    if (t >= lv.tile_start[i] && t < lv.tile_start[i] + n) at.l = i;
  }
  at.h = lv.height[at.l];
  at.w = lv.width[at.l];
  const int tiles_x = (at.w + kTile - 1) / kTile;
  const int per_image = ((at.h + kTile - 1) / kTile) * tiles_x;
  t -= lv.tile_start[at.l];
  at.image = t / per_image;
  at.ty0 = (t % per_image) / tiles_x * kTile;
  at.tx0 = (t % per_image) % tiles_x * kTile;
  at.ch0 = item % chunks * kBwdChunk;
  at.scale = lv.scale[at.l];
  return at;
}

// A backward thread's place: a warp holds 4 tile rows of 8 columns, its
// lane l columns (l / 8) * 2 .. + 1 of those and channels (l % 8) * 8 ..
// + 7 of the chunk.
struct BwdLane {
  int cg, y0, x0;
};

__device__ __forceinline__ BwdLane bwd_lane(int tid) {
  const int lane = tid % 32, warp = tid / 32;
  return {lane % kBwdGroups, warp / (kTile / kWarpCols) * kWarpRows,
          warp % (kTile / kWarpCols) * kWarpCols +
              lane / kBwdGroups * kLaneCols};
}

using BwdAcc = float[kWarpRows][kLaneCols][kVec];

// Sums into acc, in index order, the rois that the tile's scan keeps: of
// each scan round's kept rois, the part-th of `parts` contiguous runs.
// With defer > 0, returns false having summed nothing when the first
// round keeps more than `defer` rois. Ends on a barrier, with `amat` free.
// Dynamic shared memory `amat`: per roi of a group, axis and bin, its row
// of A over the tile and the first and last tile cell it touches.
template <typename T>
__device__ __forceinline__ bool bwd_sum(
    const BwdTile& at, int num_levels, const float* __restrict__ rois,
    const int32_t* __restrict__ lvl, const uint8_t* __restrict__ valid,
    const T* __restrict__ grad_out, int num_rois, int c, int out_size,
    int ratio, int g_max, int group, int part, int parts, int defer,
    float* amat, BwdShared& sh, BwdAcc& acc) {
  // g loads of a warp issued at once: kPyBlock bin rows x 2 bin columns
  constexpr int kPyBlock = sizeof(T) == 2 ? 4 : 2;
  signed char* first = reinterpret_cast<signed char*>(
      amat + group * 2 * out_size * kTile);          // [group][2][out]
  signed char* last = first + group * 2 * out_size;
  const int l = at.l, h = at.h, w = at.w, ty0 = at.ty0, tx0 = at.tx0;
  const float scale = at.scale;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const BwdLane me = bwd_lane(tid);
  const int y0 = me.y0, x0 = me.x0;
  const bool live = at.ch0 + me.cg * kVec < c;

  for (int base = 0; base < num_rois; base += kScan) {
    // keep, in index order, the rois of this level and image whose
    // window may overlap the tile (one cell of margin for rounding); a
    // thread tests kScanRounds of them, all loads issued together
    bool keep[kScanRounds];
    float4 box[kScanRounds];
#pragma unroll
    for (int k = 0; k < kScanRounds; ++k) {
      const int r = base + k * kBwdThreads + tid;
      keep[k] = false;
      box[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < num_rois) {
        const float* ro = rois + (size_t)r * 5;
        const int lr = lvl[r];
        const bool vr = valid == nullptr || valid[r];
        const float br = ro[0];
        box[k] = make_float4(ro[1], ro[2], ro[3], ro[4]);
        if (min(max(lr, 0), num_levels - 1) == l && vr &&
            (int)br == at.image) {
          const float x1 = __fsub_rn(__fmul_rn(box[k].x, scale), 0.5f);
          const float y1 = __fsub_rn(__fmul_rn(box[k].y, scale), 0.5f);
          const float x2 = __fsub_rn(__fmul_rn(box[k].z, scale), 0.5f);
          const float y2 = __fsub_rn(__fmul_rn(box[k].w, scale), 0.5f);
          keep[k] =
              floorf(fminf(x1, x2)) - 1.f <= (float)(tx0 + kTile - 1) &&
              floorf(fmaxf(x1, x2)) + 2.f >= (float)tx0 &&
              floorf(fminf(y1, y2)) - 1.f <= (float)(ty0 + kTile - 1) &&
              floorf(fmaxf(y1, y2)) + 2.f >= (float)ty0;
        }
      }
    }
    unsigned m[kScanRounds];
#pragma unroll
    for (int k = 0; k < kScanRounds; ++k) {
      m[k] = __ballot_sync(0xffffffffu, keep[k]);
      if (lane == 0) sh.warp_kept[k][warp] = __popc(m[k]);
    }
    __syncthreads();
    int kept = 0;  // the rois kept before (round k, warp i), then in all
#pragma unroll
    for (int k = 0; k < kScanRounds; ++k)
#pragma unroll
      for (int i = 0; i < kBwdThreads / 32; ++i) {
        if (i == warp && keep[k]) {
          const int at_k = kept + __popc(m[k] & ((1u << lane) - 1u));
          sh.kept[at_k] = base + k * kBwdThreads + tid;
          sh.box[at_k] = box[k];
        }
        kept += sh.warp_kept[k][i];
      }
    __syncthreads();
    if (defer > 0 && base == 0 && kept > defer) return false;

    const int end = (int)((long long)kept * (part + 1) / parts);
    for (int g0 = (int)((long long)kept * part / parts); g0 < end;
         g0 += group) {
      const int ng = min(group, end - g0);
      // A_y and A_x of the group's rois restricted to the tile: a thread
      // per roi, axis and bin
      for (int j = tid; j < ng * 2 * out_size; j += kBwdThreads) {
        const int axis = j / out_size % 2, p = j % out_size;  // 0: y, 1: x
        const float4 bx = sh.box[g0 + j / (2 * out_size)];
        const Axis a = make_axis(axis ? bx.x : bx.y, axis ? bx.z : bx.w,
                                 scale, axis ? w : h, out_size, ratio,
                                 g_max);
        const int o = axis ? tx0 : ty0;
        float* row = amat + j * kTile;
#pragma unroll
        for (int q = 0; q < kTile; ++q) row[q] = 0.f;
        int lo = kTile, hi = -1;
        for (int k = 0; k < a.n; ++k) {
          int c0, c1;
          float w0, w1;
          if (!axis_taps(a, p, k, c0, c1, w0, w1)) continue;
          c0 -= o;
          c1 -= o;
          if (c0 >= 0 && c0 < kTile) {
            row[c0] += w0;
            lo = min(lo, c0);
            hi = max(hi, c0);
          }
          if (c1 >= 0 && c1 < kTile) {
            row[c1] += w1;
            lo = min(lo, c1);
            hi = max(hi, c1);
          }
        }
        first[j] = (signed char)lo;
        last[j] = (signed char)hi;
      }
      __syncthreads();
      // per roi, axis and tile row / column the run of bins touching it
      for (int j = tid; j < ng * 2 * kTile; j += kBwdThreads) {
        const int i = j / (2 * kTile), axis = j / kTile % 2, q = j % kTile;
        const signed char* f = first + (i * 2 + axis) * out_size;
        const signed char* e = last + (i * 2 + axis) * out_size;
        int lo = out_size, hi = -1;
        for (int p = 0; p < out_size; ++p)
          if (f[p] <= q && q <= e[p]) {
            lo = min(lo, p);
            hi = max(hi, p);
          }
        sh.lo[i][axis][q] = (signed char)lo;
        sh.hi[i][axis][q] = (signed char)hi;
      }
      __syncthreads();
      // each warp sums the group's rois into its cells on its own:
      //   tile[y, x, :] += sum_py A_y[py, y] sum_px A_x[px, x] g[py, px, :]
      // over blocks of kPyBlock x 2 bins whose g loads are issued at once
      for (int i = 0; i < ng && live; ++i) {
        // the runs of bins that touch this thread's rows and columns
        int plo = out_size, phi = -1, qlo = out_size, qhi = -1;
#pragma unroll
        for (int k = 0; k < kWarpRows; ++k) {
          plo = min(plo, (int)sh.lo[i][0][y0 + k]);
          phi = max(phi, (int)sh.hi[i][0][y0 + k]);
        }
#pragma unroll
        for (int k = 0; k < kLaneCols; ++k) {
          qlo = min(qlo, (int)sh.lo[i][1][x0 + k]);
          qhi = max(qhi, (int)sh.hi[i][1][x0 + k]);
        }
        if (plo > phi || qlo > qhi) continue;
        const float* ay = amat + i * 2 * out_size * kTile + y0;
        const float* ax = amat + (i * 2 + 1) * out_size * kTile + x0;
        const T* gr = grad_out + (size_t)sh.kept[g0 + i] * out_size *
                                     out_size * c + at.ch0 + me.cg * kVec;
        for (int p0 = plo; p0 <= phi; p0 += kPyBlock)
          for (int q0 = qlo; q0 <= qhi; q0 += 2) {
            Raw8<T> v[kPyBlock][2];
#pragma unroll
            for (int a = 0; a < kPyBlock; ++a)
#pragma unroll
              for (int b = 0; b < 2; ++b)
                v[a][b] = ldg_raw(gr + (size_t)(min(p0 + a, phi) * out_size +
                                                min(q0 + b, qhi)) * c);
#pragma unroll
            for (int a = 0; a < kPyBlock; ++a) {
              if (p0 + a > phi) break;
              float u[kLaneCols][kVec] = {};
#pragma unroll
              for (int b = 0; b < 2; ++b)
                if (q0 + b <= qhi) {
                  const float* wx = ax + (q0 + b) * kTile;
                  float f[kVec];
                  unpack(v[a][b], f);
#pragma unroll
                  for (int k = 0; k < kLaneCols; ++k)
#pragma unroll
                    for (int q = 0; q < kVec; ++q)
                      u[k][q] = fmaf(wx[k], f[q], u[k][q]);
                }
              const float* wy = ay + (p0 + a) * kTile;
#pragma unroll
              for (int y = 0; y < kWarpRows; ++y) {
                const float wgt = wy[y];
                if (wgt == 0.f) continue;  // the same for the whole warp
#pragma unroll
                for (int k = 0; k < kLaneCols; ++k)
#pragma unroll
                  for (int q = 0; q < kVec; ++q)
                    acc[y][k][q] = fmaf(wgt, u[k][q], acc[y][k][q]);
              }
            }
          }
      }
      // A and the runs are free again
      __syncthreads();
    }
  }
  return true;
}

// Cell (y, x) of the tile, channels ch .. ch + 7: written in T if inside
// the level and the channels.
template <typename T>
__device__ __forceinline__ void bwd_store(const Levels& lv, const BwdTile& at,
                                          int c, int y, int x, int ch,
                                          const float (&v)[kVec]) {
  const int gy = at.ty0 + y, gx = at.tx0 + x;
  if (gy >= at.h || gx >= at.w || ch >= c) return;
  T* dst = static_cast<T*>(lv.feat[at.l]) +
           (((size_t)at.image * at.h + gy) * at.w + gx) * c + ch;
  store8(dst, v);
}

// One block per item (tile, channel chunk), kBwdThreads threads. A block
// whose tile's first scan round keeps more than kDefer rois leaves the
// tile to roi_align_bwd_split_kernel: it sets deferred[item] and writes
// nothing; every other block writes its tile and clears deferred[item].
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
roi_align_bwd_kernel(Levels lv, int num_levels, int batch,
                     const float* __restrict__ rois,
                     const int32_t* __restrict__ lvl,
                     const uint8_t* __restrict__ valid,
                     const T* __restrict__ grad_out, int num_rois, int c,
                     int out_size, int ratio, int g_max, int chunks,
                     int group, uint8_t* __restrict__ deferred) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ BwdShared sh;
  const BwdTile at = bwd_tile(lv, num_levels, batch, blockIdx.x, chunks);
  BwdAcc acc = {};
  const bool done = bwd_sum<T>(
      at, num_levels, rois, lvl, valid, grad_out, num_rois, c, out_size,
      ratio, g_max, group, 0, 1, kDefer, reinterpret_cast<float*>(smem_raw),
      sh, acc);
  if (threadIdx.x == 0) deferred[blockIdx.x] = !done;
  if (!done) return;
  const BwdLane me = bwd_lane(threadIdx.x);
#pragma unroll
  for (int y = 0; y < kWarpRows; ++y)
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k)
      bwd_store<T>(lv, at, c, me.y0 + y, me.x0 + k, at.ch0 + me.cg * kVec,
                   acc[y][k]);
}

// The deferred items, each split over a cluster of kSplit blocks, one
// block an SM (kSplitSmem): rank r sums the r-th contiguous run of each
// scan round's kept rois into fp32 sums in its shared memory; after a
// cluster barrier, rank r adds up the r-th part of the tile over the
// ranks, rank 0 first, and writes it. So the result does not depend on
// timing, and two runs are equal bit for bit. Every block reads all the
// flags, kFlagChunk at a time, and cluster k takes the deferred items
// whose place among them is k modulo the clusters.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
roi_align_bwd_split_kernel(Levels lv, int num_levels, int batch,
                           const float* __restrict__ rois,
                           const int32_t* __restrict__ lvl,
                           const uint8_t* __restrict__ valid,
                           const T* __restrict__ grad_out, int num_rois,
                           int c, int out_size, int ratio, int g_max,
                           int chunks, int group, int items,
                           const uint8_t* __restrict__ deferred) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ BwdShared sh;
  __shared__ int todo[kFlagChunk];
  __shared__ int warp_count[kBwdThreads / 32];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int cid = blockIdx.x / kSplit, clusters = gridDim.x / kSplit;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kSums = kWarpRows * kLaneCols;  // 8-channel sums a thread
  // after the sums: every thread's acc, [kBwdThreads][kSums][kVec]
  float* sums = reinterpret_cast<float*>(smem_raw);
  int seen = 0;  // the deferred items of the chunks before
  for (int base = 0; base < items; base += kFlagChunk) {
    // this chunk's deferred items, in order, and the cluster's among them
    const int first = base + tid * kFlagsPerThread;
    bool flag[kFlagsPerThread];
    int cnt = 0;
#pragma unroll
    for (int b = 0; b < kFlagsPerThread; ++b) {
      flag[b] = first + b < items && deferred[first + b];
      cnt += flag[b];
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_count[warp] = incl;
    __syncthreads();
    int p = seen + incl - cnt, total = 0;
    for (int i = 0; i < kBwdThreads / 32; ++i) {
      if (i < warp) p += warp_count[i];
      total += warp_count[i];
    }
    // own places: cid, cid + clusters, ...; m0 of them lie before `seen`
    const int m0 = seen > cid ? (seen - cid + clusters - 1) / clusters : 0;
#pragma unroll
    for (int b = 0; b < kFlagsPerThread; ++b)
      if (flag[b]) {
        if (p % clusters == cid) todo[p / clusters - m0] = first + b;
        ++p;
      }
    seen += total;
    const int m1 = seen > cid ? (seen - cid + clusters - 1) / clusters : 0;
    __syncthreads();
    for (int j = 0; j < m1 - m0; ++j) {
      const BwdTile at = bwd_tile(lv, num_levels, batch, todo[j], chunks);
      BwdAcc acc = {};
      bwd_sum<T>(at, num_levels, rois, lvl, valid, grad_out, num_rois, c,
                 out_size, ratio, g_max, group, rank, kSplit, 0,
                 reinterpret_cast<float*>(smem_raw), sh, acc);
      float* mine = sums + tid * kSums * kVec;
#pragma unroll
      for (int y = 0; y < kWarpRows; ++y)
#pragma unroll
        for (int k = 0; k < kLaneCols; ++k)
          store8(mine + (y * kLaneCols + k) * kVec, acc[y][k]);
      cl.sync();  // every rank's sums are in its shared memory
      constexpr int kShare = kBwdThreads * kSums / kSplit;
      for (int u = rank * kShare + tid; u < (rank + 1) * kShare;
           u += kBwdThreads) {
        float v[kVec] = {};
        for (int r = 0; r < kSplit; ++r) {
          const float4* src = reinterpret_cast<const float4*>(
                                  cl.map_shared_rank(sums, r)) +
                              u * (kVec / 4);
          const float4 a = src[0], b = src[1];
          v[0] += a.x, v[1] += a.y, v[2] += a.z, v[3] += a.w;
          v[4] += b.x, v[5] += b.y, v[6] += b.z, v[7] += b.w;
        }
        const int s = u / kSums, y = u % kSums / kLaneCols,
                  k = u % kLaneCols;
        const BwdLane who = bwd_lane(s);
        bwd_store<T>(lv, at, c, who.y0 + y, who.x0 + k,
                     at.ch0 + who.cg * kVec, v);
      }
      cl.sync();  // the others have read our sums
    }
  }
}

// dynamic shared memory beyond the default 48 KB (static included)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t dynamic, size_t fixed = 0) {
  if (dynamic + fixed <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dynamic);
}

template <typename T>
cudaError_t launch_fwd(const Levels& lv, int num_levels, int batch,
                       const float* rois, const int32_t* lvl,
                       const uint8_t* valid, void* out, int num_rois, int c,
                       int out_size, int ratio, int g_max, cudaStream_t s) {
  const int groups = c / kVec;
  const int bins = out_size * out_size;
  const int slots = std::max(1, std::min(bins, kFwdThreads / groups));
  const int cap = 2 * (ratio > 0 ? ratio : g_max);
  const size_t smem = (size_t)2 * out_size * (cap * 8 + 4);
  const cudaError_t e = allow_smem(roi_align_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(num_rois, (bins + slots - 1) / slots);
  roi_align_fwd_kernel<T><<<grid, slots * groups, smem, s>>>(
      lv, num_levels, batch, rois, lvl, valid, static_cast<T*>(out), c,
      out_size, ratio, g_max, cap, slots);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(Levels lv, int num_levels, int batch,
                       const float* rois, const int32_t* lvl,
                       const uint8_t* valid, const void* grad_out,
                       int num_rois, int c, int out_size, int ratio,
                       int g_max, uint8_t* deferred, cudaStream_t s) {
  int tiles = 0;
  for (int l = num_levels - 1; l >= 0; --l) {  // coarsest (busiest) first
    lv.tile_start[l] = tiles;
    tiles += batch * ((lv.height[l] + kTile - 1) / kTile) *
             ((lv.width[l] + kTile - 1) / kTile);
  }
  if (tiles == 0) return cudaSuccess;
  const int chunks = (c + kBwdChunk - 1) / kBwdChunk;
  const int items = tiles * chunks;
  // a group's rows of A within about 96 KB
  const int per_roi = 2 * out_size * (kTile * 4 + 2);
  const int group = std::max(1, std::min(kGroup, 96 * 1024 / per_roi));
  const size_t smem = (size_t)group * per_roi;
  cudaError_t e =
      allow_smem(roi_align_bwd_kernel<T>, smem, sizeof(BwdShared));
  if (e != cudaSuccess) return e;
  roi_align_bwd_kernel<T><<<items, kBwdThreads, smem, s>>>(
      lv, num_levels, batch, rois, lvl, valid,
      static_cast<const T*>(grad_out), num_rois, c, out_size, ratio, g_max,
      chunks, group, deferred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the split kernel's shared memory also holds a block's sums, and takes
  // more than half an SM
  const size_t split_smem = std::max(smem, kSplitSmem);
  e = allow_smem(roi_align_bwd_split_kernel<T>, split_smem,
                 sizeof(BwdShared));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(kSplitClusters * kSplit));
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = split_smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, roi_align_bwd_split_kernel<T>, lv,
                            num_levels, batch, rois, lvl, valid,
                            static_cast<const T*>(grad_out), num_rois, c,
                            out_size, ratio, g_max, chunks, group, items,
                            static_cast<const uint8_t*>(deferred));
}

Levels make_levels(void* const* ptrs, const int* heights, const int* widths,
                   const float* scales, int num_levels) {
  Levels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.feat[l] = ptrs[l];
    lv.height[l] = heights[l];
    lv.width[l] = widths[l];
    lv.scale[l] = scales[l];
  }
  return lv;
}

}  // namespace swindet

// grads[l]: (B, height[l], width[l], C) in `dtype`, every value of which
// the kernels write (the feature gradient; zeros where no roi samples);
// grad_out (R, out_size, out_size, C) in `dtype`; deferred: scratch of a
// byte per item, tiles of every level and image times ceil(C / 64)
// (ops/roi_align.py _bwd_items); the other arguments as
// swindet_roi_align's. C % 8 == 0, out_size <= 64; grads and grad_out
// 16-byte aligned.
SWINDET_EXPORT int swindet_roi_align_bwd(void* const* grads,
                                         const int* heights,
                                         const int* widths,
                                         const float* scales, int num_levels,
                                         int batch, const float* rois,
                                         const int32_t* lvl,
                                         const uint8_t* valid,
                                         const void* grad_out, int num_rois,
                                         int c, int out_size, int ratio,
                                         int g_max, int dtype, void* deferred,
                                         void* stream) {
  using namespace swindet;
  if (num_levels < 1 || num_levels > kMaxLevels || c % kVec ||
      out_size < 1 || out_size > kMaxBwdBins)
    return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(grads, heights, widths, scales, num_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* d = static_cast<uint8_t*>(deferred);
  if (dtype == kBFloat16)
    return (int)launch_bwd<__nv_bfloat16>(lv, num_levels, batch, rois, lvl,
                                          valid, grad_out, num_rois, c,
                                          out_size, ratio, g_max, d, s);
  if (dtype == kFloat32)
    return (int)launch_bwd<float>(lv, num_levels, batch, rois, lvl, valid,
                                  grad_out, num_rois, c, out_size, ratio,
                                  g_max, d, s);
  return (int)cudaErrorInvalidValue;
}

// feats[l]: (B, height[l], width[l], C) in `dtype`; rois (R, 5) fp32
// [batch, x1, y1, x2, y2]; lvl (R,) int32; valid (R,) uint8 or null;
// out (R, out_size, out_size, C) in `dtype`. ratio > 0 fixes the per-axis
// sample count, ratio == 0 is the adaptive count capped at g_max.
// C % 8 == 0 and C <= 2048; feats and out 16-byte aligned.
SWINDET_EXPORT int swindet_roi_align(void* const* feats, const int* heights,
                                     const int* widths, const float* scales,
                                     int num_levels, int batch,
                                     const float* rois, const int32_t* lvl,
                                     const uint8_t* valid, void* out,
                                     int num_rois, int c, int out_size,
                                     int ratio, int g_max, int dtype,
                                     void* stream) {
  using namespace swindet;
  if (num_levels < 1 || num_levels > kMaxLevels || c % kVec ||
      c / kVec > kFwdThreads || out_size < 1)
    return (int)cudaErrorInvalidValue;
  if (num_rois == 0) return (int)cudaSuccess;
  const Levels lv = make_levels(feats, heights, widths, scales, num_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)launch_fwd<__nv_bfloat16>(lv, num_levels, batch, rois, lvl,
                                          valid, out, num_rois, c, out_size,
                                          ratio, g_max, s);
  if (dtype == kFloat32)
    return (int)launch_fwd<float>(lv, num_levels, batch, rois, lvl, valid,
                                  out, num_rois, c, out_size, ratio, g_max,
                                  s);
  return (int)cudaErrorInvalidValue;
}
