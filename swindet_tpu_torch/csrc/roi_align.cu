// Multilevel RoIAlign, forward (mmcv semantics: aligned=True, adaptive
// sampling_ratio=0 with the per-axis sample count capped at g_max, or a
// fixed ratio), over NHWC FPN levels, one level per roi:
//   out[r, py, px, c] = mean over the bin's gy x gx samples of the bilinear
//                       tap of level lvl[r] at (y, x), channel c
//
// Replaces: swindet_tpu/ops/roi_align_pallas.py · _roi_align_kernel +
// _compute (via _roi_align_pallas_impl, pallas_call at :311), called from
// models/roi_heads/roi_extractor.py:78-86 for the bbox (7x7) and mask
// (14x14) extractors. Its contract is swindet_tpu/ops/roi_align.py:93 for
// every roi; the TPU kernel's strip passes and exact fallback tail served
// the TPU's DMA engine and have no counterpart here.
//
// Bound: memory latency. Each output value averages up to 64 samples of 4
// taps; the taps of one roi are scattered rows of the level map, so what
// matters is that every tap read is coalesced. Design: one block per
// (roi, bin row) with its threads over the channels, so each tap is one
// contiguous C-wide row read (512 B at C = 256 in bf16) and each output
// bin one contiguous write. Sample positions, border rules and weights are
// computed per thread in fp32 exactly as the plain version does, and the
// taps are accumulated in fp32. Routing (lvl) is computed by the caller so
// that the kernel and the plain version route every roi identically.
#include "common.cuh"

namespace swindet {

constexpr int kMaxLevels = 8;
constexpr int kRoiThreads = 128;

struct Levels {
  const void* feat[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
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

template <typename T>
__global__ void __launch_bounds__(kRoiThreads)
roi_align_kernel(Levels lv, int num_levels, int batch,
                 const float* __restrict__ rois,
                 const int32_t* __restrict__ lvl,
                 const uint8_t* __restrict__ valid, T* __restrict__ out,
                 int c, int out_size, int ratio, int g_max) {
  const int r = blockIdx.x;
  const int py = blockIdx.y;
  T* o = out + ((size_t)r * out_size + py) * out_size * c;
  const float* roi = rois + (size_t)r * 5;
  const int b = (int)roi[0];
  const int l = min(max(lvl[r], 0), num_levels - 1);
  if ((valid != nullptr && !valid[r]) || b < 0 || b >= batch) {
    for (int i = threadIdx.x; i < out_size * c; i += kRoiThreads)
      o[i] = from_f32<T>(0.f);
    return;
  }

  const int h = lv.height[l], w = lv.width[l];
  const float hf = (float)h, wf = (float)w;
  const float scale = lv.scale[l];
  const float x1 = roi[1] * scale - 0.5f;
  const float y1 = roi[2] * scale - 0.5f;
  const float x2 = roi[3] * scale - 0.5f;
  const float y2 = roi[4] * scale - 0.5f;
  const float bin_w = (x2 - x1) / out_size;
  const float bin_h = (y2 - y1) / out_size;
  float gy, gx;
  if (ratio > 0) {
    gy = gx = (float)ratio;
  } else {
    gy = fminf(fmaxf(ceilf((y2 - y1) / out_size), 1.f), (float)g_max);
    gx = fminf(fmaxf(ceilf((x2 - x1) / out_size), 1.f), (float)g_max);
  }
  const int ny = (int)gy, nx = (int)gx;
  const float weight = (1.f / gy) * (1.f / gx);
  const T* f = static_cast<const T*>(lv.feat[l]) + (size_t)b * h * w * c;

  for (int ci = threadIdx.x; ci < c; ci += kRoiThreads) {
    for (int px = 0; px < out_size; ++px) {
      float acc = 0.f;
      for (int iy = 0; iy < ny; ++iy) {
        float y = sample_pos(y1, py, iy, gy, bin_h);
        if (y < -1.f || y > hf) continue;
        y = fminf(fmaxf(y, 0.f), hf - 1.f);
        const float y0f = floorf(y);
        const int y0 = (int)y0f;
        const int y1i = min(y0 + 1, h - 1);
        const float ly = y - y0f, hy = 1.f - ly;
        for (int ix = 0; ix < nx; ++ix) {
          float x = sample_pos(x1, px, ix, gx, bin_w);
          if (x < -1.f || x > wf) continue;
          x = fminf(fmaxf(x, 0.f), wf - 1.f);
          const float x0f = floorf(x);
          const int x0 = (int)x0f;
          const int x1i = min(x0 + 1, w - 1);
          const float lx = x - x0f, hx = 1.f - lx;
          const float v00 = to_f32(f[((size_t)y0 * w + x0) * c + ci]);
          const float v01 = to_f32(f[((size_t)y0 * w + x1i) * c + ci]);
          const float v10 = to_f32(f[((size_t)y1i * w + x0) * c + ci]);
          const float v11 = to_f32(f[((size_t)y1i * w + x1i) * c + ci]);
          const float v = v00 * (hy * hx) + v01 * (hy * lx) +
                          v10 * (ly * hx) + v11 * (ly * lx);
          acc += v * weight;
        }
      }
      o[(size_t)px * c + ci] = from_f32<T>(acc);
    }
  }
}

struct LevelGrads {
  float* grad[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
};

// Backward: the gradient of each output value, times its sample weight,
// goes to the four bilinear taps of every sample of its bin, on the level
// of its roi, with the forward's sample positions, border rules and tap
// weights; invalid rois and rois with an out-of-range batch index take
// none. The exact gradient of the forward for every roi.
//
// Replaces: swindet_tpu/ops/roi_align_pallas.py · _roi_align_bwd_kernel
// (via _roi_align_pallas_bwd_impl, pallas_call at :513), and with it that
// function's exact tail for oversize rois (:527-547): here every roi takes
// the same path.
//
// Bound: memory latency of the scattered adds, as the forward's reads.
// The TPU kernel read-modify-writes each roi's window in order, which is
// race-free only because its grid is sequential (:417-421); overlapping
// rois race here. Design: the mirror of the forward -- one block per
// (roi, bin row), threads over channels -- with each tap an fp32
// atomicAdd into zeroed NHWC per-level buffers, so the adds of one tap
// are one contiguous C-wide row. The order of the atomics varies, so the
// sums vary in their last bits.
template <typename T>
__global__ void __launch_bounds__(kRoiThreads)
roi_align_bwd_kernel(LevelGrads lv, int num_levels, int batch,
                     const float* __restrict__ rois,
                     const int32_t* __restrict__ lvl,
                     const uint8_t* __restrict__ valid,
                     const T* __restrict__ grad_out, int c, int out_size,
                     int ratio, int g_max) {
  const int r = blockIdx.x;
  const int py = blockIdx.y;
  const float* roi = rois + (size_t)r * 5;
  const int b = (int)roi[0];
  const int l = min(max(lvl[r], 0), num_levels - 1);
  if ((valid != nullptr && !valid[r]) || b < 0 || b >= batch) return;

  const int h = lv.height[l], w = lv.width[l];
  const float hf = (float)h, wf = (float)w;
  const float scale = lv.scale[l];
  const float x1 = roi[1] * scale - 0.5f;
  const float y1 = roi[2] * scale - 0.5f;
  const float x2 = roi[3] * scale - 0.5f;
  const float y2 = roi[4] * scale - 0.5f;
  const float bin_w = (x2 - x1) / out_size;
  const float bin_h = (y2 - y1) / out_size;
  float gy, gx;
  if (ratio > 0) {
    gy = gx = (float)ratio;
  } else {
    gy = fminf(fmaxf(ceilf((y2 - y1) / out_size), 1.f), (float)g_max);
    gx = fminf(fmaxf(ceilf((x2 - x1) / out_size), 1.f), (float)g_max);
  }
  const int ny = (int)gy, nx = (int)gx;
  const float weight = (1.f / gy) * (1.f / gx);
  float* f = lv.grad[l] + (size_t)b * h * w * c;
  const T* go = grad_out + ((size_t)r * out_size + py) * out_size * c;

  for (int ci = threadIdx.x; ci < c; ci += kRoiThreads) {
    for (int px = 0; px < out_size; ++px) {
      const float gv = to_f32(go[(size_t)px * c + ci]) * weight;
      for (int iy = 0; iy < ny; ++iy) {
        float y = sample_pos(y1, py, iy, gy, bin_h);
        if (y < -1.f || y > hf) continue;
        y = fminf(fmaxf(y, 0.f), hf - 1.f);
        const float y0f = floorf(y);
        const int y0 = (int)y0f;
        const int y1i = min(y0 + 1, h - 1);
        const float ly = y - y0f, hy = 1.f - ly;
        for (int ix = 0; ix < nx; ++ix) {
          float x = sample_pos(x1, px, ix, gx, bin_w);
          if (x < -1.f || x > wf) continue;
          x = fminf(fmaxf(x, 0.f), wf - 1.f);
          const float x0f = floorf(x);
          const int x0 = (int)x0f;
          const int x1i = min(x0 + 1, w - 1);
          const float lx = x - x0f, hx = 1.f - lx;
          atomicAdd(&f[((size_t)y0 * w + x0) * c + ci], gv * (hy * hx));
          atomicAdd(&f[((size_t)y0 * w + x1i) * c + ci], gv * (hy * lx));
          atomicAdd(&f[((size_t)y1i * w + x0) * c + ci], gv * (ly * hx));
          atomicAdd(&f[((size_t)y1i * w + x1i) * c + ci], gv * (ly * lx));
        }
      }
    }
  }
}

}  // namespace swindet

// grads[l]: (B, height[l], width[l], C) fp32, zeroed by the caller, into
// which the feature gradient is added; grad_out (R, out_size, out_size, C)
// in `dtype`; the other arguments as swindet_roi_align's.
SWINDET_EXPORT int swindet_roi_align_bwd(float* const* grads,
                                         const int* heights,
                                         const int* widths,
                                         const float* scales, int num_levels,
                                         int batch, const float* rois,
                                         const int32_t* lvl,
                                         const uint8_t* valid,
                                         const void* grad_out, int num_rois,
                                         int c, int out_size, int ratio,
                                         int g_max, int dtype, void* stream) {
  using namespace swindet;
  if (num_levels < 1 || num_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  if (num_rois == 0) return (int)cudaSuccess;
  LevelGrads lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.grad[l] = grads[l];
    lv.height[l] = heights[l];
    lv.width[l] = widths[l];
    lv.scale[l] = scales[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(num_rois, out_size);
  if (dtype == kBFloat16)
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, kRoiThreads, 0, s>>>(
        lv, num_levels, batch, rois, lvl, valid,
        static_cast<const __nv_bfloat16*>(grad_out), c, out_size, ratio,
        g_max);
  else if (dtype == kFloat32)
    roi_align_bwd_kernel<float><<<grid, kRoiThreads, 0, s>>>(
        lv, num_levels, batch, rois, lvl, valid,
        static_cast<const float*>(grad_out), c, out_size, ratio, g_max);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// feats[l]: (B, height[l], width[l], C) in `dtype`; rois (R, 5) fp32
// [batch, x1, y1, x2, y2]; lvl (R,) int32; valid (R,) uint8 or null;
// out (R, out_size, out_size, C) in `dtype`. ratio > 0 fixes the per-axis
// sample count, ratio == 0 is the adaptive count capped at g_max.
SWINDET_EXPORT int swindet_roi_align(const void* const* feats,
                                     const int* heights, const int* widths,
                                     const float* scales, int num_levels,
                                     int batch, const float* rois,
                                     const int32_t* lvl, const uint8_t* valid,
                                     void* out, int num_rois, int c,
                                     int out_size, int ratio, int g_max,
                                     int dtype, void* stream) {
  using namespace swindet;
  if (num_levels < 1 || num_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  if (num_rois == 0) return (int)cudaSuccess;
  Levels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.feat[l] = feats[l];
    lv.height[l] = heights[l];
    lv.width[l] = widths[l];
    lv.scale[l] = scales[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(num_rois, out_size);
  if (dtype == kBFloat16)
    roi_align_kernel<__nv_bfloat16><<<grid, kRoiThreads, 0, s>>>(
        lv, num_levels, batch, rois, lvl, valid,
        static_cast<__nv_bfloat16*>(out), c, out_size, ratio, g_max);
  else if (dtype == kFloat32)
    roi_align_kernel<float><<<grid, kRoiThreads, 0, s>>>(
        lv, num_levels, batch, rois, lvl, valid, static_cast<float*>(out), c,
        out_size, ratio, g_max);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
