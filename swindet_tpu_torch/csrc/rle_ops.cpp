// Host mask library of the PyTorch port (C ABI, bound with ctypes by
// swindet_tpu_torch/core/host_lib.py): the COCO RLE codec, the pairwise
// mask IoU and the paste of mask probabilities into the image, the host
// steps of mask evaluation (counterpart of swindet_tpu/native/rle_ops.cpp;
// reference pycocotools' maskApi.c and mmdet fcn_mask_head.py:306
// _do_paste_mask). Plain C++17, no Python headers, numpy buffers in and
// out.
//
// Each function gives what its numpy version in core/masks.py gives, bit
// for bit: counts are alternating background / foreground runs over the
// column-major flattening of an (h, w) mask, starting with background;
// the paste computes in double, in the numpy version's order of
// operations (build with -ffp-contract=off, so no multiply-add fuses).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- codec
// counts -> column-major bitmap of `size` bytes; runs past `size` are cut
// and a short list leaves the rest background
void rle_decode(const uint32_t* counts, int64_t n, uint8_t* out,
                int64_t size) {
    int64_t pos = 0;
    uint8_t v = 0;
    for (int64_t i = 0; i < n && pos < size; ++i) {
        int64_t run = std::min<int64_t>(counts[i], size - pos);
        memset(out + pos, v, (size_t)run);
        pos += run;
        v ^= 1;
    }
    if (pos < size) memset(out + pos, 0, (size_t)(size - pos));
}

// row-major (h, w) mask (any non-zero byte is foreground) -> counts of its
// column-major runs; `out` holds h * w + 1 entries. Returns the count.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   uint32_t* out) {
    int64_t n = 0;
    uint8_t cur = 0;
    int64_t run = 0;
    for (int64_t x = 0; x < w; ++x) {
        for (int64_t y = 0; y < h; ++y) {
            uint8_t v = mask[y * w + x] ? 1 : 0;
            if (v == cur) {
                ++run;
            } else {
                out[n++] = (uint32_t)run;
                cur = v;
                run = 1;
            }
        }
    }
    out[n++] = (uint32_t)run;
    return n;
}

// counts -> pycocotools' compressed string (rleToString: each count after
// the second delta-coded against the one two back, then 5-bit groups with
// a continuation bit, offset by 48); `out` holds 7 * n bytes. Returns its
// length.
int64_t rle_to_string(const uint32_t* counts, int64_t n, char* out) {
    int64_t p = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t x = counts[i];
        if (i > 2) x -= (int64_t)counts[i - 2];
        bool more = true;
        while (more) {
            int64_t c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? x != -1 : x != 0;
            if (more) c |= 0x20;
            out[p++] = (char)(c + 48);
        }
    }
    return p;
}

// pycocotools' compressed string -> counts; `out` holds len entries.
// Returns the count.
int64_t rle_from_string(const char* s, int64_t len, int64_t* out) {
    int64_t n = 0, p = 0;
    while (p < len) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more && p < len) {
            int64_t c = (int64_t)s[p] - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++p;
            ++k;
            if (!more && (c & 0x10)) x |= (int64_t)(~0ULL << (5 * k));
        }
        if (n > 2) x += out[n - 2];
        out[n++] = x;
    }
    return n;
}

static inline uint64_t rle_area_one(const uint32_t* c, int64_t n) {
    uint64_t a = 0;
    for (int64_t i = 1; i < n; i += 2) a += c[i];
    return a;
}

// foreground pixels two RLEs of one canvas share, by a sweep of both run
// lists (no bitmap)
static uint64_t rle_intersect(const uint32_t* a, int64_t na,
                              const uint32_t* b, int64_t nb) {
    int64_t ia = 0, ib = 0;
    int64_t enda = na ? (int64_t)a[0] : 0;
    int64_t endb = nb ? (int64_t)b[0] : 0;
    bool fa = false, fb = false;
    int64_t pos = 0;
    uint64_t inter = 0;
    while (ia < na && ib < nb) {
        int64_t e = std::min(enda, endb);
        if (fa && fb) inter += (uint64_t)(e - pos);
        pos = e;
        if (enda == e) {
            ++ia;
            fa = !fa;
            if (ia < na) enda += (int64_t)a[ia];
        }
        if (endb == e) {
            ++ib;
            fb = !fb;
            if (ib < nb) endb += (int64_t)b[ib];
        }
    }
    return inter;
}

// ------------------------------------------------------------------ iou
// (n_dt, n_gt) IoU of RLE masks; mask i's counts are counts[off[i] ..
// off[i + 1]). A crowd gt's union is the detection's area (pycocotools
// maskUtils.iou). Each entry is the double quotient of two integers, as
// numpy's.
void rle_iou(const uint32_t* dt_counts, const int64_t* dt_off, int64_t n_dt,
             const uint32_t* gt_counts, const int64_t* gt_off, int64_t n_gt,
             const uint8_t* iscrowd, double* out) {
    for (int64_t i = 0; i < n_dt; ++i) {
        const uint32_t* dc = dt_counts + dt_off[i];
        int64_t dn = dt_off[i + 1] - dt_off[i];
        uint64_t da = rle_area_one(dc, dn);
        for (int64_t j = 0; j < n_gt; ++j) {
            const uint32_t* gc = gt_counts + gt_off[j];
            int64_t gn = gt_off[j + 1] - gt_off[j];
            uint64_t inter = rle_intersect(dc, dn, gc, gn);
            uint64_t uni = iscrowd[j] ? da
                                      : da + rle_area_one(gc, gn) - inter;
            out[i * n_gt + j] = uni ? (double)inter / (double)uni : 0.0;
        }
    }
}

// ---------------------------------------------------------------- paste
// (n, s, s) fp32 mask probabilities pasted at fp32 boxes (x1, y1, x2, y2)
// into (n, img_h, img_w) uint8 masks, thresholded at `thr`: each pixel
// of the box's window (1 px of slack a side) samples the mask bilinearly
// at its centre, grid_sample align_corners=False with zero padding.
void paste_masks(const float* probs, int64_t n, int64_t s,
                 const float* boxes, int64_t img_h, int64_t img_w,
                 double thr, uint8_t* out) {
    memset(out, 0, (size_t)(n * img_h * img_w));
    for (int64_t k = 0; k < n; ++k) {
        const float* m = probs + k * s * s;
        uint8_t* o = out + k * img_h * img_w;
        float x1 = boxes[k * 4 + 0], y1 = boxes[k * 4 + 1];
        float x2 = boxes[k * 4 + 2], y2 = boxes[k * 4 + 3];
        float w = x2 - x1, h = y2 - y1;  // fp32, as numpy's scalars
        if (!(w > 0.f) || !(h > 0.f)) continue;
        int64_t ix1 = std::max<int64_t>((int64_t)std::floor(x1) - 1, 0);
        int64_t iy1 = std::max<int64_t>((int64_t)std::floor(y1) - 1, 0);
        int64_t ix2 = std::min<int64_t>((int64_t)std::ceil(x2) + 1, img_w);
        int64_t iy2 = std::min<int64_t>((int64_t)std::ceil(y2) + 1, img_h);
        if (ix2 <= ix1 || iy2 <= iy1) continue;
        for (int64_t yy = iy1; yy < iy2; ++yy) {
            double sy = (((double)yy + 0.5) - (double)y1) / (double)h
                * (double)s - 0.5;
            double fy0 = std::floor(sy);
            int64_t y0 = (int64_t)fy0;
            double wy = sy - fy0;
            const float* r0 = (y0 >= 0 && y0 < s) ? m + y0 * s : nullptr;
            const float* r1 = (y0 + 1 >= 0 && y0 + 1 < s)
                ? m + (y0 + 1) * s : nullptr;
            uint8_t* orow = o + yy * img_w;
            for (int64_t xx = ix1; xx < ix2; ++xx) {
                double sx = (((double)xx + 0.5) - (double)x1) / (double)w
                    * (double)s - 0.5;
                double fx0 = std::floor(sx);
                int64_t x0 = (int64_t)fx0;
                double wx = sx - fx0;
                bool u0 = x0 >= 0 && x0 < s;
                bool u1 = x0 + 1 >= 0 && x0 + 1 < s;
                double v00 = (r0 && u0) ? (double)r0[x0] : 0.0;
                double v01 = (r0 && u1) ? (double)r0[x0 + 1] : 0.0;
                double v10 = (r1 && u0) ? (double)r1[x0] : 0.0;
                double v11 = (r1 && u1) ? (double)r1[x0 + 1] : 0.0;
                double val = v00 * ((1.0 - wy) * (1.0 - wx));
                val = val + v01 * ((1.0 - wy) * wx);
                val = val + v10 * (wy * (1.0 - wx));
                val = val + v11 * (wy * wx);
                orow[xx] = val >= thr ? 1 : 0;
            }
        }
    }
}

}  // extern "C"
