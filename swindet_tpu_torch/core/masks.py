"""Host-side mask work (counterpart of ``swindet_tpu/core/masks.py``).

- :func:`paste_masks`: (N, s, s) mask probs into the full image at their
  boxes, grid_sample align_corners=False semantics with zero padding
  (reference fcn_mask_head.py:306 ``_do_paste_mask``), through the host
  library ``core/host_ops.py``; :func:`paste_masks_reference` is its plain
  numpy version.
- :func:`mask_to_rle` (:20 there), :func:`rle_iou` (:105) and
  :func:`encode_mask_results` (:210): COCO RLE of a bitmap and the
  pairwise mask IoU, through the same library; their plain versions are
  ``core/rle.py``'s numpy codec.
- :func:`poly2mask`: COCO polygons to a bitmap, equal bit for bit to the
  JAX package's ``cv2.fillPoly`` (opencv 5.0): every edge drawn as an
  8-connected line, then the even-odd scanline fill of cv2's
  ``FillEdgeCollection`` with its 16-bit fixed-point edges.
- :func:`rle_to_mask`: COCO RLE to a bitmap, for the train pipeline.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import host_ops

# cv2's drawing.cpp keeps polygon edge x in fixed point with 16 fraction bits
XY_SHIFT = 16


def paste_masks(mask_probs: np.ndarray, boxes: np.ndarray, img_h: int,
                img_w: int, threshold: float = 0.5) -> np.ndarray:
    """Returns (N, img_h, img_w) bool masks (the host library)."""
    return host_ops.paste_masks(mask_probs, boxes, img_h, img_w, threshold)


def paste_masks_reference(mask_probs: np.ndarray, boxes: np.ndarray,
                          img_h: int, img_w: int, threshold: float = 0.5,
                          probs: bool = False) -> np.ndarray:
    """The plain version of :func:`paste_masks`, in numpy (float64 sample
    positions and weights, fp32 box sizes). With ``probs``, the sampled
    probabilities (float64, 0 outside each box's window) in place of the
    thresholded masks."""
    boxes = np.asarray(boxes, np.float32)
    n = mask_probs.shape[0]
    s = mask_probs.shape[1] if n else 0
    out = np.zeros((n, img_h, img_w), np.float64 if probs else bool)
    for i in range(n):
        x1, y1, x2, y2 = boxes[i, :4]
        w = x2 - x1
        h = y2 - y1
        if w <= 0 or h <= 0:
            continue
        # integer paste window with 1 px of slack on each side
        ix1 = max(int(np.floor(x1)) - 1, 0)
        iy1 = max(int(np.floor(y1)) - 1, 0)
        ix2 = min(int(np.ceil(x2)) + 1, img_w)
        iy2 = min(int(np.ceil(y2)) + 1, img_h)
        if ix2 <= ix1 or iy2 <= iy1:
            continue
        ys = (np.arange(iy1, iy2) + 0.5 - y1) / h * s - 0.5
        xs = (np.arange(ix1, ix2) + 0.5 - x1) / w * s - 0.5
        val = _bilinear_2d(mask_probs[i], ys, xs)
        out[i, iy1:iy2, ix1:ix2] = val if probs else val >= threshold
    return out


def _bilinear_2d(img: np.ndarray, ys: np.ndarray,
                 xs: np.ndarray) -> np.ndarray:
    """Sample img at the outer product of ys and xs; out-of-range taps
    contribute 0."""
    h, w = img.shape
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    wy = ys - y0
    wx = xs - x0

    def tap(yy, xx):
        yv = (yy >= 0) & (yy < h)
        xv = (xx >= 0) & (xx < w)
        v = img[np.ix_(np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1))]
        return v * np.outer(yv, xv)

    return (tap(y0, x0) * np.outer(1 - wy, 1 - wx)
            + tap(y0, x0 + 1) * np.outer(1 - wy, wx)
            + tap(y0 + 1, x0) * np.outer(wy, 1 - wx)
            + tap(y0 + 1, x0 + 1) * np.outer(wy, wx))


# ------------------------------------------------------------------- RLE
def mask_to_rle(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> COCO compressed RLE dict (the host library;
    ``core/rle.py`` ``encode`` is the plain version)."""
    h, w = mask.shape
    return {'size': [int(h), int(w)],
            'counts': host_ops.rle_to_string(host_ops.rle_encode(mask))}


def encode_mask_results(mask_results: List[List[np.ndarray]]) -> List[List]:
    """Per-class lists of full-image masks -> per-class lists of RLE dicts
    (reference core/mask/utils.py:36)."""
    return [[mask_to_rle(m) for m in cls_masks] for cls_masks in mask_results]


def rle_counts(rle: Dict) -> np.ndarray:
    """The uncompressed counts of a compressed or uncompressed RLE dict."""
    counts = rle['counts']
    if isinstance(counts, str):
        counts = counts.encode()
    if isinstance(counts, bytes):
        return host_ops.rle_from_string(counts)
    return np.asarray(counts, np.int64)


def rle_area(rle: Dict) -> int:
    """Foreground pixels of an RLE dict."""
    return int(rle_counts(rle)[1::2].sum())


def rle_iou(dt: Sequence[Dict], gt: Sequence[Dict],
            iscrowd: Sequence[bool]) -> np.ndarray:
    """Pairwise mask IoU, pycocotools maskUtils.iou semantics: a crowd gt's
    union is the detection's area (the host library, a sweep of the run
    lists; ``core/rle.py`` ``iou`` is the plain version)."""
    return host_ops.rle_iou([rle_counts(d) for d in dt],
                            [rle_counts(g) for g in gt], iscrowd)


def rle_to_mask(rle: Dict) -> np.ndarray:
    """COCO RLE dict (compressed bytes / str or uncompressed list) to a
    binary (H, W) mask."""
    h, w = rle['size']
    return host_ops.rle_decode(rle_counts(rle), h, w)


# -------------------------------------------------------------- polygons
def poly2mask(polygons: Sequence[Sequence[float]], h: int,
              w: int) -> np.ndarray:
    """COCO polygon(s) of one object to an (h, w) bool mask: vertices
    rounded half to even, polygons with fewer than 3 points dropped, all
    of them filled together (even-odd, as ``cv2.fillPoly``)."""
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round()
           .astype(np.int32).astype(np.int64)
           for p in polygons if len(p) >= 6]
    if pts:
        _fill_poly(mask, pts)
    return mask.astype(bool)


def _outside(w: int, h: int, x0: int, y0: int, x1: int, y1: int) -> bool:
    return not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int
               ) -> Tuple[bool, int, int, int, int]:
    """cv2.clipLine to the (w, h) image: Cohen-Sutherland with cv2's
    double arithmetic truncated toward zero. Returns (inside, x1, y1, x2,
    y2); a line wholly outside may come back partly moved, as in cv2."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_line(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int
               ) -> None:
    """cv2.line of thickness 1, LINE_8: clipped to the image, drawn left
    to right; the minor axis steps where Bresenham's error (dx - 2 dy,
    less 2 dy a step, plus 2 dx a minor step) was negative, which is
    minor offset ceil((2 dy k - dx) / (2 dx)) after k steps."""
    h, w = mask.shape
    if _outside(w, h, x1, y1, x2, y2):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = -1 if y2 < y1 else 1
    major, minor = max(dx, dy), min(dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * k) // (2 * major)) if major else k
    if dy > dx:
        mask[y1 + sy * k, x1 + m] = 1
    else:
        mask[y1 + sy * m, x1 + k] = 1


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_poly(mask: np.ndarray, polys: List[np.ndarray]) -> None:
    """cv2.fillPoly(mask, polys, 1) with LINE_8 and shift 0.

    cv2's CollectPolyEdges draws each edge as a line; an edge with an end
    off the image takes the clipped line's x ends (and its y ends where
    they differ) for its slope and start, in fixed point. Each edge is
    half-open in y, [y0, y1), and horizontal ones are dropped; on each
    row the active edges, ordered by x, pair up, and a pair fills from the
    left edge's x rounded up to the right edge's x rounded down, clipped
    to the row."""
    h, w = mask.shape
    ey0, ey1, ex, edx = [], [], [], []
    for poly in polys:
        for i in range(len(poly)):
            x0, y0 = (int(v) for v in poly[i - 1])
            x1, y1 = (int(v) for v in poly[i])
            _draw_line(mask, x0, y0, x1, y1)
            c0x, c0y, c1x, c1y = x0, y0, x1, y1
            if _outside(w, h, x0, y0, x1, y1):
                _, c0x, t0y, c1x, t1y = _clip_line(w, h, x0, y0, x1, y1)
                if t0y != t1y:
                    c0y, c1y = t0y, t1y
            if y0 == y1:
                continue
            dx = _trunc_div((c1x - c0x) << XY_SHIFT, c1y - c0y)
            if y0 < y1:
                ey0.append(y0)
                ey1.append(y1)
                ex.append((c0x << XY_SHIFT) + (y0 - c0y) * dx)
            else:
                ey0.append(y1)
                ey1.append(y0)
                ex.append((c1x << XY_SHIFT) + (y1 - c1y) * dx)
            edx.append(dx)
    if len(ey0) < 2:
        return
    y0, y1 = np.array(ey0, np.int64), np.array(ey1, np.int64)
    x, dx = np.array(ex, np.int64), np.array(edx, np.int64)
    lo, hi = np.clip(y0, 0, h), np.clip(y1, 0, h)
    n = np.maximum(hi - lo, 0)
    if not n.sum():
        return
    # one (row, x) entry per edge per row it is active on the image
    edge = np.repeat(np.arange(len(n)), n)
    rows = lo[edge] + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    xs = x[edge] + (rows - y0[edge]) * dx[edge]
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    # every row holds an even number of edges, so pairs are consecutive
    r = rows[0::2]
    left = (xs[0::2] + (1 << XY_SHIFT) - 1) >> XY_SHIFT
    right = xs[1::2] >> XY_SHIFT
    keep = (left < w) & (right >= 0)
    r, left, right = r[keep], np.maximum(left[keep], 0), \
        np.minimum(right[keep], w - 1)
    diff = np.zeros((h, w + 1), np.int32)
    np.add.at(diff, (r, left), 1)
    np.add.at(diff, (r, right + 1), -1)
    mask[np.cumsum(diff[:, :w], 1) > 0] = 1
