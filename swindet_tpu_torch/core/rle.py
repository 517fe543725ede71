"""COCO RLE mask codec in numpy, wire-compatible with pycocotools (a copy
of ``swindet_tpu/core/rle.py``; reference pycocotools.mask, mmdet
core/mask/utils.py:36).

Runs are column-major (Fortran order), counts start with the number of
leading zeros; the compressed string is the 5-bit varint + delta coding
of pycocotools' rleToString. Polygons are filled by ``core/masks.py``'s
port of ``cv2.fillPoly``. These are the plain versions: the host library
``core/host_ops.py`` does the same work in C++ on the evaluation path.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from .masks import _fill_poly

RLEObj = Dict[str, Union[Sequence[int], bytes, str, list]]


# --------------------------------------------------------------- counts <-> str
def counts_to_string(counts: np.ndarray) -> bytes:
    """pycocotools rleToString: delta-code counts[i>=2] against
    counts[i-2], then 5-bit varint chars offset by 48."""
    out = bytearray()
    cnts = [int(c) for c in counts]
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1f
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def string_to_counts(s: Union[str, bytes]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    cnts: List[int] = []
    pos = 0
    n = len(s)
    while pos < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[pos] - 48
            x |= (c & 0x1f) << (5 * k)
            more = bool(c & 0x20)
            pos += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, np.int64)


# ------------------------------------------------------------------ mask <-> rle
def encode(mask: np.ndarray) -> RLEObj:
    """Binary (H, W) or (H, W, N) mask → compressed RLE (list for N)."""
    if mask.ndim == 3:
        return [encode(mask[:, :, i]) for i in range(mask.shape[2])]
    h, w = mask.shape
    flat = np.asfortranarray(mask).reshape(-1, order='F').astype(np.uint8)
    # run-length: positions where value changes
    diff = np.nonzero(np.diff(flat))[0]
    runs = np.diff(np.concatenate([[-1], diff, [flat.size - 1]]))
    if flat.size and flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return {'size': [int(h), int(w)],
            'counts': counts_to_string(runs)}


def decode(rle: Union[RLEObj, List[RLEObj]]) -> np.ndarray:
    """Compressed or uncompressed RLE → binary (H, W) uint8 mask
    ((H, W, N) for a list)."""
    if isinstance(rle, list):
        return np.stack([decode(r) for r in rle], axis=2) if rle else \
            np.zeros((0, 0, 0), np.uint8)
    h, w = rle['size']
    counts = rle['counts']
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    else:
        counts = np.asarray(counts, np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    total = h * w
    if flat.size < total:
        flat = np.concatenate([flat, np.zeros(total - flat.size, np.uint8)])
    return flat[:total].reshape((h, w), order='F')


def area(rle: Union[RLEObj, List[RLEObj]]):
    if isinstance(rle, list):
        return [area(r) for r in rle]
    counts = rle['counts']
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return int(np.sum(np.asarray(counts[1::2], np.int64)))


def to_bbox(rle: Union[RLEObj, List[RLEObj]]):
    """RLE → [x, y, w, h] (pycocotools rleToBbox semantics)."""
    if isinstance(rle, list):
        return np.array([to_bbox(r) for r in rle], np.float64)
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4, np.float64)
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    return np.array([x0, y0, x1 - x0 + 1, y1 - y0 + 1], np.float64)


def merge(rles: List[RLEObj], intersect: bool = False) -> RLEObj:
    if len(rles) == 1:
        return rles[0]
    acc = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m = decode(r).astype(bool)
        acc = (acc & m) if intersect else (acc | m)
    return encode(acc.astype(np.uint8))


def frPyObjects(objs, h: int, w: int):
    """Polygons / uncompressed RLE / bbox → compressed RLE
    (pycocotools frPyObjects surface)."""
    def one(obj):
        if isinstance(obj, dict) and 'counts' in obj:
            if isinstance(obj['counts'], (str, bytes)):
                return dict(obj)
            return {'size': obj['size'],
                    'counts': counts_to_string(
                        np.asarray(obj['counts'], np.int64))}
        if isinstance(obj, (list, np.ndarray)) and len(obj) and \
                np.isscalar(obj[0]) and len(obj) == 4:
            x, y, bw, bh = obj
            m = np.zeros((h, w), np.uint8)
            m[int(y):int(np.ceil(y + bh)), int(x):int(np.ceil(x + bw))] = 1
            return encode(m)
        # polygon: flat [x1,y1,x2,y2,...]
        poly = np.asarray(obj, np.float64).reshape(-1, 2)
        m = np.zeros((h, w), np.uint8)
        _fill_poly(m, [np.round(poly).astype(np.int32).astype(np.int64)])
        return encode(m)

    if isinstance(objs, (list, tuple)) and len(objs) and \
            not np.isscalar(objs[0]) and not isinstance(objs, dict):
        if isinstance(objs[0], dict) or isinstance(objs[0], (list, np.ndarray)):
            return [one(o) for o in objs]
    return one(objs)


def iou(dts, gts, iscrowd) -> np.ndarray:
    """Mask IoU matrix (D, G); crowd gt → intersection/det_area
    (pycocotools iou semantics)."""
    d = len(dts)
    g = len(gts)
    out = np.zeros((d, g), np.float64)
    if d == 0 or g == 0:
        return out
    dmasks = [decode(r).astype(bool) for r in dts]
    gmasks = [decode(r).astype(bool) for r in gts]
    dareas = [m.sum() for m in dmasks]
    gareas = [m.sum() for m in gmasks]
    for j in range(g):
        for i in range(d):
            inter = np.logical_and(dmasks[i], gmasks[j]).sum()
            if iscrowd[j]:
                denom = dareas[i]
            else:
                denom = dareas[i] + gareas[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out
