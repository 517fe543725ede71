"""The host mask library (``csrc/rle_ops.cpp``, counterpart of
``swindet_tpu/native/rle_ops.cpp`` and its loader
``swindet_tpu/native/__init__.py:27-147``): the COCO RLE codec, the
pairwise RLE IoU and the paste of mask probabilities, in C++ bound with
ctypes.

The library is built with g++ at first use into ``build/host/`` at the
root of the checkout, named after a hash of its source and flags. Where
g++ is missing or fails, the build raises and names g++: nothing falls
back to the numpy versions, which ``core/masks.py`` keeps as the plain
versions that the tests hold this library to.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Sequence

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / 'csrc' / 'rle_ops.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'host'
# no -march=native: the library may be built on one host and run on
# another; no contraction, so the paste rounds as numpy does
GXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-ffp-contract=off')

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64 = ctypes.c_int64


def library_path() -> Path:
    h = hashlib.sha256(CSRC.read_bytes())
    h.update(' '.join(GXX_FLAGS).encode())
    return BUILD_DIR / f'rle_ops-{h.hexdigest()[:16]}.so'


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The library, built by g++ if it is not built yet."""
    path = library_path()
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(['g++', *GXX_FLAGS, str(CSRC), '-o', tmp],
                                 capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f'host mask library: g++ failed on '
                                   f'{CSRC.name}:\n{res.stderr}')
            os.replace(tmp, path)
        except FileNotFoundError as e:
            raise RuntimeError('host mask library: g++ not found; the '
                               'mask paste and RLE need it') from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    so = ctypes.CDLL(str(path))
    so.rle_decode.argtypes = [_u32p, _i64, _u8p, _i64]
    so.rle_decode.restype = None
    so.rle_encode.argtypes = [_u8p, _i64, _i64, _u32p]
    so.rle_encode.restype = _i64
    so.rle_to_string.argtypes = [_u32p, _i64, ctypes.c_char_p]
    so.rle_to_string.restype = _i64
    so.rle_from_string.argtypes = [ctypes.c_char_p, _i64, _i64p]
    so.rle_from_string.restype = _i64
    so.rle_iou.argtypes = [_u32p, _i64p, _i64, _u32p, _i64p, _i64, _u8p,
                           _f64p]
    so.rle_iou.restype = None
    so.paste_masks.argtypes = [_f32p, _i64, _i64, _f32p, _i64, _i64,
                               ctypes.c_double, _u8p]
    so.paste_masks.restype = None
    return so


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def rle_decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Uncompressed counts -> (h, w) bool mask."""
    counts = np.ascontiguousarray(counts, np.uint32)
    out = np.empty(h * w, np.uint8)
    lib().rle_decode(_ptr(counts, ctypes.c_uint32), counts.size,
                     _ptr(out, ctypes.c_uint8), h * w)
    return out.reshape(w, h).T.view(bool)


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """(h, w) mask -> uncompressed counts (uint32) of its column-major
    runs."""
    m = np.ascontiguousarray(mask)
    if m.dtype != np.uint8:
        m = m.astype(np.uint8) if m.dtype != bool else m.view(np.uint8)
    h, w = m.shape
    out = np.empty(h * w + 1, np.uint32)
    n = lib().rle_encode(_ptr(m, ctypes.c_uint8), h, w,
                         _ptr(out, ctypes.c_uint32))
    return out[:n].copy()


def rle_to_string(counts: np.ndarray) -> bytes:
    """Counts -> pycocotools' compressed string."""
    counts = np.ascontiguousarray(counts, np.uint32)
    buf = ctypes.create_string_buffer(7 * counts.size + 1)
    n = lib().rle_to_string(_ptr(counts, ctypes.c_uint32), counts.size, buf)
    return buf.raw[:n]


def rle_from_string(s: bytes) -> np.ndarray:
    """pycocotools' compressed string -> counts (int64)."""
    out = np.empty(len(s), np.int64)
    n = lib().rle_from_string(s, len(s), _ptr(out, ctypes.c_int64))
    return out[:n].copy()


def _concat(counts_list: Sequence[np.ndarray]):
    flat = np.ascontiguousarray(np.concatenate(
        [np.asarray(c, np.uint32) for c in counts_list]), np.uint32)
    off = np.zeros(len(counts_list) + 1, np.int64)
    np.cumsum([len(c) for c in counts_list], out=off[1:])
    return flat, off


def rle_iou(dt_counts: List[np.ndarray], gt_counts: List[np.ndarray],
            iscrowd: Sequence) -> np.ndarray:
    """(D, G) IoU of masks given by their uncompressed counts; a crowd gt's
    union is the detection's area."""
    d, g = len(dt_counts), len(gt_counts)
    out = np.zeros((d, g), np.float64)
    if d == 0 or g == 0:
        return out
    dt, dt_off = _concat(dt_counts)
    gt, gt_off = _concat(gt_counts)
    crowd = np.ascontiguousarray(np.asarray(iscrowd, bool), np.uint8)
    lib().rle_iou(_ptr(dt, ctypes.c_uint32), _ptr(dt_off, ctypes.c_int64), d,
                  _ptr(gt, ctypes.c_uint32), _ptr(gt_off, ctypes.c_int64), g,
                  _ptr(crowd, ctypes.c_uint8), _ptr(out, ctypes.c_double))
    return out


def paste_masks(mask_probs: np.ndarray, boxes: np.ndarray, img_h: int,
                img_w: int, threshold: float = 0.5) -> np.ndarray:
    """(n, s, s) probabilities at (n, 4) boxes -> (n, img_h, img_w) bool
    masks."""
    probs = np.ascontiguousarray(mask_probs, np.float32)
    n = probs.shape[0]
    s = probs.shape[1] if n else 0
    bx = np.ascontiguousarray(np.asarray(boxes, np.float32)[:, :4])
    out = np.empty((n, img_h, img_w), np.uint8)
    if n:
        lib().paste_masks(_ptr(probs, ctypes.c_float), n, s,
                          _ptr(bx, ctypes.c_float), img_h, img_w,
                          float(threshold), _ptr(out, ctypes.c_uint8))
    return out.view(bool)
