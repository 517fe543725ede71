"""Image decoding for the port's loader, without cv2 or PIL: the file's
bytes to a BGR uint8 (H, W, 3) array, ``cv2.imread(path,
cv2.IMREAD_COLOR)``'s layout (the counterpart of ``_imread``,
``swindet_tpu/datasets/pipelines/transforms.py:26``).

- PNG is decoded here, with numpy and zlib: the chunks, the inflate, the
  five row filters (None, Sub, Up, Average, Paeth) undone, gray and
  palette expanded to three channels, alpha dropped. PNG is lossless, so
  this equals cv2 bit for bit. 8-bit images without interlacing only.
- JPEG goes through ``csrc/image_decode.cpp``, libjpeg's decoder, built
  with g++ at first use into ``build/host/`` at the root of the checkout
  and bound with ctypes. Where g++ or libjpeg is missing the build raises
  and names what is missing; nothing falls back to another decoder.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import struct
import subprocess
import tempfile
import zlib
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / 'csrc' / 'image_decode.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'host'
# the flags of swindet_tpu/native/__init__.py's image library, with
# libjpeg alone
GXX_FLAGS = ('-O3', '-march=native', '-std=c++17', '-shared', '-fPIC')

PNG_MAGIC = b'\x89PNG\r\n\x1a\n'
JPEG_MAGIC = b'\xff\xd8'
# channels of each PNG colour type: gray, RGB, palette, gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def imread(path: str) -> np.ndarray:
    """Decode the PNG or JPEG at ``path`` to BGR uint8 (H, W, 3). Raises
    FileNotFoundError for a missing file, ValueError for another format
    or a broken file, RuntimeError when the JPEG decoder cannot be built."""
    with open(path, 'rb') as f:
        data = f.read()
    if data.startswith(PNG_MAGIC):
        return decode_png(data, path)
    if data.startswith(JPEG_MAGIC):
        return decode_jpeg(path)
    raise ValueError(f'{path}: neither PNG nor JPEG')


# ------------------------------------------------------------------- PNG
def decode_png(data: bytes, name: str = 'PNG') -> np.ndarray:
    pos, ihdr, palette, idat = len(PNG_MAGIC), None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f'{name}: truncated {kind!r} chunk')
        if zlib.crc32(kind + body) != struct.unpack(
                '>I', data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f'{name}: bad CRC in {kind!r} chunk')
        pos += 12 + length
        if kind == b'IHDR':
            ihdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if ihdr is None or not idat:
        raise ValueError(f'{name}: no IHDR or IDAT chunk')
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or interlace or ctype not in _PNG_CHANNELS:
        raise ValueError(f'{name}: PNG of bit depth {depth}, colour type '
                         f'{ctype}, interlace {interlace} is not supported '
                         f'(8-bit, not interlaced only)')
    bpp = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f'{name}: {raw.size} bytes of image data for '
                         f'{h}x{w}x{bpp}')
    img = unfilter(raw.reshape(h, w * bpp + 1), bpp).reshape(h, w, bpp)
    if ctype == 3:
        if palette is None or img.max() >= len(palette):
            raise ValueError(f'{name}: palette index out of range')
        rgb = palette[img[..., 0]]
    elif ctype in (0, 4):
        rgb = np.repeat(img[..., :1], 3, axis=2)
    else:
        rgb = img[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters: ``rows`` is (h, 1 + row bytes), each
    row its filter byte then its filtered bytes; ``bpp`` bytes a pixel.
    Without Average or Paeth rows, row by row: None and Up are whole-row
    numpy operations, Sub a running sum over each byte lane. With them,
    every row at once by ``_unfilter_diagonals``."""
    h, n = rows.shape[0], rows.shape[1] - 1
    kinds = rows[:, 0]
    if (kinds > 4).any():
        y = int(np.argmax(kinds > 4))
        raise ValueError(f'PNG row {y}: filter type {kinds[y]}')
    if ((kinds == 3) | (kinds == 4)).any():
        return _unfilter_diagonals(rows, bpp)
    out = np.zeros((h, n), np.uint8)
    prior = np.zeros(n, np.uint8)
    for y in range(h):
        kind, line = kinds[y], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            lanes = line.reshape(-1, bpp).astype(np.int64)
            cur = (np.cumsum(lanes, axis=0) & 0xff).astype(np.uint8) \
                .reshape(n)
        else:
            cur = line + prior
        out[y] = cur
        prior = out[y]
    return out


def _skewed(t: np.ndarray, h: int, w: int) -> np.ndarray:
    """The (h, w, bpp) view of ``t`` (diagonals, rows, bpp) whose pixel
    (y, x) is ``t[y + x, y]``."""
    s0, s1, s2 = t.strides
    return np.lib.stride_tricks.as_strided(
        t, (h, w, t.shape[2]), (s0 + s1, s0, s2))


def _unfilter_diagonals(rows: np.ndarray, bpp: int) -> np.ndarray:
    """``unfilter`` for any mix of the five filters. Pixel (y, x) depends
    on (y, x - 1), (y - 1, x) and (y - 1, x - 1) only, so the pixels of
    one anti-diagonal y + x = d are independent: h + w - 1 steps, each a
    few numpy operations over a diagonal's pixels, and only those of the
    filters its rows use. The image is held skewed, diagonal d at
    ``t[d + 2]`` and row y at ``t[:, y + 1]``, so a step reads the two
    diagonals before it as plain slices; row 0 of ``t`` (the row above
    the image) and every pixel left of x = 0 stay zero."""
    h, w = rows.shape[0], (rows.shape[1] - 1) // bpp
    kinds = rows[:, 0]
    filt = np.zeros((h + w - 1, h, bpp), np.int16)
    _skewed(filt, h, w)[...] = rows[:, 1:].reshape(h, w, bpp)
    t = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    # each diagonal's rows [y0, y1) and the filter types among them
    d = np.arange(h + w - 1)
    y0, y1 = np.maximum(0, d - w + 1), np.minimum(h, d + 1)
    seen = np.zeros((h + 1, 5), np.int64)
    seen[1:] = np.cumsum(kinds[:, None] == np.arange(5), axis=0)
    used = [tuple(np.flatnonzero(r)) for r in seen[y1] > seen[y0]]
    for d, y0, y1, kinds_here in zip(d.tolist(), y0.tolist(), y1.tolist(),
                                     used):
        a = t[d + 1, y0 + 1:y1 + 1]     # left
        b = t[d + 1, y0:y1]             # above
        pred = None
        for kind in kinds_here:
            if kind == 1:
                p = a
            elif kind == 2:
                p = b
            elif kind == 3:
                p = (a + b) >> 1
            elif kind == 4:
                c = t[d, y0:y1]         # above left
                u, v = b - c, a - c
                pa, pb, pc = np.abs(u), np.abs(v), np.abs(u + v)
                p = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
            else:
                continue
            if len(kinds_here) == 1:
                pred = p
            else:
                pred = np.where(kinds[y0:y1, None] == kind, p,
                                0 if pred is None else pred)
        cur = filt[d, y0:y1] if pred is None else filt[d, y0:y1] + pred
        np.bitwise_and(cur, 0xff, out=t[d + 2, y0 + 1:y1 + 1])
    return _skewed(t[2:, 1:], h, w).astype(np.uint8).reshape(h, w * bpp)


# ------------------------------------------------------------------ JPEG
def library_path() -> Path:
    h = hashlib.sha256(CSRC.read_bytes())
    h.update(' '.join(GXX_FLAGS).encode())
    return BUILD_DIR / f'image_decode-{h.hexdigest()[:16]}.so'


@functools.lru_cache(maxsize=None)
def _jpeg_lib() -> ctypes.CDLL:
    """The JPEG library, built by g++ if it is not built yet."""
    path = library_path()
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(['g++', *GXX_FLAGS, str(CSRC), '-o', tmp,
                                  '-ljpeg'], capture_output=True, text=True)
            if res.returncode:
                missing = ('libjpeg (jpeglib.h / libjpeg.so) is missing'
                           if 'jpeglib.h' in res.stderr
                           or '-ljpeg' in res.stderr else 'g++ failed')
                raise RuntimeError(f'JPEG decoder build failed: {missing}:\n'
                                   f'{res.stderr}')
            os.replace(tmp, path)
        except FileNotFoundError as e:
            raise RuntimeError('JPEG decoder build failed: g++ not '
                               'found') from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.swindet_jpeg_size.argtypes = [ctypes.c_char_p, i64p, i64p]
    lib.swindet_jpeg_size.restype = ctypes.c_int
    lib.swindet_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int64]
    lib.swindet_jpeg_decode.restype = ctypes.c_int
    return lib


def decode_jpeg(path: str) -> np.ndarray:
    lib = _jpeg_lib()
    h, w = ctypes.c_int64(), ctypes.c_int64()
    name = os.fsencode(path)
    rc = lib.swindet_jpeg_size(name, ctypes.byref(h), ctypes.byref(w))
    if rc:
        raise ValueError(f'{path}: JPEG header unreadable (code {rc})')
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.swindet_jpeg_decode(
        name, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h.value, w.value)
    if rc:
        raise ValueError(f'{path}: JPEG decode failed (code {rc})')
    return out
