"""Test-time pipeline steps (counterparts of
``swindet_tpu/datasets/pipelines/transforms.py``: Resize, RandomFlip,
Normalize, Pad, ImageToTensor, Collect), numpy and torch only.

The resize is cv2's INTER_LINEAR: bilinear with half-pixel centres and no
antialiasing. A uint8 image goes through cv2's fixed-point arithmetic
(11-bit weights, its rounding and its border rules), so it equals
``cv2.resize`` bit for bit; any other dtype is resized in float by
``F.interpolate``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..registries import PIPELINES
from ..utils.registry import build_from_cfg


def rescale_size(old_wh: Tuple[int, int],
                 scale: Union[float, Tuple[int, int]]) -> Tuple[int, int]:
    """mmcv rescale_size: a (long, short) scale, order-independent."""
    w, h = old_wh
    if isinstance(scale, (int, float)):
        f = scale
    else:
        f = min(max(scale) / max(h, w), min(scale) / min(h, w))
    return int(w * f + 0.5), int(h * f + 0.5)


# cv2's INTER_RESIZE_COEF_BITS: the uint8 path's weights are fixed point
# with 11 fraction bits
_COEF_SCALE = 2048


def _linear_taps(dst: int, src: int, clamp: bool):
    """Source indices and fixed-point weights of one axis of cv2's uint8
    INTER_LINEAR: the sample position in float32 from the double scale,
    the weights rounded to 1/2048 each on its own. With ``clamp`` (the
    horizontal axis) a sample left of the first or right of the last
    source pixel takes that pixel whole, as cv2 does; the vertical axis
    keeps its weights and clamps only the two row indices."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if clamp:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0
        s[lo], s[hi] = 0, src - 1
    c0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    c1 = np.rint(f * np.float32(_COEF_SCALE))
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            c0.astype(np.int32), c1.astype(np.int32))


def _imresize_uint8(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """cv2.resize(img, (new_w, new_h), INTER_LINEAR) of a uint8 (H, W, C)
    image, bit for bit: int32 horizontal sums, then the vertical
    combination of cv2's SIMD path, with arithmetic shifts."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = (torch.from_numpy(t)
                      for t in _linear_taps(new_w, w, clamp=True))
    y0, y1, b0, b1 = (torch.from_numpy(t)
                      for t in _linear_taps(new_h, h, clamp=False))
    src = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int32)
    # in place: the host resize is on the serving path
    row = src.index_select(1, x0).mul_(a0[:, None])
    row.add_(src.index_select(1, x1).mul_(a1[:, None])).__irshift__(4)
    out = row.index_select(0, y0).mul_(b0[:, None, None]).__irshift__(16)
    out.add_(row.index_select(0, y1).mul_(b1[:, None, None])
             .__irshift__(16))
    out.add_(2).__irshift__(2)
    return out.clamp_(0, 255).to(torch.uint8).numpy()


def imresize_bilinear(img: np.ndarray, size_wh: Tuple[int, int]
                      ) -> np.ndarray:
    """(H, W, C) image to (h, w) = size_wh[::-1], bilinear as cv2's
    INTER_LINEAR (bit for bit for uint8)."""
    new_w, new_h = size_wh
    if img.shape[:2] == (new_h, new_w):
        return img.copy()  # as cv2.resize does: its weights give the input
    if img.dtype == np.uint8:
        return _imresize_uint8(img, new_w, new_h)
    t = torch.from_numpy(np.ascontiguousarray(img)).float()
    t = F.interpolate(t.permute(2, 0, 1)[None], size=(new_h, new_w),
                      mode='bilinear', align_corners=False,
                      antialias=False)[0].permute(1, 2, 0)
    return t.numpy().astype(img.dtype)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = [build_from_cfg(dict(t), PIPELINES)
                           if isinstance(t, dict) else t for t in transforms]

    def __call__(self, results: Dict) -> Dict:
        for t in self.transforms:
            results = t(results)
        return results


@PIPELINES.register_module()
class Resize:
    """keep_ratio rescale to ``results['scale']`` (set by the caller from
    the test scale) or to ``img_scale``."""

    def __init__(self, img_scale=None, keep_ratio: bool = True, **kwargs):
        self.img_scale = None if img_scale is None else tuple(img_scale)
        self.keep_ratio = keep_ratio

    def __call__(self, results):
        scale = results.get('scale', self.img_scale)
        img = results['img']
        h, w = img.shape[:2]
        if self.keep_ratio:
            new_w, new_h = rescale_size((w, h), scale)
        else:
            new_w, new_h = scale[1], scale[0]
        img = imresize_bilinear(img, (new_w, new_h))
        results['img'] = img
        results['img_shape'] = img.shape
        results['pad_shape'] = img.shape
        results['scale_factor'] = np.array(
            [new_w / w, new_h / h, new_w / w, new_h / h], np.float32)
        results['keep_ratio'] = self.keep_ratio
        return results


@PIPELINES.register_module()
class RandomFlip:
    """Test-time flip: only ``flip=False`` is served by this slice."""

    def __init__(self, flip_ratio: Optional[float] = None,
                 direction: str = 'horizontal'):
        self.direction = direction

    def __call__(self, results):
        if results.get('flip'):
            raise NotImplementedError('RandomFlip: test-time flipping is '
                                      'not ported yet')
        results['flip'] = False
        results['flip_direction'] = self.direction
        return results


@PIPELINES.register_module()
class Normalize:
    """(img - mean) / std in fp32; ``to_rgb`` flips a BGR image."""

    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        img = results['img'].astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        results['img'] = (img - self.mean) / self.std
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class Pad:
    """Zero-pad to ``size`` or to a multiple of ``size_divisor``."""

    def __init__(self, size=None, size_divisor: Optional[int] = None,
                 pad_val: float = 0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = (h + d - 1) // d * d, (w + d - 1) // d * d
        results['img'] = np.pad(img, ((0, th - h), (0, tw - w), (0, 0)),
                                constant_values=self.pad_val)
        results['pad_shape'] = results['img'].shape
        return results


@PIPELINES.register_module()
class ImageToTensor:
    """Kept for config compatibility: images stay HWC numpy until the
    batch is assembled."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class Collect:
    """Select ``keys`` and gather the image metas."""
    META_KEYS = ('ori_shape', 'img_shape', 'pad_shape', 'scale_factor',
                 'flip', 'flip_direction', 'img_norm_cfg')

    def __init__(self, keys, meta_keys=META_KEYS):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        out = {k: results[k] for k in self.keys if k in results}
        out['img_metas'] = {k: results[k] for k in self.meta_keys
                            if k in results}
        return out
