"""Pipeline steps (counterparts of
``swindet_tpu/datasets/pipelines/transforms.py``), numpy and torch only:
loading, the train-time Resize, RandomFlip, RandomCrop and AutoAugment,
Normalize, Pad, the format steps, FilterAnnotations and the test-time
fan-out MultiScaleFlipAug.

The image resize is cv2's INTER_LINEAR: bilinear with half-pixel centres
and no antialiasing. A uint8 image goes through cv2's fixed-point
arithmetic (11-bit weights, its rounding and its border rules), so it
equals ``cv2.resize`` bit for bit; any other dtype is resized in float by
``F.interpolate``. Masks are resized as cv2's INTER_NEAREST, bit for bit.

Every random step draws from ``results['_rng']``, the sample's own
``np.random.RandomState`` (``datasets/custom.py`` ``sample_rng``), as the
JAX transforms draw from that key when it is set.
"""
from __future__ import annotations

import os.path as osp
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.masks import poly2mask, rle_to_mask
from ..registries import PIPELINES
from ..utils.registry import build_from_cfg
from .image_io import imread


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


def imresize_nearest(img: np.ndarray, size_wh: Tuple[int, int]
                     ) -> np.ndarray:
    """cv2.resize(img, size_wh, INTER_NEAREST) of a (..., H, W) array,
    bit for bit: destination pixel x reads source floor(x / (w' / w)),
    with cv2's double arithmetic, clamped to the last pixel."""
    new_w, new_h = size_wh
    h, w = img.shape[-2:]
    if (h, w) == (new_h, new_w):
        return img.copy()
    sx = np.minimum(np.floor(np.arange(new_w) * (1.0 / (new_w / w)))
                    .astype(np.int64), w - 1)
    sy = np.minimum(np.floor(np.arange(new_h) * (1.0 / (new_h / h)))
                    .astype(np.int64), h - 1)
    return np.ascontiguousarray(img[..., sy, :][..., sx])


def _rng(results: Dict) -> np.random.RandomState:
    """The sample's generator: a random step needs one."""
    try:
        return results['_rng']
    except KeyError:
        raise KeyError('a random pipeline step needs the sample\'s '
                       'generator in results[\'_rng\'] (the dataset\'s '
                       'get(idx, rng) puts it there)') from None


class Compose:
    """Steps in order; a step that returns None drops the sample."""

    def __init__(self, transforms: Sequence):
        self.transforms = [build_from_cfg(dict(t), PIPELINES)
                           if isinstance(t, dict) else t for t in transforms]

    def __call__(self, results: Optional[Dict]) -> Optional[Dict]:
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


@PIPELINES.register_module()
class LoadImageFromFile:
    """The image file as BGR uint8 (``image_io.imread``)."""

    def __init__(self, to_float32: bool = False,
                 color_type: str = 'color', **kwargs):
        if color_type != 'color':
            raise NotImplementedError(f'LoadImageFromFile: color_type '
                                      f'{color_type!r}; color only')
        self.to_float32 = to_float32

    def __call__(self, results):
        info = results['img_info']
        prefix = results.get('img_prefix')
        filename = (osp.join(prefix, info['filename']) if prefix
                    else info['filename'])
        img = imread(filename)
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = filename
        results['ori_filename'] = info['filename']
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['img_fields'] = ['img']
        return results


@PIPELINES.register_module()
class LoadImageFromWebcam(LoadImageFromFile):
    """The image already in ``results['img']`` (reference loading.py:81)."""

    def __call__(self, results):
        img = results['img']
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = None
        results['ori_filename'] = None
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['img_fields'] = ['img']
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    """Boxes, labels and masks of ``results['ann_info']``; polygons and
    RLE are rasterised at once to (G, H, W) uint8."""

    def __init__(self, with_bbox: bool = True, with_label: bool = True,
                 with_mask: bool = False, with_seg: bool = False,
                 poly2mask: bool = True, **kwargs):
        if with_seg:
            raise NotImplementedError('LoadAnnotations: with_seg is not '
                                      'ported (ROADMAP §1 item 8)')
        self.with_bbox = with_bbox
        self.with_label = with_label
        self.with_mask = with_mask

    def __call__(self, results):
        ann = results['ann_info']
        if self.with_bbox:
            results['gt_bboxes'] = ann['bboxes'].astype(np.float32).copy()
            results['bbox_fields'] = ['gt_bboxes']
            ignore = ann.get('bboxes_ignore')
            if ignore is not None:
                results['gt_bboxes_ignore'] = \
                    ignore.astype(np.float32).copy()
                results['bbox_fields'].append('gt_bboxes_ignore')
        if self.with_label:
            results['gt_labels'] = ann['labels'].astype(np.int64).copy()
        if self.with_mask:
            h, w = results['img_shape'][:2]
            masks = []
            for m in ann['masks']:
                if isinstance(m, list):
                    masks.append(poly2mask(m, h, w))
                elif isinstance(m, dict):
                    masks.append(rle_to_mask(m))
                else:
                    masks.append(np.asarray(m, bool))
            results['gt_masks'] = (np.stack(masks).astype(np.uint8)
                                   if masks else
                                   np.zeros((0, h, w), np.uint8))
            results['mask_fields'] = ['gt_masks']
        return results


@PIPELINES.register_module()
class Resize:
    """keep_ratio (or exact) resize to ``results['scale']`` when a caller
    set it (the test scale), else to a scale drawn from ``img_scale``:
    the only one, one of the list ('value'), long and short edges drawn
    from the list's ranges ('range'), or the first scale times a ratio
    from ``ratio_range``; ``override`` draws again over an earlier
    Resize's scale. Boxes scale (clipped to the image with
    ``bbox_clip_border``), masks resize nearest."""

    def __init__(self, img_scale=None, multiscale_mode: str = 'range',
                 ratio_range=None, keep_ratio: bool = True,
                 override: bool = False, bbox_clip_border: bool = True,
                 interpolation: str = 'bilinear'):
        if interpolation != 'bilinear':
            raise NotImplementedError(f'Resize: interpolation '
                                      f'{interpolation!r}; bilinear only')
        if img_scale is None:
            self.img_scale = None
        elif isinstance(img_scale, list):
            self.img_scale = [tuple(s) for s in img_scale]
        else:
            self.img_scale = [tuple(img_scale)]
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.override = override
        self.bbox_clip_border = bbox_clip_border

    def _random_scale(self, results):
        if self.ratio_range is not None:
            base = self.img_scale[0]
            lo, hi = self.ratio_range
            r = _rng(results).uniform(lo, hi)
            scale = (int(base[0] * r), int(base[1] * r))
        elif len(self.img_scale) == 1:
            scale = self.img_scale[0]
        elif self.multiscale_mode == 'value':
            scale = self.img_scale[_rng(results).randint(len(self.img_scale))]
        else:  # 'range'
            rng = _rng(results)
            longs = [max(s) for s in self.img_scale]
            shorts = [min(s) for s in self.img_scale]
            long_e = rng.randint(min(longs), max(longs) + 1)
            short_e = rng.randint(min(shorts), max(shorts) + 1)
            scale = (long_e, short_e)
        results['scale'] = scale

    def __call__(self, results):
        if 'scale' not in results or self.override:
            if self.override and 'scale_factor' in results:
                results.pop('scale_factor', None)
            self._random_scale(results)
        img = results['img']
        h, w = img.shape[:2]
        if self.keep_ratio:
            new_w, new_h = rescale_size((w, h), results['scale'])
        else:
            new_w, new_h = results['scale'][1], results['scale'][0]
        img = imresize_bilinear(img, (new_w, new_h))
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = img
        results['img_shape'] = img.shape
        results['pad_shape'] = img.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        results['keep_ratio'] = self.keep_ratio

        for key in results.get('bbox_fields', []):
            bboxes = results[key] * results['scale_factor']
            if self.bbox_clip_border:
                bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, new_w)
                bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, new_h)
            results[key] = bboxes
        for key in results.get('mask_fields', []):
            m = results[key]
            results[key] = (imresize_nearest(m, (new_w, new_h))
                            if m.shape[0] else
                            np.zeros((0, new_h, new_w), m.dtype))
        return results


def _flip(img: np.ndarray, direction: str, axes=(0, 1)) -> np.ndarray:
    """``img`` flipped along its rows (``axes[0]``) and/or columns
    (``axes[1]``)."""
    index = [slice(None)] * img.ndim
    if direction in ('horizontal', 'diagonal'):
        index[axes[1]] = slice(None, None, -1)
    if direction in ('vertical', 'diagonal'):
        index[axes[0]] = slice(None, None, -1)
    return np.ascontiguousarray(img[tuple(index)])


@PIPELINES.register_module()
class RandomFlip:
    """Flip image, boxes and masks with probability
    ``flip_ratio`` (drawn only where the caller did not set
    ``results['flip']``; the inference path sets it False)."""

    def __init__(self, flip_ratio: Optional[float] = None,
                 direction: str = 'horizontal'):
        if direction not in ('horizontal', 'vertical', 'diagonal'):
            raise ValueError(f'RandomFlip: direction {direction!r}')
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results):
        if 'flip' not in results:
            results['flip'] = (self.flip_ratio is not None
                               and _rng(results).rand() < self.flip_ratio)
            results['flip_direction'] = self.direction
        results.setdefault('flip_direction', self.direction)
        if not results['flip']:
            return results
        h, w = results['img_shape'][:2]
        d = results['flip_direction']
        for key in results.get('img_fields', ['img']):
            results[key] = _flip(results[key], d)
        for key in results.get('bbox_fields', []):
            old = results[key]
            b = old.copy()
            if d in ('horizontal', 'diagonal'):
                b[:, 0::4], b[:, 2::4] = w - old[:, 2::4], w - old[:, 0::4]
            if d in ('vertical', 'diagonal'):
                b[:, 1::4], b[:, 3::4] = h - old[:, 3::4], h - old[:, 1::4]
            results[key] = b
        for key in results.get('mask_fields', []):
            results[key] = _flip(results[key], d, axes=(1, 2))
        return results


@PIPELINES.register_module()
class RandomCrop:
    """Crop at a random offset, of size 'absolute' (crop_size, at most the
    image), 'absolute_range' (h and w drawn in [crop_size[0],
    crop_size[1]]), 'relative' or 'relative_range' (fractions of the
    image); boxes shift and clip, and gts left empty are dropped with
    their labels and masks. A crop that keeps no box returns None, which
    makes the dataset draw another sample, unless
    ``allow_negative_crop``."""

    def __init__(self, crop_size, crop_type: str = 'absolute',
                 allow_negative_crop: bool = False,
                 bbox_clip_border: bool = True):
        if crop_type not in ('absolute', 'absolute_range', 'relative',
                             'relative_range'):
            raise ValueError(f'RandomCrop: crop_type {crop_type!r}')
        self.crop_size = tuple(crop_size)
        self.crop_type = crop_type
        self.allow_negative_crop = allow_negative_crop
        self.bbox_clip_border = bbox_clip_border

    def _get_crop_size(self, img_shape, rng):
        h, w = img_shape[:2]
        ch, cw = self.crop_size
        if self.crop_type == 'absolute':
            return min(ch, h), min(cw, w)
        if self.crop_type == 'absolute_range':
            return (rng.randint(min(ch, h), min(cw, h) + 1),
                    rng.randint(min(ch, w), min(cw, w) + 1))
        if self.crop_type == 'relative':
            return int(h * ch + 0.5), int(w * cw + 0.5)
        rh = rng.uniform(ch, 1.0)
        rw = rng.uniform(cw, 1.0)
        return int(h * rh + 0.5), int(w * rw + 0.5)

    def __call__(self, results):
        rng = _rng(results)
        ch, cw = self._get_crop_size(results['img'].shape, rng)
        h, w = results['img'].shape[:2]
        off_h = rng.randint(0, max(h - ch, 0) + 1)
        off_w = rng.randint(0, max(w - cw, 0) + 1)
        for key in results.get('img_fields', ['img']):
            results[key] = results[key][off_h:off_h + ch,
                                        off_w:off_w + cw]
        results['img_shape'] = results['img'].shape

        shift = np.array([off_w, off_h, off_w, off_h], np.float32)
        for key in results.get('bbox_fields', []):
            bboxes = results[key] - shift
            if self.bbox_clip_border:
                bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, cw)
                bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, ch)
            results[key] = bboxes
        if 'gt_bboxes' in results:
            b = results['gt_bboxes']
            valid = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            if not valid.any() and not self.allow_negative_crop:
                return None
            results['gt_bboxes'] = b[valid]
            if 'gt_labels' in results:
                results['gt_labels'] = results['gt_labels'][valid]
            if 'gt_masks' in results:
                results['gt_masks'] = results['gt_masks'][
                    valid, off_h:off_h + ch, off_w:off_w + cw]
        return results


@PIPELINES.register_module()
class AutoAugment:
    """One of ``policies``, each a list of steps, drawn uniformly (the Swin
    configs choose between two resize branches with it)."""

    def __init__(self, policies: Sequence[Sequence[dict]]):
        self.policies = [Compose([dict(p) for p in policy])
                         for policy in policies]

    def __call__(self, results):
        policy = self.policies[_rng(results).randint(len(self.policies))]
        return policy(results)


@PIPELINES.register_module()
class Normalize:
    """(img - mean) / std in fp32; ``to_rgb`` flips a BGR image."""

    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        for key in results.get('img_fields', ['img']):
            img = results[key].astype(np.float32)
            if self.to_rgb:
                img = img[..., ::-1]
            results[key] = (img - self.mean) / self.std
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class Pad:
    """Zero-pad image and masks at the bottom and right, to ``size`` or
    to a multiple of ``size_divisor``."""

    def __init__(self, size=None, size_divisor: Optional[int] = None,
                 pad_val: float = 0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        h, w = results['img'].shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = (h + d - 1) // d * d, (w + d - 1) // d * d
        for key in results.get('img_fields', ['img']):
            img = results[key]
            results[key] = np.pad(
                img, ((0, th - h), (0, tw - w)) + ((0, 0),) * (img.ndim - 2),
                constant_values=self.pad_val)
        for key in results.get('mask_fields', []):
            results[key] = np.pad(results[key],
                                  ((0, 0), (0, th - h), (0, tw - w)))
        results['pad_shape'] = results['img'].shape
        results['pad_fixed_size'] = self.size
        results['pad_size_divisor'] = self.size_divisor
        return results


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """Test-time fan-out (reference test_time_aug.py:10): ``transforms`` run
    once for every scale and flip, scales outer and the unflipped one first
    within a scale. Returns a dict of lists, one entry per augmentation."""

    def __init__(self, transforms: Sequence[dict], img_scale=None,
                 scale_factor=None, flip: bool = False,
                 flip_direction='horizontal'):
        self.transforms = Compose([dict(t) for t in transforms])
        scales = img_scale if img_scale is not None else scale_factor
        if not isinstance(scales, list):
            scales = [scales]
        self.img_scale = [tuple(s) if isinstance(s, (list, tuple)) else s
                          for s in scales]
        self.flip = flip
        self.flip_direction = (flip_direction if isinstance(
            flip_direction, list) else [flip_direction])

    def __call__(self, results):
        aug_data = []
        flips = [(False, None)]
        if self.flip:
            flips += [(True, d) for d in self.flip_direction]
        for scale in self.img_scale:
            for f, d in flips:
                r = dict(results)
                r['scale'] = scale
                r['flip'] = f
                r['flip_direction'] = d or 'horizontal'
                out = self.transforms(r)
                if out is not None:
                    aug_data.append(out)
        return {k: [d[k] for d in aug_data] for k in aug_data[0]}


@PIPELINES.register_module()
class ImageToTensor:
    """Kept for config compatibility: images stay HWC numpy until the
    batch is assembled."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    """Kept for config compatibility: arrays stay numpy until the loader's
    collate (``datasets/builder.py``) pads them onto the batch canvas."""

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class Collect:
    """Select ``keys`` and gather the image metas."""
    META_KEYS = ('filename', 'ori_filename', 'ori_shape', 'img_shape',
                 'pad_shape', 'scale_factor', 'flip', 'flip_direction',
                 'img_norm_cfg')

    def __init__(self, keys, meta_keys=META_KEYS):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        out = {k: results[k] for k in self.keys if k in results}
        out['img_metas'] = {k: results[k] for k in self.meta_keys
                            if k in results}
        return out


@PIPELINES.register_module()
class FilterAnnotations:
    """Drop gts narrower or lower than ``min_gt_bbox_wh``; with
    ``keep_empty=False`` a sample left without gts returns None."""

    def __init__(self, min_gt_bbox_wh=(1., 1.), keep_empty: bool = True):
        self.min_w, self.min_h = min_gt_bbox_wh
        self.keep_empty = keep_empty

    def __call__(self, results):
        b = results.get('gt_bboxes')
        if b is None or b.shape[0] == 0:
            return results
        keep = ((b[:, 2] - b[:, 0]) >= self.min_w) & \
               ((b[:, 3] - b[:, 1]) >= self.min_h)
        if not keep.any() and not self.keep_empty:
            return None
        results['gt_bboxes'] = b[keep]
        if 'gt_labels' in results:
            results['gt_labels'] = results['gt_labels'][keep]
        if 'gt_masks' in results:
            results['gt_masks'] = results['gt_masks'][keep]
        return results
