"""Grid anchors and points (counterpart of ``swindet_tpu/core/anchors.py``:
``AnchorGenerator`` :19 with ``valid_flags`` :115, ``PointGenerator`` :140,
``anchor_inside_flags`` :175; reference
mmdet/core/anchor/anchor_generator.py:10, point_generator.py)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..registries import ANCHOR_GENERATORS


@ANCHOR_GENERATORS.register_module()
class AnchorGenerator:
    """Multi-level grid anchors: base anchors are the outer product of
    ``scales`` and ``ratios`` around a centre, shifted by the stride."""

    def __init__(self, strides: Sequence, ratios: Sequence[float],
                 scales: Sequence[float]):
        self.strides = [s if isinstance(s, (tuple, list)) else (s, s)
                        for s in strides]
        self.scales = np.array(scales, dtype=np.float64)
        self.ratios = np.array(ratios, dtype=np.float64)
        self.base_anchors = [self._base_anchors(min(s))
                             for s in self.strides]
        self._grid_cache: Dict[Tuple, List[torch.Tensor]] = {}

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    def _base_anchors(self, base_size) -> np.ndarray:
        """(len(ratios) * len(scales), 4) anchors centred on the origin,
        scale index fastest."""
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (base_size * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (base_size * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        base = np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs], axis=-1)
        return base.astype(np.float32)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]],
                     device='cpu') -> List[torch.Tensor]:
        """Per level (H*W*A, 4) fp32 anchors, row-major over the grid
        with the base-anchor index fastest. Cached per sizes and device,
        made outside inference mode so that training may reuse them."""
        key = (tuple(tuple(s) for s in featmap_sizes), str(device))
        if key not in self._grid_cache:
            out = []
            for lvl, (fh, fw) in enumerate(featmap_sizes):
                sw, sh = self.strides[lvl]
                sx, sy = np.meshgrid(np.arange(fw, dtype=np.float32) * sw,
                                     np.arange(fh, dtype=np.float32) * sh)
                shifts = np.stack([sx.ravel(), sy.ravel(),
                                   sx.ravel(), sy.ravel()], axis=-1)
                anchors = (self.base_anchors[lvl][None]
                           + shifts[:, None]).reshape(-1, 4)
                with torch.inference_mode(False):
                    out.append(torch.from_numpy(anchors).to(device))
            self._grid_cache[key] = out
        return self._grid_cache[key]

    def valid_flags(self, featmap_sizes: Sequence[Tuple[int, int]],
                    pad_shape: torch.Tensor) -> List[torch.Tensor]:
        """Per level (H*W*A,) bool flags of the anchors whose grid cell
        lies inside the valid region ``pad_shape`` (H, W) (a tensor, so
        the flags stay on the device) of the padded canvas."""
        out = []
        dev = pad_shape.device
        for lvl, (fh, fw) in enumerate(featmap_sizes):
            sw, sh = self.strides[lvl]
            vh = torch.clamp((pad_shape[0] + sh - 1) // sh, max=fh)
            vw = torch.clamp((pad_shape[1] + sw - 1) // sw, max=fw)
            vx = torch.arange(fw, device=dev) < vw
            vy = torch.arange(fh, device=dev) < vh
            valid = (vy[:, None] & vx[None, :]).reshape(-1)
            out.append(valid.repeat_interleave(self.num_base_anchors[lvl]))
        return out


@ANCHOR_GENERATORS.register_module()
class PointGenerator:
    """Grid points of anchor-free heads: one point per feature cell at its
    top-left corner in image pixels, with its stride."""

    def __init__(self):
        self._grid_cache: Dict[Tuple, torch.Tensor] = {}

    def grid_points(self, featmap_size: Tuple[int, int], stride: int = 16,
                    device='cpu', dtype=torch.float32) -> torch.Tensor:
        """(H * W, 3) ``[x, y, stride]``, row-major over the grid. Built
        from numpy, cached per size, stride, device and dtype, and made
        outside inference mode so that training may reuse them."""
        fh, fw = int(featmap_size[0]), int(featmap_size[1])
        key = (fh, fw, stride, str(device), dtype)
        if key not in self._grid_cache:
            sx, sy = np.meshgrid(np.arange(0., fw) * stride,
                                 np.arange(0., fh) * stride)
            points = np.stack([sx.ravel(), sy.ravel(),
                               np.full(fh * fw, float(stride))], axis=-1)
            with torch.inference_mode(False):
                self._grid_cache[key] = torch.from_numpy(points).to(
                    device=device, dtype=dtype)
        return self._grid_cache[key]

    def valid_flags(self, featmap_size: Tuple[int, int], valid_size,
                    device='cpu') -> torch.Tensor:
        """(H * W,) bool: the points whose cell lies inside the valid
        ``(h, w)`` of the grid."""
        fh, fw = featmap_size
        vh, vw = valid_size
        vx = torch.arange(fw, device=device) < vw
        vy = torch.arange(fh, device=device) < vh
        return (vy[:, None] & vx[None, :]).reshape(-1)


def anchor_inside_flags(flat_anchors: torch.Tensor, valid_flags: torch.Tensor,
                        img_shape: torch.Tensor,
                        allowed_border: int = 0) -> torch.Tensor:
    """Border filtering (reference anchor/utils.py:20): with
    ``allowed_border`` >= 0, anchors must also lie within the image
    (H, W) grown by that margin."""
    if allowed_border < 0:
        return valid_flags
    h, w = img_shape[0], img_shape[1]
    return (valid_flags
            & (flat_anchors[:, 0] >= -allowed_border)
            & (flat_anchors[:, 1] >= -allowed_border)
            & (flat_anchors[:, 2] < w + allowed_border)
            & (flat_anchors[:, 3] < h + allowed_border))
