"""SingleRoIExtractor (counterpart of
``swindet_tpu/models/roi_heads/roi_extractor.py:24``; reference
mmdet/models/roi_heads/roi_extractors/single_level_roi_extractor.py:9):
FPN level routing and RoIAlign through the RoIAlign kernels (forward, and
backward into the features in training). A deformable RoI pool layer
(``DeformRoIPoolPack``, ``ModulatedDeformRoIPoolPack``) builds a
:class:`DeformRoIExtractor` instead, as the JAX ``__new__`` does (:26-37).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..layers import normal_
from ...ops.deform_roi_pool import multilevel_deform_roi_pool
from ...ops.roi_align import map_roi_levels, roi_align_op
from ...registries import ROI_EXTRACTORS

_DEFORM_LAYERS = ('DeformRoIPoolPack', 'ModulatedDeformRoIPoolPack')


@ROI_EXTRACTORS.register_module()
class SingleRoIExtractor:

    def __new__(cls, roi_layer: Optional[dict] = None, out_channels: int = 256,
                featmap_strides: Sequence[int] = (4, 8, 16, 32),
                finest_scale: int = 56):
        if roi_layer and roi_layer.get('type') in _DEFORM_LAYERS:
            return DeformRoIExtractor(roi_layer, out_channels,
                                      featmap_strides, finest_scale)
        return super().__new__(cls)

    def __init__(self, roi_layer: dict, out_channels: int,
                 featmap_strides: Sequence[int], finest_scale: int = 56):
        if roi_layer.get('type', 'RoIAlign') != 'RoIAlign':
            raise NotImplementedError(f'SingleRoIExtractor: roi layer '
                                      f'{roi_layer.get("type")}')
        self.out_size = roi_layer['output_size']
        self.sampling_ratio = roi_layer.get('sampling_ratio', 0)
        self.out_channels = out_channels
        self.featmap_strides = list(featmap_strides)
        self.finest_scale = finest_scale

    @property
    def num_inputs(self) -> int:
        return len(self.featmap_strides)

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 roi_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats: per-level NHWC; rois (R, 5) with the batch column.
        Returns (R, out, out, C) in the features' dtype."""
        return roi_align_op([f.contiguous() for f in feats[:self.num_inputs]],
                            rois.float().contiguous(), self.featmap_strides,
                            self.out_size, self.sampling_ratio,
                            self.finest_scale, roi_valid=roi_valid)


class _DeformRoIPoolPack(nn.Module):
    """One level's offset (and mask) predictor, mmcv's Sequential layouts:
    ``offset_fc`` Linear-ReLU-Linear-ReLU-Linear (indices 0, 2, 4),
    ``mask_fc`` Linear-ReLU-Linear (0, 2; the sigmoid after)."""

    def __init__(self, in_features: int, fc_channels: int, out_size: int,
                 modulated: bool):
        super().__init__()
        bins = out_size * out_size
        self.offset_fc = nn.Sequential(
            nn.Linear(in_features, fc_channels), nn.ReLU(),
            nn.Linear(fc_channels, fc_channels), nn.ReLU(),
            nn.Linear(fc_channels, bins * 2))
        self.mask_fc = nn.Sequential(
            nn.Linear(in_features, fc_channels), nn.ReLU(),
            nn.Linear(fc_channels, bins)) if modulated else None


class DeformRoIExtractor(nn.Module):
    """SingleRoIExtractor with a deformable RoI pool layer (counterpart of
    ``swindet_tpu/models/roi_heads/roi_extractor.py:93``; mmcv's
    DeformRoIPoolPack and ModulatedDeformRoIPoolPack).

    A first pass through the RoIAlign kernel feeds, flattened in NCHW
    order (mmcv's Linear rows), the offset FCs of every level's pack, in
    fp32; each roi takes the pack of its FPN level (every pack runs on
    every roi and the level selects, as in the JAX package: no host read).
    The second pass, ``multilevel_deform_roi_pool`` (plain torch), samples
    at the bins moved by gamma * extent * offset; the modulated kind
    scales them by the sigmoid of its mask FCs. The output layers start
    at zero, so a fresh pack pools as RoIAlign does (with a 0.5 mask).
    Returns the features' dtype."""

    def __init__(self, roi_layer: dict, out_channels: int,
                 featmap_strides: Sequence[int], finest_scale: int = 56):
        super().__init__()
        self.out_size = roi_layer['output_size']
        self.sampling_ratio = roi_layer.get('sampling_ratio', 0)
        self.gamma = roi_layer.get('gamma', 0.1)
        self.modulated = roi_layer['type'] == 'ModulatedDeformRoIPoolPack'
        self.out_channels = out_channels
        self.featmap_strides = list(featmap_strides)
        self.finest_scale = finest_scale
        fcc = roi_layer.get('deform_fc_channels', 1024)
        self.roi_layers = nn.ModuleList([
            _DeformRoIPoolPack(out_channels * self.out_size ** 2, fcc,
                               self.out_size, self.modulated)
            for _ in self.featmap_strides])

    @property
    def num_inputs(self) -> int:
        return len(self.featmap_strides)

    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX extractor's: hidden layers Normal(0, 0.01), output layers
        and every bias zero."""
        for pack in self.roi_layers:
            for seq in (pack.offset_fc, pack.mask_fc):
                if seq is None:
                    continue
                fcs = [m for m in seq if isinstance(m, nn.Linear)]
                for fc in fcs[:-1]:
                    normal_(fc.weight, 0.01, gen)
                nn.init.zeros_(fcs[-1].weight)
                for fc in fcs:
                    nn.init.zeros_(fc.bias)

    def _per_level(self, branch: str, flat: torch.Tensor,
                   lvl: torch.Tensor) -> torch.Tensor:
        outs = torch.stack([getattr(p, branch)(flat)
                            for p in self.roi_layers])        # (L, R, D)
        return outs.gather(0, lvl[None, :, None].expand(
            1, -1, outs.shape[-1]))[0]

    def forward(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                roi_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats: per-level NHWC; rois (R, 5) with the batch column.
        Returns (R, out, out, C) in the features' dtype."""
        feats = [f.contiguous() for f in feats[:self.num_inputs]]
        rois = rois.float().contiguous()
        s = self.out_size
        base = roi_align_op(feats, rois, self.featmap_strides, s,
                            self.sampling_ratio, self.finest_scale,
                            roi_valid=roi_valid)
        n = rois.shape[0]
        flat = base.float().permute(0, 3, 1, 2).reshape(n, -1)
        lvl = map_roi_levels(rois, self.num_inputs, self.finest_scale)
        # mmcv's (R, 2, s, s): the first s * s are dx, the next dy
        off = self._per_level('offset_fc', flat, lvl).reshape(n, 2, s, s) \
            .permute(0, 2, 3, 1)
        out = multilevel_deform_roi_pool(
            feats, rois, off, self.featmap_strides, s, self.sampling_ratio,
            self.gamma, self.finest_scale, roi_valid=roi_valid)
        if self.modulated:
            mask = torch.sigmoid(self._per_level('mask_fc', flat, lvl))
            out = out * mask.reshape(n, s, s, 1)
        return out.to(feats[0].dtype)
