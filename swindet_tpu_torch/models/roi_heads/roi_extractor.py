"""SingleRoIExtractor (counterpart of
``swindet_tpu/models/roi_heads/roi_extractor.py:24``; reference
mmdet/models/roi_heads/roi_extractors/single_level_roi_extractor.py:9):
FPN level routing and RoIAlign through the RoIAlign kernels (forward, and
backward into the features in training)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...ops.roi_align import roi_align_op
from ...registries import ROI_EXTRACTORS


@ROI_EXTRACTORS.register_module()
class SingleRoIExtractor:

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
