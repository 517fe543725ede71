"""LD head (counterpart of ``swindet_tpu/models/dense_heads/ld_head.py:17``;
reference mmdet/models/dense_heads/ld_head.py:11, arXiv:2102.12252).

Localization distillation on GFL: the teacher's box-side bin logits are
soft targets for a temperature-scaled KL term on the student's bins at
its positive anchors, each side weighted by the anchor's detached best
class score and the sum divided by four times their sum.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..builder import build_loss
from ...registries import HEADS
from .gfl_head import GFLHead


@HEADS.register_module()
class LDHead(GFLHead):

    def __init__(self, num_classes: int, in_channels: int,
                 loss_ld: Optional[dict] = None, **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.loss_ld = build_loss(dict(loss_ld or dict(
            type='KnowledgeDistillationKLDivLoss', loss_weight=0.25, T=10)))

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_valid, gt_labels,
             img_shapes, pad_shapes, soft_targets=None
             ) -> Dict[str, torch.Tensor]:
        """GFL's three losses and, given the teacher's per-level bin logits
        ``soft_targets``, loss_ld."""
        losses, weight_t = self.gfl_loss(
            cls_scores, bbox_preds, gt_bboxes, gt_valid, gt_labels,
            img_shapes, pad_shapes)
        if soft_targets is None:
            return losses
        b, n_bins = gt_bboxes.shape[0], self.reg_max + 1
        box_flat = torch.cat([p.reshape(b, -1, 4 * n_bins)
                              for p in bbox_preds], 1)
        soft_flat = torch.cat([p.reshape(b, -1, 4 * n_bins)
                               for p in soft_targets], 1)
        losses['loss_ld'] = self.loss_ld(
            box_flat.reshape(-1, n_bins), soft_flat.reshape(-1, n_bins),
            weight=weight_t[..., None].expand(-1, -1, 4).reshape(-1),
            avg_factor=4.0 * weight_t.sum().clamp(min=1e-6))
        return losses
