"""Mask Scoring R-CNN (counterpart of
``swindet_tpu/models/roi_heads/mask_scoring_roi_head.py``: ``MaskIoUHead``
:24 with ``area_ratio`` :65, ``get_targets`` :90 and ``loss`` :104,
``MaskScoringRoIHead`` :113; reference mmdet/models/roi_heads/
mask_scoring_roi_head.py:9, mask_heads/maskiou_head.py:12,
arXiv:1903.00241).

A MaskIoU head predicts, per class, the IoU of each roi's predicted mask
with its gt instance: the sigmoid of the own-class mask, max-pooled 2x2 to
the roi grid, joins the mask features as a 257th channel, then 4 convs
(the last at stride 2), 2 fcs and ``fc_mask_iou``. Its convs are plain
``F.conv2d`` (``nn.Conv`` in the JAX package: no Pallas kernel), its
first fc reads them flattened channel-first, as mmdet's. The gt area
inside each positive box comes from per-gt summed-area tables with
``BitmapMasks.crop``'s truncated, exclusive x2 / y2.

Serving recomputes the mask branch on the detections and writes
``mask_scores`` = score x relu(own-class iou), where the head is given
the log of the clamped mask probability, as the JAX package does (mmdet
gives it the logits); nothing downstream reads ``mask_scores``: the segm
results keep the box score, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..builder import build_head, build_loss
from ..layers import (Linear, conv_nhwc, init_conv, lecun_normal_,
                      resolve_dtype)
from ...registries import HEADS
from .standard_roi_head import StandardRoIHead, boxes_to_rois


@HEADS.register_module()
class MaskIoUHead(nn.Module):

    def __init__(self, num_convs: int = 4, num_fcs: int = 2,
                 roi_feat_size: int = 14, in_channels: int = 256,
                 conv_out_channels: int = 256, fc_out_channels: int = 1024,
                 num_classes: int = 80, loss_iou: Optional[dict] = None,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = resolve_dtype(dtype)
        self.loss_iou = build_loss(dict(loss_iou or dict(
            type='MSELoss', loss_weight=0.5)))
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels + 1 if i == 0 else conv_out_channels,
                      conv_out_channels, 3,
                      stride=2 if i == num_convs - 1 else 1, padding=1)
            for i in range(num_convs)])
        pooled = (roi_feat_size // 2) ** 2
        self.fcs = nn.ModuleList([
            Linear(conv_out_channels * pooled if i == 0 else fc_out_channels,
                   fc_out_channels, dtype=dtype)
            for i in range(num_fcs)])
        self.fc_mask_iou = Linear(fc_out_channels, num_classes, dtype=dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        """flax defaults of the JAX head: lecun-normal convs and fcs, zero
        biases."""
        for conv in self.convs:
            init_conv(conv, gen)
        for fc in (*self.fcs, self.fc_mask_iou):
            lecun_normal_(fc.weight, fc.in_features, gen)
            nn.init.zeros_(fc.bias)

    def forward(self, mask_feat: torch.Tensor,
                mask_pred: torch.Tensor) -> torch.Tensor:
        """mask_feat (M, s, s, C), mask_pred (M, 2s, 2s) own-class logits ->
        per-class iou predictions (M, num_classes)."""
        d = self.compute_dtype
        m, h, w = mask_pred.shape
        p = torch.sigmoid(mask_pred.float()).reshape(m, h // 2, 2, w // 2, 2)
        p = p.amax((2, 4))[..., None]
        x = torch.cat([mask_feat, p.to(mask_feat.dtype)], -1)
        for conv in self.convs:
            x = conv_nhwc(x, conv, True, d, False)
        x = x.permute(0, 3, 1, 2).reshape(m, -1)
        for fc in self.fcs:
            x = torch.relu(fc(x))
        return self.fc_mask_iou(x)

    @staticmethod
    def area_ratio(gt_masks: torch.Tensor, pos_boxes: torch.Tensor,
                   pos_gt_inds: torch.Tensor) -> torch.Tensor:
        """One image's ratio (M,) of each positive's gt area inside its box
        to the gt's whole area, from summed-area tables of gt_masks (G, H,
        W); the box truncated to integers, x2 / y2 exclusive and at least
        one pixel past x1 / y1, as ``BitmapMasks.crop``."""
        _, hh, ww = gt_masks.shape
        m = gt_masks.float()
        sat = nn.functional.pad(m.cumsum(1).cumsum(2), (1, 0, 1, 0))
        full = m.sum((1, 2))
        box = pos_boxes.to(torch.int32)
        x1 = box[:, 0].clamp(0, ww)
        y1 = box[:, 1].clamp(0, hh)
        x2 = torch.maximum(box[:, 2], x1 + 1).clamp(0, ww)
        y2 = torch.maximum(box[:, 3], y1 + 1).clamp(0, hh)
        g = pos_gt_inds.long()
        inside = sat[g, y2, x2] - sat[g, y1, x2] - sat[g, y2, x1] \
            + sat[g, y1, x1]
        return inside / (full[g] + 1e-7)

    @staticmethod
    def get_targets(area_ratios: torch.Tensor, mask_pred: torch.Tensor,
                    mask_targets: torch.Tensor,
                    mask_thr_binary: float = 0.5) -> torch.Tensor:
        """IoU (M,) of each binarised prediction with its whole gt, the
        gt's full area recovered through its area ratio. The raw logits
        are binarised at ``mask_thr_binary``, with no sigmoid, as the
        reference does."""
        pred = (mask_pred.float() > mask_thr_binary).float()
        overlap = (pred * mask_targets).sum((-1, -2))
        gt_full = mask_targets.sum((-1, -2)) / (area_ratios + 1e-7)
        return overlap / (pred.sum((-1, -2)) + gt_full - overlap).clamp(
            min=1e-7)

    def loss(self, pos_iou_pred: torch.Tensor, iou_targets: torch.Tensor,
             pos_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """MSE over the positives with a target above 0."""
        valid = ((iou_targets > 0) & (pos_mask > 0)).float()
        return dict(loss_mask_iou=self.loss_iou(
            pos_iou_pred, iou_targets, weight=valid,
            avg_factor=valid.sum().clamp(min=1.0)))


@HEADS.register_module()
class MaskScoringRoIHead(StandardRoIHead):
    """StandardRoIHead with a MaskIoU head on its mask branch."""

    def __init__(self, mask_iou_head: dict, **kwargs):
        super().__init__(**kwargs)
        self.mask_iou_head = build_head(dict(
            mask_iou_head, dtype=kwargs.get('dtype', torch.float32)))

    def init_weights(self, gen: torch.Generator):
        super().init_weights(gen)
        self.mask_iou_head.init_weights(gen)

    def _own(self, labels: torch.Tensor) -> torch.Tensor:
        return labels.long().clamp(0, self.mask_iou_head.num_classes - 1)

    def forward_train(self, feats, proposals, proposal_valid, gt_bboxes,
                      gt_valid, gt_labels, gt_masks, gen=None, keys=None,
                      img_shapes=None) -> Dict[str, torch.Tensor]:
        """StandardRoIHead's losses and ``loss_mask_iou``: the MaskIoU head
        on the mask branch's features and own-class logits (the gradient
        flows into the mask head through them), its targets from the
        binarised logits, the mask targets and each positive's area
        ratio."""
        losses, aux = self._forward_train(
            feats, proposals, proposal_valid, gt_bboxes, gt_valid, gt_labels,
            gt_masks, gen, keys, return_mask_aux=True)
        if aux is None:
            return losses
        own = self._own(aux.pos_labels.reshape(-1))
        pred = aux.pred
        own_pred = pred.gather(3, own[:, None, None, None].expand(
            -1, *pred.shape[1:3], 1))[..., 0]
        iou_pred = self.mask_iou_head(aux.feats, own_pred)
        pos_iou_pred = iou_pred.float().gather(1, own[:, None])[:, 0]
        ratios = torch.cat([
            self.mask_iou_head.area_ratio(gt_masks[i], aux.pos_boxes[i],
                                          aux.pos_inds[i])
            for i in range(aux.pos_boxes.shape[0])])
        iou_targets = self.mask_iou_head.get_targets(
            ratios, own_pred, aux.targets.reshape(own_pred.shape),
            dict(self.train_cfg).get('mask_thr_binary', 0.5))
        losses.update(self.mask_iou_head.loss(
            pos_iou_pred, iou_targets, aux.pos_mask.reshape(-1).float()))
        return losses

    def simple_test(self, feats, proposals, proposal_valid, img_shapes,
                    scale_factors, rescale: bool = True):
        """StandardRoIHead's outputs and ``mask_scores`` (B, max): each
        detection's score times the relu of its own-class iou, the mask
        branch run again on the detections (at input scale) as the JAX
        package runs it."""
        out = super().simple_test(feats, proposals, proposal_valid,
                                  img_shapes, scale_factors, rescale=rescale)
        if 'mask_probs' not in out:
            return out
        b, m = out['labels'].shape
        det_boxes = out['dets'][..., :4]
        if rescale:
            det_boxes = det_boxes * scale_factors[:, None, :4]
        mask_feats = self.mask_roi_extractor(feats, boxes_to_rois(det_boxes))
        labels = out['labels'].reshape(-1)
        probs = self.mask_head.get_mask_probs(self.mask_head(mask_feats),
                                              labels)
        iou_pred = self.mask_iou_head(
            mask_feats, torch.log(probs.clamp(1e-7, 1 - 1e-7)))
        iou_own = torch.relu(iou_pred.float()).gather(
            1, self._own(labels)[:, None])[:, 0]
        out['mask_scores'] = (out['dets'][..., 4].reshape(-1)
                              * iou_own).reshape(b, m)
        return out
