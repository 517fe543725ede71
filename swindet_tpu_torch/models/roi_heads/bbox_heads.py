"""Shared2FC bbox head (counterpart of
``swindet_tpu/models/roi_heads/bbox_heads.py``: ``ConvFCBBoxHead`` :24,
``get_targets`` :97, ``loss`` :118, ``get_bboxes`` :160,
``Shared2FCBBoxHead`` :203; reference convfc_bbox_head.py:9,177,
bbox_head.py:151,219).

The first FC flattens the roi features channel-first, as mmdet does, so
an mmdet ``.pth`` loads as it is.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..builder import build_bbox_coder, build_loss
from ..layers import Linear, normal_, resolve_dtype, xavier_uniform_
from ..losses import accuracy
from ...core.nms import multiclass_nms
from ...registries import HEADS


@HEADS.register_module()
class ConvFCBBoxHead(nn.Module):
    """Shared fcs -> cls / reg (no convs, no separate branches: the
    configurations of this slice)."""

    def __init__(self, num_shared_convs: int = 0, num_shared_fcs: int = 0,
                 roi_feat_size: int = 7, in_channels: int = 256,
                 fc_out_channels: int = 1024, num_classes: int = 80,
                 bbox_coder: Optional[dict] = None,
                 reg_class_agnostic: bool = False, loss_cls=None,
                 loss_bbox=None, dtype=torch.float32):
        super().__init__()
        if num_shared_convs:
            raise NotImplementedError('ConvFCBBoxHead: shared convs are '
                                      'not ported yet')
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        self.compute_dtype = resolve_dtype(dtype)
        self.bbox_coder = build_bbox_coder(dict(
            bbox_coder or dict(type='DeltaXYWHBBoxCoder',
                               target_means=[0., 0., 0., 0.],
                               target_stds=[0.1, 0.1, 0.2, 0.2])))
        self.loss_cls = build_loss(dict(loss_cls or dict(
            type='CrossEntropyLoss', use_sigmoid=False, loss_weight=1.0)))
        self.loss_bbox = build_loss(dict(loss_bbox or dict(
            type='L1Loss', loss_weight=1.0)))
        dims = [in_channels * roi_feat_size ** 2] \
            + [fc_out_channels] * num_shared_fcs
        self.shared_fcs = nn.ModuleList([
            Linear(dims[i], dims[i + 1], dtype=dtype)
            for i in range(num_shared_fcs)])
        self.fc_cls = Linear(dims[-1], num_classes + 1, dtype=dtype)
        self.fc_reg = Linear(dims[-1], 4 if reg_class_agnostic
                             else 4 * num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor):
        """x: (R, s, s, C) roi features -> (cls (R, K+1), reg (R, 4K))."""
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)

    def init_weights(self, gen: torch.Generator):
        # reference convfc_bbox_head init: shared fcs xavier, fc_cls
        # normal(0.01), fc_reg normal(0.001)
        for fc in self.shared_fcs:
            xavier_uniform_(fc.weight, fc.in_features, fc.out_features, gen)
            nn.init.zeros_(fc.bias)
        for fc, std in ((self.fc_cls, 0.01), (self.fc_reg, 0.001)):
            normal_(fc.weight, std, gen)
            nn.init.zeros_(fc.bias)

    def get_targets(self, samp, rcnn_cfg: dict):
        """Slot targets of one image's (or a stacked batch's) sampling
        result: labels (background ``num_classes`` outside positives),
        label weights (0 on filler slots), box targets and weights."""
        bg = self.num_classes
        labels = torch.where(samp.is_pos, samp.pos_gt_labels.long().clamp(
            min=0), bg)
        labels = torch.where(samp.valid, labels, bg)
        pos_weight = rcnn_cfg.get('pos_weight', -1)
        pw = 1.0 if pos_weight <= 0 else float(pos_weight)
        label_weights = torch.where(samp.is_pos, pw, 1.0) * samp.valid
        bt = self.bbox_coder.encode(samp.bboxes, samp.pos_gt_bboxes)
        pos = samp.is_pos[..., None]
        return (labels, label_weights, torch.where(pos, bt, 0.0),
                pos.float().expand_as(bt))

    def loss(self, cls_score, bbox_pred, labels, label_weights,
             bbox_targets, bbox_weights):
        """Losses over the flattened (B * num) slots; both averaged over
        the sampled slots (the count of non-zero label weights), as the
        reference averages over the sampled rois."""
        avg = (label_weights > 0).float().sum().clamp(min=1.0)
        losses = dict(
            loss_cls=self.loss_cls(cls_score, labels, weight=label_weights,
                                   avg_factor=avg),
            acc=accuracy(cls_score, labels, mask=label_weights))
        pred = bbox_pred
        if not self.reg_class_agnostic:
            k = pred.shape[-1] // 4
            safe = labels.clamp(0, k - 1)
            pred = pred.reshape(-1, k, 4).gather(
                1, safe[:, None, None].expand(-1, 1, 4))[:, 0]
        losses['loss_bbox'] = self.loss_bbox(pred, bbox_targets,
                                             weight=bbox_weights,
                                             avg_factor=avg)
        return losses

    def get_bboxes(self, rois, cls_score, bbox_pred, img_shapes,
                   scale_factors, rescale: bool, cfg: dict, roi_valid=None):
        """Batched decode + multiclass NMS. rois (B, P, 5), cls_score
        (B, P, K+1), bbox_pred (B, P, 4K), img_shapes (B, 2),
        scale_factors (B, 4). Returns a MulticlassNMSResult."""
        scores = torch.softmax(cls_score.float(), dim=-1)
        boxes = self.bbox_coder.decode(rois[..., 1:], bbox_pred.float(),
                                       max_shape=img_shapes[:, None, :])
        if rescale:
            b, p = boxes.shape[:2]
            boxes = (boxes.reshape(b, p, -1, 4)
                     / scale_factors[:, None, None, :4]).reshape(b, p, -1)
        if roi_valid is not None:
            scores = torch.where(roi_valid[..., None], scores, 0.0)
        return multiclass_nms(boxes, scores, cfg['score_thr'],
                              dict(cfg['nms']), cfg['max_per_img'])


@HEADS.register_module()
class Shared2FCBBoxHead(ConvFCBBoxHead):
    """Two shared fcs (reference convfc_bbox_head.py:177)."""

    def __init__(self, num_shared_fcs: int = 2, **kwargs):
        super().__init__(num_shared_fcs=num_shared_fcs, **kwargs)
