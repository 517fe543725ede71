"""Conv / FC bbox heads (counterpart of
``swindet_tpu/models/roi_heads/bbox_heads.py``: ``ConvFCBBoxHead`` :24,
``get_targets`` :97, ``loss`` :118, ``get_bboxes`` :160 (here
``decode`` and ``nms``), ``decode_for_test`` :179, ``regress_by_class``
:186, ``Shared2FCBBoxHead`` :203, ``Shared4Conv1FCBBoxHead`` :210,
``BBoxHead`` :217; reference convfc_bbox_head.py:9,177,193,
bbox_head.py:13,151,219,455).

Shared convs (``ConvModule``, with the config's conv and norm) -> with
``with_avg_pool`` the mean over the roi's H and W -> shared fcs -> cls /
reg. The first FC flattens the roi features channel-first, as
mmdet does, so an mmdet ``.pth`` loads as it is. The convs' norms follow
the module's mode: batch statistics in training (``forward_train``),
running ones in eval mode (the test paths), as the JAX heads take
``train=True`` and ``False``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..builder import build_bbox_coder, build_loss
from ..layers import (ConvModule, Linear, normal_, resolve_dtype,
                      xavier_uniform_)
from ..losses import accuracy
from ...core.nms import multiclass_nms
from ...registries import HEADS


@HEADS.register_module()
class ConvFCBBoxHead(nn.Module):
    """Shared convs and fcs -> cls / reg (no separate branches: the
    configurations of the Swin detectors). With ``reg_decoded_bbox`` the
    box loss compares decoded boxes with the gt boxes (GIoU)."""

    def __init__(self, num_shared_convs: int = 0, num_shared_fcs: int = 0,
                 roi_feat_size: int = 7, in_channels: int = 256,
                 conv_out_channels: int = 256, fc_out_channels: int = 1024,
                 num_classes: int = 80, bbox_coder: Optional[dict] = None,
                 reg_class_agnostic: bool = False,
                 reg_decoded_bbox: bool = False, loss_cls=None,
                 loss_bbox=None, with_avg_pool: bool = False,
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        self.reg_decoded_bbox = reg_decoded_bbox
        self.with_avg_pool = with_avg_pool
        self.compute_dtype = resolve_dtype(dtype)
        self.bbox_coder = build_bbox_coder(dict(
            bbox_coder or dict(type='DeltaXYWHBBoxCoder',
                               target_means=[0., 0., 0., 0.],
                               target_stds=[0.1, 0.1, 0.2, 0.2])))
        self.loss_cls = build_loss(dict(loss_cls or dict(
            type='CrossEntropyLoss', use_sigmoid=False, loss_weight=1.0)))
        self.loss_bbox = build_loss(dict(loss_bbox or dict(
            type='L1Loss', loss_weight=1.0)))
        chans = [in_channels] + [conv_out_channels] * num_shared_convs
        self.shared_convs = nn.ModuleList([
            ConvModule(chans[i], chans[i + 1], 3, padding=1,
                       conv_cfg=conv_cfg, norm_cfg=norm_cfg,
                       act_cfg=dict(type='ReLU'), dtype=dtype)
            for i in range(num_shared_convs)])
        dims = [chans[-1] * (1 if with_avg_pool else roi_feat_size ** 2)] \
            + [fc_out_channels] * num_shared_fcs
        self.shared_fcs = nn.ModuleList([
            Linear(dims[i], dims[i + 1], dtype=dtype)
            for i in range(num_shared_fcs)])
        self.fc_cls = Linear(dims[-1], num_classes + 1, dtype=dtype)
        self.fc_reg = Linear(dims[-1], 4 if reg_class_agnostic
                             else 4 * num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor):
        """x: (R, s, s, C) roi features -> (cls (R, K+1), reg (R, 4K))."""
        for conv in self.shared_convs:
            x = conv(x)
        if self.with_avg_pool:
            x = x.float().mean((1, 2)).to(x.dtype)
        else:
            x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)

    def init_weights(self, gen: torch.Generator):
        # the JAX head's: ConvModule defaults for the shared convs; the
        # reference convfc_bbox_head init for the rest: shared fcs xavier,
        # fc_cls normal(0.01), fc_reg normal(0.001)
        for conv in self.shared_convs:
            conv.init_weights(gen)
        for fc in self.shared_fcs:
            xavier_uniform_(fc.weight, fc.in_features, fc.out_features, gen)
            nn.init.zeros_(fc.bias)
        for fc, std in ((self.fc_cls, 0.01), (self.fc_reg, 0.001)):
            normal_(fc.weight, std, gen)
            nn.init.zeros_(fc.bias)

    def get_targets(self, samp, rcnn_cfg: dict):
        """Slot targets of one image's (or a stacked batch's) sampling
        result: labels (background ``num_classes`` outside positives),
        label weights (0 on filler slots), box targets (the gt boxes
        themselves with ``reg_decoded_bbox``) and weights."""
        bg = self.num_classes
        labels = torch.where(samp.is_pos, samp.pos_gt_labels.long().clamp(
            min=0), bg)
        labels = torch.where(samp.valid, labels, bg)
        pos_weight = rcnn_cfg.get('pos_weight', -1)
        pw = 1.0 if pos_weight <= 0 else float(pos_weight)
        label_weights = torch.where(samp.is_pos, pw, 1.0) * samp.valid
        if self.reg_decoded_bbox:
            bt = samp.pos_gt_bboxes
        else:
            bt = self.bbox_coder.encode(samp.bboxes, samp.pos_gt_bboxes)
        pos = samp.is_pos[..., None]
        return (labels, label_weights, torch.where(pos, bt, 0.0),
                pos.float().expand_as(bt))

    def loss(self, cls_score, bbox_pred, rois, labels, label_weights,
             bbox_targets, bbox_weights, loss_bbox_kwargs=None):
        """Losses over the flattened (B * num) slots, rois (B * num, 5);
        both averaged over the sampled slots (the count of non-zero label
        weights), as the reference averages over the sampled rois. With
        ``reg_decoded_bbox`` the predicted deltas are decoded on the rois
        first. ``loss_bbox_kwargs`` go to the box loss's call (Dynamic
        R-CNN's ``beta``)."""
        avg = (label_weights > 0).float().sum().clamp(min=1.0)
        losses = dict(
            loss_cls=self.loss_cls(cls_score, labels, weight=label_weights,
                                   avg_factor=avg),
            acc=accuracy(cls_score, labels, mask=label_weights))
        pred = bbox_pred
        if self.reg_decoded_bbox:
            pred = self.bbox_coder.decode(rois[:, 1:], bbox_pred.float())
        if not self.reg_class_agnostic:
            k = pred.shape[-1] // 4
            safe = labels.clamp(0, k - 1)
            pred = pred.reshape(-1, k, 4).gather(
                1, safe[:, None, None].expand(-1, 1, 4))[:, 0]
        losses['loss_bbox'] = self.loss_bbox(pred, bbox_targets,
                                             weight=bbox_weights,
                                             avg_factor=avg,
                                             **(loss_bbox_kwargs or {}))
        return losses

    def decode(self, rois, cls_score, bbox_pred, img_shapes):
        """Class scores (softmax, fp32) and decoded boxes clipped to
        ``img_shapes``. rois (B, P, 5), cls_score (B, P, K+1), bbox_pred
        (B, P, 4K), img_shapes (B, 2)."""
        scores = torch.softmax(cls_score.float(), dim=-1)
        return scores, self.decode_for_test(rois, bbox_pred, img_shapes)

    def decode_for_test(self, rois, bbox_pred, img_shapes):
        """Boxes (B, P, 4K) of the deltas (B, P, 4K) on rois (B, P, 5),
        clipped to ``img_shapes`` (B, 2)."""
        return self.bbox_coder.decode(rois[..., 1:], bbox_pred.float(),
                                      max_shape=img_shapes[:, None, :])

    def regress_by_class(self, rois, labels, bbox_pred, img_shapes):
        """Rois (R, 5) moved by each one's ``labels`` (R,) class deltas of
        bbox_pred (R, 4K), clipped to its image's (H, W) in ``img_shapes``
        (R, 2): the cascade's refinement (reference bbox_head.py:455)."""
        pred = bbox_pred.float()
        if not self.reg_class_agnostic:
            k = pred.shape[-1] // 4
            safe = labels.long().clamp(0, k - 1)
            pred = pred.reshape(-1, k, 4).gather(
                1, safe[:, None, None].expand(-1, 1, 4))[:, 0]
        boxes = self.bbox_coder.decode(rois[:, 1:], pred,
                                       max_shape=img_shapes)
        return torch.cat([rois[:, :1], boxes], 1)

    def nms(self, scores, boxes, scale_factors, rescale: bool, cfg: dict,
            roi_valid=None):
        """Decoded boxes back to the original image (``rescale``), the
        scores of invalid rois zeroed, then multiclass NMS. Returns a
        MulticlassNMSResult."""
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


@HEADS.register_module()
class Shared4Conv1FCBBoxHead(ConvFCBBoxHead):
    """Four shared convs and one fc (reference convfc_bbox_head.py:193),
    the cascade Swin configs' head with a SyncBN norm and GIoU."""

    def __init__(self, num_shared_convs: int = 4, num_shared_fcs: int = 1,
                 **kwargs):
        super().__init__(num_shared_convs=num_shared_convs,
                         num_shared_fcs=num_shared_fcs, **kwargs)


@HEADS.register_module()
class BBoxHead(ConvFCBBoxHead):
    """The plain head (reference bbox_head.py:13): the average pool, then
    fc_cls and fc_reg, no shared conv or fc (the C4 configs')."""

    def __init__(self, with_avg_pool: bool = True, **kwargs):
        super().__init__(num_shared_convs=0, num_shared_fcs=0,
                         with_avg_pool=with_avg_pool, **kwargs)
