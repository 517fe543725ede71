"""RPN head (counterpart of ``swindet_tpu/models/dense_heads/rpn_head.py:22``,
an ``AnchorHead`` with one class; reference
mmdet/models/dense_heads/rpn_head.py:17).

3x3 conv + ReLU (the conv3x3 kernel with fused ReLU at 256 channels), then
1x1 cls / reg convs. Proposals: per-level top ``nms_pre`` scores, delta
decode clipped to the image, min-size mask, level-offset batched NMS into
a fixed ``max_per_img`` slots with a validity mask. Targets and losses are
``AnchorHead``'s, class-agnostic.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..layers import conv_nhwc, init_conv
from ...core.nms import batched_nms, fast_topk
from ...registries import HEADS
from .anchor_head import AnchorHead


@HEADS.register_module()
class RPNHead(AnchorHead):

    IS_RPN = True

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_classes: int = 1, **kwargs):
        if not dict(kwargs.get('loss_cls') or dict(
                use_sigmoid=True)).get('use_sigmoid', False):
            raise NotImplementedError('RPNHead: only the sigmoid '
                                      'classifier is ported')
        super().__init__(num_classes=num_classes, in_channels=in_channels,
                         feat_channels=feat_channels, **kwargs)

    def _init_layers(self):
        a = self.num_base_priors
        self.rpn_conv = nn.Conv2d(self.in_channels, self.feat_channels, 3,
                                  padding=1)
        self.rpn_cls = nn.Conv2d(self.feat_channels,
                                 a * self.cls_out_channels, 1)
        self.rpn_reg = nn.Conv2d(self.feat_channels, a * 4, 1)
        self.conv_uses_kernel = (self.in_channels % 128 == 0
                                 and self.feat_channels % 128 == 0)

    def init_weights(self, gen: torch.Generator):
        # reference rpn_head.py init_weights: normal_init(std=0.01)
        for conv in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            init_conv(conv, gen, std=0.01)

    def forward_single(self, x):
        d = self.compute_dtype
        x = conv_nhwc(x, self.rpn_conv, True, d, self.conv_uses_kernel)
        return (conv_nhwc(x, self.rpn_cls, False, d, False),
                conv_nhwc(x, self.rpn_reg, False, d, False))

    def get_proposals(self, cls_scores, bbox_preds, img_shapes, cfg):
        """Returns (proposals (B, max_per_img, 4), scores (B, max_per_img),
        valid (B, max_per_img)). img_shapes (B, 2) is (H, W) per image."""
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_generator.grid_anchors(
            featmap_sizes, cls_scores[0].device)
        nms_pre = cfg.get('nms_pre', 1000)
        max_per_img = cfg.get('max_per_img', 1000)
        min_bbox_size = cfg.get('min_bbox_size', 0)
        b = cls_scores[0].shape[0]
        max_shape = img_shapes[:, None, :]
        boxes, scores, ids, valid = [], [], [], []
        for lvl, (score, pred) in enumerate(zip(cls_scores, bbox_preds)):
            score = torch.sigmoid(score.reshape(b, -1).float())
            pred = pred.reshape(b, -1, 4).float()
            k = min(nms_pre, score.shape[1])
            top_s, top_i = fast_topk(score, k)
            top_p = torch.gather(pred, 1, top_i[..., None].expand(-1, -1, 4))
            top_a = anchors[lvl][top_i]
            box = self.bbox_coder.decode(top_a, top_p, max_shape=max_shape)
            ok = torch.ones_like(top_s, dtype=torch.bool)
            if min_bbox_size >= 0:
                w = box[..., 2] - box[..., 0]
                h = box[..., 3] - box[..., 1]
                ok = ok & (w > min_bbox_size) & (h > min_bbox_size)
            boxes.append(box)
            scores.append(top_s)
            ids.append(torch.full_like(top_i, lvl))
            valid.append(ok)
        res = batched_nms(torch.cat(boxes, 1), torch.cat(scores, 1),
                          torch.cat(ids, 1), cfg['nms']['iou_threshold'],
                          max_per_img, valid=torch.cat(valid, 1))
        return res.dets[..., :4], res.dets[..., 4], res.valid

    def get_targets(self, featmap_sizes, gt_bboxes, gt_valid, img_shapes,
                    pad_shapes, gen=None, keys=None):
        """``AnchorHead.get_targets`` without labels: 0 marks a positive,
        1 the background."""
        return super().get_targets(featmap_sizes, gt_bboxes, gt_valid, None,
                                   img_shapes, pad_shapes, gen, keys)

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_valid, img_shapes,
             pad_shapes, gen: Optional[torch.Generator] = None,
             keys: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """loss_rpn_cls and loss_rpn_bbox (``AnchorHead.loss`` without
        labels)."""
        losses = super().loss(cls_scores, bbox_preds, gt_bboxes, gt_valid,
                              None, img_shapes, pad_shapes, gen, keys)
        return dict(loss_rpn_cls=losses['loss_cls'],
                    loss_rpn_bbox=losses['loss_bbox'])
