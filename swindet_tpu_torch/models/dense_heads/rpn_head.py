"""RPN head (counterpart of ``swindet_tpu/models/dense_heads/rpn_head.py:22``
with the anchor handling, targets and loss of ``anchor_head.py``
(``_target_single`` :105, ``get_targets`` :164, ``loss`` :176); reference
mmdet/models/dense_heads/rpn_head.py:17).

3x3 conv + ReLU (the conv3x3 kernel with fused ReLU at 256 channels), then
1x1 cls / reg convs. Proposals: per-level top ``nms_pre`` scores, delta
decode clipped to the image, min-size mask, level-offset batched NMS into
a fixed ``max_per_img`` slots with a validity mask. Targets: the full
anchor set of each image is assigned and sampled into fixed slots, which
are scattered back onto the anchors (filler slots land in one spare row
that is dropped), so every shape is static and no count leaves the
device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..builder import (build_anchor_generator, build_assigner,
                       build_bbox_coder, build_loss, build_sampler)
from ..layers import conv_nhwc, init_conv, resolve_dtype
from ...core.anchors import anchor_inside_flags
from ...core.nms import batched_nms, fast_topk
from ...registries import HEADS


@HEADS.register_module()
class RPNHead(nn.Module):

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_classes: int = 1,
                 anchor_generator: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, loss_cls=None,
                 loss_bbox=None, train_cfg=None, dtype=torch.float32):
        super().__init__()
        ag = anchor_generator or dict(
            type='AnchorGenerator', scales=[8, 16, 32],
            ratios=[0.5, 1.0, 2.0], strides=[4, 8, 16, 32, 64])
        self.prior_generator = build_anchor_generator(dict(ag))
        self.num_base_priors = self.prior_generator.num_base_anchors[0]
        self.bbox_coder = build_bbox_coder(dict(
            bbox_coder or dict(type='DeltaXYWHBBoxCoder')))
        self.test_cfg = test_cfg
        self.train_cfg = train_cfg
        self.num_classes = num_classes
        cfg_cls = dict(loss_cls or dict(type='CrossEntropyLoss',
                                        use_sigmoid=True, loss_weight=1.0))
        if not cfg_cls.get('use_sigmoid', False):
            raise NotImplementedError('RPNHead: only the sigmoid '
                                      'classifier is ported')
        self.loss_cls = build_loss(cfg_cls)
        self.loss_bbox = build_loss(dict(loss_bbox or dict(type='L1Loss',
                                                           loss_weight=1.0)))
        if train_cfg:
            self.assigner = build_assigner(dict(train_cfg['assigner']))
            self.sampler = build_sampler(dict(train_cfg['sampler']))
        self.compute_dtype = resolve_dtype(dtype)
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, self.num_base_priors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, self.num_base_priors * 4, 1)
        self.conv_uses_kernel = (in_channels % 128 == 0
                                 and feat_channels % 128 == 0)

    def forward(self, feats):
        """Per level (B, H, W, A) scores and (B, H, W, 4A) deltas."""
        d = self.compute_dtype
        cls_scores, bbox_preds = [], []
        for x in feats:
            x = conv_nhwc(x, self.rpn_conv, True, d, self.conv_uses_kernel)
            cls_scores.append(conv_nhwc(x, self.rpn_cls, False, d, False))
            bbox_preds.append(conv_nhwc(x, self.rpn_reg, False, d, False))
        return cls_scores, bbox_preds

    def init_weights(self, gen: torch.Generator):
        # reference rpn_head.py init_weights: normal_init(std=0.01)
        for conv in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            init_conv(conv, gen, std=0.01)

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

    def _target_single(self, flat_anchors, featmap_sizes, gt_bboxes,
                       gt_valid, img_shape, pad_shape, gen, keys):
        """Targets of one image on the full anchor set: labels (0 for a
        positive, 1 background), label weights, box targets and weights,
        and the sampled positive and negative counts."""
        cfg = self.train_cfg
        valid = torch.cat(self.prior_generator.valid_flags(featmap_sizes,
                                                           pad_shape))
        inside = anchor_inside_flags(flat_anchors, valid, img_shape,
                                     cfg.get('allowed_border', -1))
        assign = self.assigner.assign(flat_anchors, gt_bboxes, gt_valid,
                                      None, bbox_valid=inside)
        samp = self.sampler.sample(assign, flat_anchors, gt_bboxes,
                                   gt_valid, None, bbox_valid=inside,
                                   gen=gen, keys=keys)
        n = flat_anchors.shape[0]
        dev = flat_anchors.device
        bg = self.num_classes
        rows = samp.inds.long().clamp(max=n)        # fillers -> spare row n
        pos, sel = samp.is_pos, samp.valid
        pos_weight = cfg.get('pos_weight', -1)
        pw = 1.0 if pos_weight <= 0 else float(pos_weight)

        def scatter(fill, values):
            out = torch.full((n + 1,) + values.shape[1:], fill,
                             dtype=values.dtype, device=dev)
            out[rows] = values
            return out[:n]

        labels = scatter(bg, torch.where(pos, 0, bg))
        label_weights = scatter(0.0, torch.where(pos, pw, 1.0) * sel)
        bt = self.bbox_coder.encode(samp.bboxes, samp.pos_gt_bboxes)
        bbox_targets = scatter(0.0, torch.where(pos[:, None], bt, 0.0))
        bbox_weights = scatter(0.0, pos[:, None].float().expand(-1, 4))
        return (labels, label_weights, bbox_targets, bbox_weights,
                samp.num_pos, samp.num_neg)

    def get_targets(self, featmap_sizes, gt_bboxes, gt_valid, img_shapes,
                    pad_shapes, gen=None, keys=None):
        """Batched targets, stacked over images. ``keys``: per image the
        sampler's (keys_pos, keys_neg), or None to draw them from
        ``gen``."""
        anchors = self.prior_generator.grid_anchors(featmap_sizes,
                                                    gt_bboxes.device)
        flat = torch.cat(anchors)
        per_image = [self._target_single(
            flat, featmap_sizes, gt_bboxes[i], gt_valid[i], img_shapes[i],
            pad_shapes[i], gen, None if keys is None else keys[i])
            for i in range(gt_bboxes.shape[0])]
        return [torch.stack(t) for t in zip(*per_image)]

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_valid, img_shapes,
             pad_shapes, gen: Optional[torch.Generator] = None,
             keys: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """RPN losses (reference anchor_head.py:426), averaged over the
        sampled anchors with the reference's per-image ``max(count, 1)``
        clamp (:185-190)."""
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        labels, label_weights, bbox_targets, bbox_weights, num_pos, \
            num_neg = self.get_targets(featmap_sizes, gt_bboxes, gt_valid,
                                       img_shapes, pad_shapes, gen, keys)
        num_total = (num_pos.clamp(min=1) + num_neg.clamp(min=1)).sum() \
            .float()
        b = gt_bboxes.shape[0]
        cls_flat = torch.cat([s.reshape(b, -1, 1) for s in cls_scores], 1)
        box_flat = torch.cat([p.reshape(b, -1, 4) for p in bbox_preds], 1)
        return dict(
            loss_rpn_cls=self.loss_cls(cls_flat, labels,
                                       weight=label_weights,
                                       avg_factor=num_total),
            loss_rpn_bbox=self.loss_bbox(box_flat, bbox_targets,
                                         weight=bbox_weights,
                                         avg_factor=num_total))
