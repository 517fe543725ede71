"""Anchor-based dense head (counterpart of
``swindet_tpu/models/dense_heads/anchor_head.py:27``: ``_target_single``
:105, ``get_targets`` :164, ``loss`` :176, ``sampling`` :227,
``get_bboxes`` :233; reference mmdet/models/dense_heads/anchor_head.py:15).

Targets are computed on the full anchor set of each image: the anchors are
assigned, then sampled into fixed slots (a ``RandomSampler``) or kept in
place (a ``PseudoSampler``), and the slots are scattered back onto the
anchors (filler slots land in one spare row that is dropped), so every
shape is static and no count leaves the device. Boxes: per level the top
``nms_pre`` anchors by their best class score, decoded and clipped to the
image, then the port's multiclass NMS.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..builder import (build_anchor_generator, build_assigner,
                       build_bbox_coder, build_loss, build_sampler)
from ..layers import conv_nhwc, init_conv, resolve_dtype
from ...core.anchors import anchor_inside_flags
from ...core.nms import fast_topk, multiclass_nms
from ...registries import HEADS

# classification losses whose average runs over the positives alone
# (anchor_head.py:227-231): every other loss averages over the sampled set
_UNSAMPLED_LOSSES = ('FocalLoss', 'GHMC', 'QualityFocalLoss')


@HEADS.register_module()
class AnchorHead(nn.Module):
    """A 1x1 class conv and a 1x1 box conv on every level by default;
    subclasses replace ``_init_layers`` and ``forward_single``."""

    IS_RPN = False

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256,
                 anchor_generator: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 reg_decoded_bbox: bool = False,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, dtype=torch.float32):
        super().__init__()
        if reg_decoded_bbox:
            raise NotImplementedError('AnchorHead: reg_decoded_bbox (IoU '
                                      'losses on decoded boxes) is not '
                                      'ported yet')
        ag = anchor_generator or dict(
            type='AnchorGenerator', scales=[8, 16, 32],
            ratios=[0.5, 1.0, 2.0], strides=[4, 8, 16, 32, 64])
        self.prior_generator = build_anchor_generator(dict(ag))
        self.num_base_priors = self.prior_generator.num_base_anchors[0]
        self.bbox_coder = build_bbox_coder(dict(
            bbox_coder or dict(type='DeltaXYWHBBoxCoder')))
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.feat_channels = feat_channels
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        cfg_cls = dict(loss_cls or dict(type='CrossEntropyLoss',
                                        use_sigmoid=True, loss_weight=1.0))
        self.use_sigmoid_cls = cfg_cls.get('use_sigmoid', False)
        self.cls_out_channels = num_classes if self.use_sigmoid_cls \
            else num_classes + 1
        self.sampling = cfg_cls.get('type') not in _UNSAMPLED_LOSSES
        self.loss_cls = build_loss(cfg_cls)
        self.loss_bbox = build_loss(dict(loss_bbox or dict(type='L1Loss',
                                                           loss_weight=1.0)))
        if train_cfg:
            self.assigner = build_assigner(dict(train_cfg['assigner']))
            self.sampler = build_sampler(dict(train_cfg.get(
                'sampler', dict(type='PseudoSampler'))))
        self.compute_dtype = resolve_dtype(dtype)
        self._init_layers()

    def _init_layers(self):
        a = self.num_base_priors
        self.conv_cls = nn.Conv2d(self.in_channels,
                                  a * self.cls_out_channels, 1)
        self.conv_reg = nn.Conv2d(self.in_channels, a * 4, 1)

    def init_weights(self, gen: torch.Generator):
        # reference anchor_head.py init_weights: normal_init(std=0.01)
        for conv in (self.conv_cls, self.conv_reg):
            init_conv(conv, gen, std=0.01)

    def forward_single(self, x):
        d = self.compute_dtype
        return (conv_nhwc(x, self.conv_cls, False, d, False),
                conv_nhwc(x, self.conv_reg, False, d, False))

    def forward(self, feats):
        """Per level (B, H, W, A * classes) scores and (B, H, W, 4A)
        deltas."""
        outs = [self.forward_single(x) for x in feats]
        return [o[0] for o in outs], [o[1] for o in outs]

    # ------------------------------------------------------------ targets
    def _target_single(self, flat_anchors, featmap_sizes, gt_bboxes,
                       gt_valid, gt_labels, img_shape, pad_shape, gen, keys):
        """Targets of one image on the full anchor set: labels (the gt's
        class for a positive, 0 for the RPN's, ``num_classes`` the
        background), label weights (``pos_weight`` on positives), box
        targets and weights, and the positive and negative counts."""
        cfg = self.train_cfg
        valid = torch.cat(self.prior_generator.valid_flags(featmap_sizes,
                                                           pad_shape))
        inside = anchor_inside_flags(flat_anchors, valid, img_shape,
                                     cfg.get('allowed_border', -1))
        labels_in = None if self.IS_RPN else gt_labels
        assign = self.assigner.assign(flat_anchors, gt_bboxes, gt_valid,
                                      labels_in, bbox_valid=inside)
        samp = self.sampler.sample(assign, flat_anchors, gt_bboxes,
                                   gt_valid, labels_in, bbox_valid=inside,
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

        pos_labels = 0 if self.IS_RPN else samp.pos_gt_labels.long() \
            .clamp(min=0)
        labels = scatter(bg, torch.where(pos, pos_labels, bg))
        label_weights = scatter(0.0, torch.where(pos, pw, 1.0) * sel)
        bt = self.bbox_coder.encode(samp.bboxes, samp.pos_gt_bboxes)
        bbox_targets = scatter(0.0, torch.where(pos[:, None], bt, 0.0))
        bbox_weights = scatter(0.0, pos[:, None].float().expand(-1, 4))
        return (labels, label_weights, bbox_targets, bbox_weights,
                samp.num_pos, samp.num_neg)

    def get_targets(self, featmap_sizes, gt_bboxes, gt_valid, gt_labels,
                    img_shapes, pad_shapes, gen=None, keys=None):
        """Batched targets, stacked over images. ``keys``: per image the
        sampler's (keys_pos, keys_neg), or None to draw them from
        ``gen``."""
        anchors = self.prior_generator.grid_anchors(featmap_sizes,
                                                    gt_bboxes.device)
        flat = torch.cat(anchors)
        per_image = [self._target_single(
            flat, featmap_sizes, gt_bboxes[i], gt_valid[i],
            None if gt_labels is None else gt_labels[i], img_shapes[i],
            pad_shapes[i], gen, None if keys is None else keys[i])
            for i in range(gt_bboxes.shape[0])]
        return [torch.stack(t) for t in zip(*per_image)]

    # --------------------------------------------------------------- loss
    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_valid, gt_labels,
             img_shapes, pad_shapes, gen: Optional[torch.Generator] = None,
             keys: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """loss_cls and loss_bbox, averaged over the sampled anchors with
        the reference's per-image ``max(count, 1)`` clamp, or over the
        positives for a focal loss (``sampling`` False)."""
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        labels, label_weights, bbox_targets, bbox_weights, num_pos, \
            num_neg = AnchorHead.get_targets(  # the RPN's drops gt_labels
                self, featmap_sizes, gt_bboxes, gt_valid, gt_labels,
                img_shapes, pad_shapes, gen, keys)
        if self.sampling:
            num_total = (num_pos.clamp(min=1) + num_neg.clamp(min=1)).sum() \
                .float()
        else:
            num_total = num_pos.sum().float().clamp(min=1.0)
        b = gt_bboxes.shape[0]
        cls_flat = torch.cat([s.reshape(b, -1, self.cls_out_channels)
                              for s in cls_scores], 1)
        box_flat = torch.cat([p.reshape(b, -1, 4) for p in bbox_preds], 1)
        return dict(
            loss_cls=self.loss_cls(cls_flat, labels, weight=label_weights,
                                   avg_factor=num_total),
            loss_bbox=self.loss_bbox(box_flat, bbox_targets,
                                     weight=bbox_weights,
                                     avg_factor=num_total))

    # -------------------------------------------------------------- boxes
    def get_bboxes(self, cls_scores, bbox_preds, img_shapes, scale_factors,
                   cfg=None, rescale: bool = False, with_nms: bool = True):
        """Per level the top ``nms_pre`` anchors by their best class score
        (sigmoid, or softmax without the background), their boxes decoded
        and clipped to the image, divided by the scale factor with
        ``rescale``; then the port's multiclass NMS (a
        ``MulticlassNMSResult``), or with ``with_nms=False`` the
        candidates (boxes (B, P, 4), scores (B, P, classes + 1), a zero
        background column for a sigmoid head)."""
        cfg = dict(cfg or self.test_cfg)
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_generator.grid_anchors(featmap_sizes,
                                                    cls_scores[0].device)
        nms_pre = cfg.get('nms_pre', -1)
        b = cls_scores[0].shape[0]
        max_shape = img_shapes[:, None, :]
        mlvl_boxes, mlvl_scores = [], []
        for lvl, (score, pred) in enumerate(zip(cls_scores, bbox_preds)):
            s = score.reshape(b, -1, self.cls_out_channels).float()
            s = torch.sigmoid(s) if self.use_sigmoid_cls \
                else torch.softmax(s, -1)
            p = pred.reshape(b, -1, 4).float()
            a = anchors[lvl][None].expand(b, -1, -1)
            if 0 < nms_pre < s.shape[1]:
                best = s if self.use_sigmoid_cls else s[..., :-1]
                _, top = fast_topk(best.amax(-1), nms_pre)
                s = torch.gather(s, 1, top[..., None].expand(
                    -1, -1, s.shape[-1]))
                p = torch.gather(p, 1, top[..., None].expand(-1, -1, 4))
                a = anchors[lvl][top]
            mlvl_boxes.append(self.bbox_coder.decode(a, p,
                                                     max_shape=max_shape))
            mlvl_scores.append(s)
        boxes = torch.cat(mlvl_boxes, 1)
        scores = torch.cat(mlvl_scores, 1)
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, :4]
        if self.use_sigmoid_cls:
            scores = torch.cat([scores, torch.zeros_like(scores[..., :1])],
                               -1)
        if not with_nms:
            return boxes, scores
        return multiclass_nms(boxes, scores, cfg['score_thr'],
                              dict(cfg['nms']), cfg.get('max_per_img', 100))
