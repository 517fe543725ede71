"""ATSS head (counterpart of
``swindet_tpu/models/dense_heads/atss_head.py:25``: ``_init_layers`` :35,
``forward_single`` :65, ``_atss_target_single`` :87,
``centerness_target`` :116, ``loss`` :133, ``get_bboxes`` :182; reference
mmdet/models/dense_heads/atss_head.py:16, arXiv:1912.02424).

An anchor head with FCOS's towers: NHWC per level, two towers of
``stacked_convs`` 3x3 ConvModules with a norm (GN in groups of 32 unless
``norm_cfg`` says otherwise) and ReLU, then plain 3x3 ``atss_cls``,
``atss_reg`` and ``atss_centerness`` convs and a learnable scale a level on
the box deltas (mmcv's ``Scale``, ``scales.{i}.scale``). The targets come
from ``ATSSAssigner`` on the full anchor set of each image, every
non-ignored inside anchor taking part (PseudoSampler semantics); the box
loss runs on decoded boxes, weighted by the centerness target and divided
by its sum.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..builder import build_loss
from ..layers import ConvModule, conv_nhwc, init_conv
from ...core.anchors import anchor_inside_flags
from ...core.nms import fast_topk, multiclass_nms
from ...registries import HEADS
from .anchor_head import AnchorHead
from .fcos_head import Scale


def conv_towers(in_channels: int, feat_channels: int, stacked_convs: int,
                norm_cfg: dict, dtype):
    """Two towers (classes, boxes) of ``stacked_convs`` 3x3 ConvModules
    with ``norm_cfg`` and ReLU."""
    def tower():
        return nn.ModuleList([ConvModule(
            in_channels if i == 0 else feat_channels, feat_channels, 3,
            padding=1, norm_cfg=norm_cfg, act_cfg=dict(type='ReLU'),
            dtype=dtype) for i in range(stacked_convs)])
    return tower(), tower()


def atss_assign(assigner, prior_generator, flat_anchors, num_level_anchors,
                featmap_sizes, gt_bboxes, gt_valid, gt_labels, img_shape,
                pad_shape, allowed_border, num_classes):
    """ATSS on one image's anchors (N, 4) inside its image (the inside
    flags of ``prior_generator``'s valid flags on ``pad_shape``): labels
    (N,) (``num_classes`` the background), positives (N,), the assigned
    gt's box (N, 4) (gt 0's where not positive) and ``gt_inds``."""
    valid = torch.cat(prior_generator.valid_flags(featmap_sizes, pad_shape))
    inside = anchor_inside_flags(flat_anchors, valid, img_shape,
                                 allowed_border)
    assign = assigner.assign(flat_anchors, num_level_anchors, gt_bboxes,
                             gt_valid, gt_labels, bbox_valid=inside)
    pos = assign.gt_inds > 0
    labels = torch.where(pos, assign.labels.long().clamp(min=0),
                         num_classes)
    gt_idx = (assign.gt_inds.long() - 1).clamp(0, gt_bboxes.shape[0] - 1)
    return labels, pos, gt_bboxes[gt_idx], assign.gt_inds


@HEADS.register_module()
class ATSSHead(AnchorHead):

    def __init__(self, num_classes: int, in_channels: int,
                 stacked_convs: int = 4, conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 loss_centerness: Optional[dict] = None, **kwargs):
        # conv_cfg is taken and unused, as in the JAX package
        self.stacked_convs = stacked_convs
        self.norm_cfg = dict(norm_cfg or dict(type='GN', num_groups=32))
        super().__init__(num_classes=num_classes, in_channels=in_channels,
                         **kwargs)
        self.loss_centerness = build_loss(dict(loss_centerness or dict(
            type='CrossEntropyLoss', use_sigmoid=True, loss_weight=1.0)))

    def _init_layers(self):
        self.cls_convs, self.reg_convs = conv_towers(
            self.in_channels, self.feat_channels, self.stacked_convs,
            self.norm_cfg, self.compute_dtype)
        a = self.num_base_priors
        self.atss_cls = nn.Conv2d(self.feat_channels,
                                  a * self.cls_out_channels, 3, padding=1)
        self.atss_reg = nn.Conv2d(self.feat_channels, a * 4, 3, padding=1)
        self.atss_centerness = nn.Conv2d(self.feat_channels, a, 3, padding=1)
        self.scales = nn.ModuleList(
            [Scale(1.0) for _ in self.prior_generator.strides])

    def _outputs(self):
        return self.atss_cls, self.atss_reg, self.atss_centerness

    def init_weights(self, gen: torch.Generator):
        """The JAX package's schemes: the towers' as built, Normal(0, 0.01)
        on the outputs, the class bias at the 0.01 prior, every scale 1."""
        for m in (*self.cls_convs, *self.reg_convs):
            m.init_weights(gen)
        cls_conv, *others = self._outputs()
        for conv in (cls_conv, *others):
            init_conv(conv, gen, std=0.01)
        with torch.no_grad():
            cls_conv.bias.fill_(-math.log((1 - 0.01) / 0.01))
            for s in self.scales:
                s.scale.fill_(1.0)

    def _tower_feats(self, x):
        cls_feat = reg_feat = x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        return cls_feat, reg_feat

    def forward_single(self, x: torch.Tensor, lvl: int):
        """One level: class logits (B, H, W, A * C), scaled box deltas
        (B, H, W, 4A) in fp32 (no exp) and centerness logits (B, H, W,
        A)."""
        d = self.compute_dtype
        cls_feat, reg_feat = self._tower_feats(x)
        return (conv_nhwc(cls_feat, self.atss_cls, False, d, False),
                self.scales[lvl](conv_nhwc(reg_feat, self.atss_reg, False, d,
                                           False).float()),
                conv_nhwc(reg_feat, self.atss_centerness, False, d, False))

    def forward(self, feats):
        outs = [self.forward_single(x, i) for i, x in enumerate(feats)]
        return tuple([o[k] for o in outs] for k in range(len(outs[0])))

    # ------------------------------------------------------------ targets
    def atss_targets(self, featmap_sizes, gt_bboxes, gt_valid, gt_labels,
                     img_shapes, pad_shapes):
        """The anchors (N, 4) of every level, concatenated, and per image
        stacked: labels (B, N), label weights (``pos_weight`` on
        positives, 1 on negatives, 0 on ignored and outside anchors), the
        positive mask and the assigned gts' boxes (B, N, 4), 0 where not
        positive."""
        anchors = self.prior_generator.grid_anchors(featmap_sizes,
                                                    gt_bboxes.device)
        flat = torch.cat(anchors)
        num_level = [len(a) for a in anchors]
        cfg = self.train_cfg
        pos_weight = cfg.get('pos_weight', -1)
        pw = 1.0 if pos_weight <= 0 else float(pos_weight)
        out = []
        for i in range(gt_bboxes.shape[0]):
            labels, pos, pos_gt, gt_inds = atss_assign(
                self.assigner, self.prior_generator, flat, num_level,
                featmap_sizes, gt_bboxes[i].float(), gt_valid[i],
                gt_labels[i], img_shapes[i], pad_shapes[i],
                cfg.get('allowed_border', -1), self.num_classes)
            label_weights = torch.where(pos, pw, (gt_inds == 0).float())
            out.append((labels, label_weights, pos,
                        torch.where(pos[:, None], pos_gt, 0.0)))
        return (flat, *[torch.stack(t) for t in zip(*out)])

    @staticmethod
    def centerness_target(anchors: torch.Tensor,
                          gts: torch.Tensor) -> torch.Tensor:
        """sqrt(min(l, r) / max(l, r) * min(t, b) / max(t, b)) of the
        anchors' centres in their gts, the maxima clamped at 1e-12 and the
        product at 0."""
        cx = (anchors[..., 0] + anchors[..., 2]) / 2
        cy = (anchors[..., 1] + anchors[..., 3]) / 2
        l_, t_ = cx - gts[..., 0], cy - gts[..., 1]
        r_, b_ = gts[..., 2] - cx, gts[..., 3] - cy
        c = (torch.minimum(l_, r_) / torch.maximum(l_, r_).clamp(min=1e-12)) \
            * (torch.minimum(t_, b_)
               / torch.maximum(t_, b_).clamp(min=1e-12))
        return torch.sqrt(c.clamp(min=0.0))

    # --------------------------------------------------------------- loss
    def loss(self, cls_scores, bbox_preds, centernesses, gt_bboxes,
             gt_valid, gt_labels, img_shapes, pad_shapes
             ) -> Dict[str, torch.Tensor]:
        """loss_cls (over the positives), loss_bbox (on the decoded boxes,
        weighted by the positives' centerness targets and divided by their
        sum) and loss_centerness (BCE toward the target, over the
        positives)."""
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        flat, labels, label_weights, pos, pos_gt = self.atss_targets(
            featmap_sizes, gt_bboxes, gt_valid, gt_labels, img_shapes,
            pad_shapes)
        b = gt_bboxes.shape[0]
        cls_flat = torch.cat([s.reshape(b, -1, self.cls_out_channels)
                              for s in cls_scores], 1)
        box_flat = torch.cat([p.reshape(b, -1, 4) for p in bbox_preds], 1)
        cness_flat = torch.cat([c.reshape(b, -1) for c in centernesses], 1)
        num_total = pos.sum().float().clamp(min=1.0)
        loss_cls = self.loss_cls(
            cls_flat.reshape(-1, self.cls_out_channels), labels.reshape(-1),
            weight=label_weights.reshape(-1), avg_factor=num_total)
        anchors_b = flat[None].expand(b, -1, -1)
        bbox_t = torch.where(pos[..., None],
                             self.bbox_coder.encode(anchors_b, pos_gt), 0.0)
        decoded = self.bbox_coder.decode(anchors_b, box_flat)
        decoded_t = self.bbox_coder.decode(anchors_b, bbox_t)
        cness_t = torch.where(pos, self.centerness_target(anchors_b,
                                                          decoded_t), 0.0)
        loss_bbox = self.loss_bbox(
            decoded.reshape(-1, 4), decoded_t.reshape(-1, 4),
            weight=cness_t.reshape(-1),
            avg_factor=cness_t.sum().clamp(min=1e-6))
        loss_cness = self.loss_centerness(
            cness_flat.reshape(-1), cness_t.reshape(-1),
            weight=pos.reshape(-1).float(), avg_factor=num_total)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_cness)

    # -------------------------------------------------------------- boxes
    def get_bboxes(self, cls_scores, bbox_preds, centernesses, img_shapes,
                   scale_factors, cfg=None, rescale: bool = True,
                   with_nms: bool = True):
        """Per level the top ``nms_pre`` anchors by their best class score
        times centerness (sigmoids), decoded and clipped to the image,
        divided by the scale factor with ``rescale``; then the multiclass
        NMS with the centerness as score factor, or with ``with_nms=False``
        the candidates (boxes (B, P, 4), scores (B, P, C + 1) with a zero
        background column, centerness (B, P))."""
        cfg = dict(cfg or self.test_cfg)
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_generator.grid_anchors(featmap_sizes,
                                                    cls_scores[0].device)
        nms_pre = cfg.get('nms_pre', -1)
        b = cls_scores[0].shape[0]
        c = self.cls_out_channels
        max_shape = img_shapes[:, None, :]
        mlvl_boxes, mlvl_scores, mlvl_cness = [], [], []
        for a, sc, bp, cn in zip(anchors, cls_scores, bbox_preds,
                                 centernesses):
            sc = torch.sigmoid(sc.reshape(b, -1, c).float())
            cn = torch.sigmoid(cn.reshape(b, -1).float())
            bp = bp.reshape(b, -1, 4).float()
            a = a[None].expand(b, -1, -1)
            if 0 < nms_pre < sc.shape[1]:
                _, top = fast_topk((sc * cn[..., None]).amax(-1), nms_pre)
                sc = torch.gather(sc, 1, top[..., None].expand(-1, -1, c))
                bp = torch.gather(bp, 1, top[..., None].expand(-1, -1, 4))
                cn = torch.gather(cn, 1, top)
                a = torch.gather(a, 1, top[..., None].expand(-1, -1, 4))
            mlvl_boxes.append(self.bbox_coder.decode(a, bp,
                                                     max_shape=max_shape))
            mlvl_scores.append(sc)
            mlvl_cness.append(cn)
        boxes = torch.cat(mlvl_boxes, 1)
        scores = torch.cat(mlvl_scores, 1)
        cness = torch.cat(mlvl_cness, 1)
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, :4]
        scores = torch.cat([scores, torch.zeros_like(scores[..., :1])], -1)
        if not with_nms:
            return boxes, scores, cness
        return multiclass_nms(boxes, scores, cfg['score_thr'],
                              dict(cfg['nms']), cfg.get('max_per_img', 100),
                              score_factors=cness)
