"""VFNet head (counterpart of
``swindet_tpu/models/dense_heads/vfnet_head.py``: ``_star_offsets`` :34,
``VFNetHead`` :51 with ``_get_points`` :132,
``_atss_vfnet_target_single`` :143, ``forward_single`` :174, ``loss``
:219, ``get_bboxes`` :296; reference mmdet/models/dense_heads/
vfnet_head.py:19, arXiv:2008.13367).

FCOS's point set and towers (GN ConvModules, no deformable last conv: the
JAX package builds its towers without ``dcn_on_last_conv``), then an
initial (left, top, right, bottom) regression, exp'd and scaled by the
level's ``reg_denom``; its star of nine points (the box's corners, edge
midpoints and centre, in strides, with only ``gradient_mul`` of the
gradient) steers two deformable 3x3 convs (``ops/deform_conv.py``), one
refining the box by a factor on the detached initial one, one scoring the
classes. Targets: ATSS on a square anchor a point (``use_atss``, the
points at the anchors' centres) or FCOS's (``FCOSHead._target_single``);
IoU-weighted GIoU losses on both boxes and the varifocal loss toward the
refined box's IoU at the gt's class.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..builder import build_anchor_generator, build_assigner, build_loss
from ..layers import ConvModule, conv_nhwc, he_normal_, init_conv
from ...core.bbox.coders import bbox2distance, distance2bbox
from ...core.bbox.iou import bbox_overlaps
from ...core.nms import fast_topk, multiclass_nms
from ...ops.deform_conv import DeformConv2d
from ...registries import HEADS
from .atss_head import atss_assign, conv_towers
from .fcos_head import INF, FCOSHead, Scale


def star_offsets(l_, t_, r_, b_):
    """The star's (dy, dx) offsets of the nine taps (..., 18), in the
    deformable conv's tap order (y first), from the distances (...) in
    strides: rows -t, 0, b by columns -l, 0, r."""
    z = torch.zeros_like(l_)
    out = []
    for dy in (-t_, z, b_):
        for dx in (-l_, z, r_):
            out += [dy, dx]
    return torch.stack(out, -1)


# the 3x3 kernel's base grid (dy, dx) per tap, which the deformable conv
# adds itself
_DCN_BASE = np.stack(np.meshgrid(np.arange(3) - 1, np.arange(3) - 1,
                                 indexing='ij'), -1).reshape(-1)


@HEADS.register_module()
class VFNetHead(FCOSHead):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 gradient_mul: float = 0.1,
                 bbox_norm_type: str = 'reg_denom', use_vfl: bool = True,
                 use_atss: bool = True, sync_num_pos: bool = True,
                 anchor_generator: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 loss_bbox_refine: Optional[dict] = None, **kwargs):
        # use_vfl and sync_num_pos are taken for the configs and unused, as
        # in the JAX package: the class loss is loss_cls's toward the
        # IoU targets, and one card holds every positive
        self.gradient_mul = gradient_mul
        self.bbox_norm_type = bbox_norm_type
        self.use_atss = use_atss
        super().__init__(
            num_classes=num_classes, in_channels=in_channels,
            loss_cls=loss_cls or dict(
                type='VarifocalLoss', use_sigmoid=True, alpha=0.75,
                gamma=2.0, iou_weighted=True, loss_weight=1.0),
            loss_bbox=loss_bbox or dict(type='GIoULoss', loss_weight=1.5),
            **kwargs)
        del self.loss_centerness
        self.loss_bbox_refine = build_loss(dict(loss_bbox_refine or dict(
            type='GIoULoss', loss_weight=2.0)))
        if use_atss:
            ag = dict(anchor_generator or dict(
                type='AnchorGenerator', ratios=[1.0], octave_base_scale=8,
                scales_per_octave=1, center_offset=0.0,
                strides=list(self.strides)))
            self.anchor_center_offset = ag.get('center_offset', 0.0)
            self.atss_prior_generator = build_anchor_generator(ag)
            if self.train_cfg:
                self.atss_assigner = build_assigner(
                    dict(self.train_cfg['assigner']))

    def _init_layers(self):
        d, c = self.compute_dtype, self.feat_channels
        norm_cfg = dict(self.norm_cfg or dict(type='GN', num_groups=32))
        self.cls_convs, self.reg_convs = conv_towers(
            self.in_channels, c, self.stacked_convs, norm_cfg, d)
        self.vfnet_reg_conv = ConvModule(c, c, 3, padding=1,
                                         norm_cfg=norm_cfg,
                                         act_cfg=dict(type='ReLU'), dtype=d)
        self.vfnet_reg = nn.Conv2d(c, 4, 3, padding=1)
        self.vfnet_reg_refine_dconv = DeformConv2d(c, c, 3, dtype=d)
        self.vfnet_reg_refine = nn.Conv2d(c, 4, 3, padding=1)
        self.vfnet_cls_dconv = DeformConv2d(c, c, 3, dtype=d)
        self.vfnet_cls = nn.Conv2d(c, self.num_classes, 3, padding=1)
        self.scales = nn.ModuleList([Scale(1.0) for _ in self.strides])
        self.scales_refine = nn.ModuleList([Scale(1.0)
                                            for _ in self.strides])
        self.register_buffer('dcn_base', torch.from_numpy(
            _DCN_BASE.astype(np.float32)), persistent=False)

    def init_weights(self, gen: torch.Generator):
        """The JAX package's schemes: the ConvModules' as built, the
        deformable convs he-normal over their fan-in, Normal(0, 0.01) on
        the three plain convs, the class bias at the 0.01 prior, every
        scale 1."""
        for m in (*self.cls_convs, *self.reg_convs, self.vfnet_reg_conv):
            m.init_weights(gen)
        for dconv in (self.vfnet_reg_refine_dconv, self.vfnet_cls_dconv):
            he_normal_(dconv.weight, dconv.weight[0].numel(), gen)
        for conv in (self.vfnet_reg, self.vfnet_reg_refine, self.vfnet_cls):
            init_conv(conv, gen, std=0.01)
        with torch.no_grad():
            self.vfnet_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))
            for s in (*self.scales, *self.scales_refine):
                s.scale.fill_(1.0)

    def _reg_denom(self, lvl: int) -> float:
        stride, top = self.strides[lvl], self.regress_ranges[lvl][1]
        if self.bbox_norm_type != 'reg_denom':
            return stride
        return top if top != INF else stride * 8

    def forward_single(self, x: torch.Tensor, lvl: int, train: bool = False):
        """One level: class logits (B, H, W, C), the initial box distances
        and the refined ones (B, H, W, 4), both in pixels and fp32."""
        d, stride = self.compute_dtype, self.strides[lvl]
        cls_feat = reg_feat = x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        reg_init = self.vfnet_reg_conv(reg_feat)
        bbox_pred = torch.exp(self.scales[lvl](conv_nhwc(
            reg_init, self.vfnet_reg, False, d, False).float())) \
            * self._reg_denom(lvl)
        # the star's offsets, with gradient_mul of the gradient
        gm = self.gradient_mul
        bp = ((1 - gm) * bbox_pred.detach() + gm * bbox_pred) / stride
        offset = (star_offsets(*bp.unbind(-1)) - self.dcn_base).to(
            reg_feat.dtype)
        reg_ref = torch.relu(self.vfnet_reg_refine_dconv(reg_feat, offset))
        refine = torch.exp(self.scales_refine[lvl](conv_nhwc(
            reg_ref, self.vfnet_reg_refine, False, d, False).float()))
        bbox_pred_refine = refine * bbox_pred.detach()
        cls_feat = torch.relu(self.vfnet_cls_dconv(cls_feat, offset.to(
            cls_feat.dtype)))
        return (conv_nhwc(cls_feat, self.vfnet_cls, False, d, False),
                bbox_pred, bbox_pred_refine)

    # ------------------------------------------------------------ targets
    def _get_points(self, featmap_sizes, device):
        """With ATSS the points sit at the square anchors' centres (the
        grid point plus ``center_offset`` strides), else FCOS's."""
        if not self.use_atss:
            return super()._get_points(featmap_sizes, device)
        return [self.point_generator.grid_points(fs, s, device)[:, :2]
                + s * self.anchor_center_offset
                for fs, s in zip(featmap_sizes, self.strides)]

    def vfnet_targets(self, featmap_sizes, gt_bboxes, gt_valid, gt_labels,
                      img_shapes, pad_shapes):
        """Every point's (B, N) labels, (B, N, 4) (left, top, right,
        bottom) box targets in pixels (0 where not positive) and (B, N)
        positive mask, and the points (N, 2)."""
        dev = gt_bboxes.device
        pts = self._get_points(featmap_sizes, dev)
        all_pts = torch.cat(pts)
        out = []
        if self.use_atss:
            anchors = self.atss_prior_generator.grid_anchors(featmap_sizes,
                                                             dev)
            flat, num_level = torch.cat(anchors), [len(a) for a in anchors]
            for i in range(gt_bboxes.shape[0]):
                labels, pos, pos_gt, _ = atss_assign(
                    self.atss_assigner, self.atss_prior_generator, flat,
                    num_level, featmap_sizes, gt_bboxes[i].float(),
                    gt_valid[i], gt_labels[i], img_shapes[i], pad_shapes[i],
                    self.train_cfg.get('allowed_border', -1),
                    self.num_classes)
                out.append((labels, torch.where(
                    pos[:, None], bbox2distance(all_pts, pos_gt), 0.0), pos))
        else:
            ranges = torch.cat([torch.tensor(r, dtype=torch.float32,
                                             device=dev)[None].expand(
                                                 len(p), 2)
                                for p, r in zip(pts, self.regress_ranges)])
            strides = torch.cat([torch.full((len(p),), float(s), device=dev)
                                 for p, s in zip(pts, self.strides)])
            out = [self._target_single(all_pts, strides, ranges,
                                       gt_bboxes[i].float(), gt_valid[i],
                                       gt_labels[i])
                   for i in range(gt_bboxes.shape[0])]
        labels, bbox_t, pos = (torch.stack(t) for t in zip(*out))
        return labels, bbox_t, pos, all_pts

    # --------------------------------------------------------------- loss
    def loss(self, cls_scores, bbox_preds, bbox_preds_refine, gt_bboxes,
             gt_valid, gt_labels, img_shapes, pad_shapes
             ) -> Dict[str, torch.Tensor]:
        """loss_bbox and loss_bbox_rf (GIoU of the positives' initial and
        refined boxes, each weighted by its detached IoU over the mean),
        and loss_cls (varifocal toward the refined box's IoU at the gt's
        class, over the positives)."""
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        labels, bbox_t, pos, all_pts = self.vfnet_targets(
            featmap_sizes, gt_bboxes, gt_valid, gt_labels, img_shapes,
            pad_shapes)
        b, c = gt_bboxes.shape[0], self.num_classes
        cls_flat = torch.cat([s.reshape(b, -1, c) for s in cls_scores], 1)
        pts_b = all_pts[None].expand(b, -1, -1)
        dec_t = distance2bbox(pts_b, bbox_t)
        num_pos = pos.sum().float().clamp(min=1.0)

        def iou_weighted(preds, loss_fn):
            dec = distance2bbox(pts_b, torch.cat(
                [p.reshape(b, -1, 4) for p in preds], 1))
            iou = torch.where(pos, bbox_overlaps(dec.detach(), dec_t,
                                                 is_aligned=True), 0.0)
            w = iou / (iou.sum() / num_pos).clamp(min=1e-6)
            loss = loss_fn(dec.reshape(-1, 4), dec_t.reshape(-1, 4),
                           weight=torch.where(pos, w, 0.0).reshape(-1),
                           avg_factor=(w * pos).sum().clamp(min=1e-6))
            return loss, iou
        loss_bbox, _ = iou_weighted(bbox_preds, self.loss_bbox)
        loss_bbox_rf, iou_ref = iou_weighted(bbox_preds_refine,
                                             self.loss_bbox_refine)
        own = torch.nn.functional.one_hot(labels.clamp(0, c - 1), c).bool() \
            & pos[..., None]
        vfl_t = torch.where(own, iou_ref[..., None], 0.0)
        loss_cls = self.loss_cls(cls_flat.reshape(-1, c),
                                 vfl_t.reshape(-1, c), avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_bbox_rf=loss_bbox_rf)

    # -------------------------------------------------------------- boxes
    def get_bboxes(self, cls_scores, bbox_preds, bbox_preds_refine,
                   img_shapes, scale_factors, cfg=None, rescale: bool = True,
                   with_nms: bool = True):
        """The refined boxes: per level the top ``nms_pre`` points by their
        best class score (sigmoid), decoded and clipped to the image,
        divided by the scale factor with ``rescale``; then the multiclass
        NMS (no score factor), or with ``with_nms=False`` the candidates
        (boxes (B, P, 4), scores (B, P, C + 1) with a zero background
        column)."""
        cfg = dict(cfg or self.test_cfg)
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        pts = self._get_points(featmap_sizes, cls_scores[0].device)
        nms_pre = cfg.get('nms_pre', -1)
        b, c = cls_scores[0].shape[0], self.num_classes
        max_shape = img_shapes[:, None, :]
        mlvl_boxes, mlvl_scores = [], []
        for p, sc, bp in zip(pts, cls_scores, bbox_preds_refine):
            sc = torch.sigmoid(sc.reshape(b, -1, c).float())
            bp = bp.reshape(b, -1, 4).float()
            pp = p[None].expand(b, -1, -1)
            if 0 < nms_pre < sc.shape[1]:
                _, top = fast_topk(sc.amax(-1), nms_pre)
                sc = torch.gather(sc, 1, top[..., None].expand(-1, -1, c))
                bp = torch.gather(bp, 1, top[..., None].expand(-1, -1, 4))
                pp = p[top]
            mlvl_boxes.append(distance2bbox(pp, bp, max_shape=max_shape))
            mlvl_scores.append(sc)
        boxes = torch.cat(mlvl_boxes, 1)
        scores = torch.cat(mlvl_scores, 1)
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, :4]
        scores = torch.cat([scores, torch.zeros_like(scores[..., :1])], -1)
        if not with_nms:
            return boxes, scores
        return multiclass_nms(boxes, scores, cfg['score_thr'],
                              dict(cfg['nms']), cfg.get('max_per_img', 100))
