"""RepPoints head (counterpart of
``swindet_tpu/models/dense_heads/reppoints_head.py:28``: ``points2bbox``
:120, ``gen_grid_from_reg`` :154, ``forward_single`` :181, ``loss`` :249,
``get_bboxes`` :330; reference mmdet/models/dense_heads/
reppoints_head.py:14).

NHWC per level: stacked 3x3 cls and reg ``ConvModule``s (the conv3x3
kernel with fused ReLU at 256 channels), a plain 3x3 conv and a 1x1 conv
for the initial point offsets, and two deformable convs at those offsets
for the classes and the refined offsets. Offsets are in feature cells,
(dy, dx) pairs y-first; absolute points are xy. Targets are assigned on
the full point set of each image: the PointAssigner on the grid points
for the initial stage, the MaxIoUAssigner on the detached initial boxes
for the refined stage, with every positive and every negative kept (the
PseudoSampler's semantics).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..builder import build_assigner, build_loss
from ..layers import (ConvModule, conv_nhwc, he_normal_, init_conv,
                      resolve_dtype)
from ...core.anchors import PointGenerator
from ...core.nms import fast_topk, multiclass_nms
from ...ops.deform_conv import DeformConv2d
from ...registries import HEADS


@HEADS.register_module()
class RepPointsHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_points: int = 9,
                 gradient_mul: float = 0.1,
                 point_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 point_base_scale: int = 4, transform_method: str = 'moment',
                 moment_mul: float = 0.01, use_grid_points: bool = False,
                 center_init: bool = True, norm_cfg: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox_init: Optional[dict] = None,
                 loss_bbox_refine: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, dtype=torch.float32):
        super().__init__()
        if transform_method not in ('moment', 'minmax', 'partial_minmax'):
            raise ValueError(f'RepPointsHead: transform {transform_method}')
        d = resolve_dtype(dtype)
        self.compute_dtype = d
        self.num_classes = num_classes
        self.cls_out_channels = num_classes  # sigmoid classifier
        self.num_points = num_points
        self.gradient_mul = gradient_mul
        self.point_strides = list(point_strides)
        self.point_base_scale = point_base_scale
        self.transform_method = transform_method
        self.moment_mul = moment_mul
        self.use_grid_points = use_grid_points
        self.center_init = center_init
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.point_generator = PointGenerator()
        self.loss_cls = build_loss(dict(loss_cls or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0)))
        self.loss_bbox_init = build_loss(dict(loss_bbox_init or dict(
            type='SmoothL1Loss', beta=1.0 / 9.0, loss_weight=0.5)))
        self.loss_bbox_refine = build_loss(dict(loss_bbox_refine or dict(
            type='SmoothL1Loss', beta=1.0 / 9.0, loss_weight=1.0)))
        if train_cfg:
            self.init_assigner = build_assigner(
                dict(dict(train_cfg)['init']['assigner']))
            self.refine_assigner = build_assigner(
                dict(dict(train_cfg)['refine']['assigner']))
        # the deformable convs' base offsets: a k x k grid, y-first
        k = int(np.sqrt(num_points))
        if k * k != num_points:
            raise ValueError('RepPointsHead: num_points must be a square')
        base = np.stack(np.meshgrid(np.arange(k) - k // 2,
                                    np.arange(k) - k // 2, indexing='ij'),
                        -1).reshape(-1, 2)
        self.dcn_base_offset = base.astype(np.float32)    # (K, 2) (dy, dx)

        def stack(cin):
            return nn.ModuleList([ConvModule(
                cin if i == 0 else feat_channels, feat_channels, 3,
                padding=1, norm_cfg=norm_cfg, act_cfg=dict(type='ReLU'),
                dtype=d) for i in range(stacked_convs)])
        self.cls_convs = stack(in_channels)
        self.reg_convs = stack(in_channels)
        pts_out = 4 if use_grid_points else 2 * num_points
        pf = point_feat_channels
        self.reppoints_cls_conv = DeformConv2d(feat_channels, pf, 3, dtype=d)
        self.reppoints_cls_out = nn.Conv2d(pf, num_classes, 1)
        # a plain conv in the JAX package (nn.Conv, not a ConvModule): it
        # stays F.conv2d, off the conv3x3 kernel
        self.reppoints_pts_init_conv = nn.Conv2d(feat_channels, pf, 3,
                                                 padding=1)
        self.reppoints_pts_init_out = nn.Conv2d(pf, pts_out, 1)
        self.reppoints_pts_refine_conv = DeformConv2d(feat_channels, pf, 3,
                                                      dtype=d)
        self.reppoints_pts_refine_out = nn.Conv2d(pf, pts_out, 1)
        if transform_method == 'moment':
            self.moment_transfer = nn.Parameter(torch.zeros(2))

    def init_weights(self, gen: torch.Generator):
        """The JAX package's schemes: flax conv defaults on the stacked
        convs and the initial points' 3x3 conv, Normal(0, 0.01) on the
        three 1x1 outputs, the class output's bias at the 0.01 prior,
        he_normal on the deformable convs, moment_transfer zero."""
        for m in (*self.cls_convs, *self.reg_convs):
            m.init_weights(gen)
        init_conv(self.reppoints_pts_init_conv, gen)
        for conv in (self.reppoints_cls_out, self.reppoints_pts_init_out,
                     self.reppoints_pts_refine_out):
            init_conv(conv, gen, std=0.01)
        with torch.no_grad():
            self.reppoints_cls_out.bias.fill_(-math.log((1 - 0.01) / 0.01))
        for dcn in (self.reppoints_cls_conv, self.reppoints_pts_refine_conv):
            # he_normal on the JAX package's (K, C, F) weight: fan-in K C
            he_normal_(dcn.weight, dcn.weight[0].numel(), gen)
        if self.transform_method == 'moment':
            nn.init.zeros_(self.moment_transfer)

    # ------------------------------------------------------------ utils
    def points2bbox(self, pts: torch.Tensor,
                    y_first: bool = True) -> torch.Tensor:
        """(..., 2 * num_points) point sets -> (..., 4) boxes, by the
        head's transform. ``moment``: the mean, and the unbiased std
        (clipped at 1e-12 before the root) scaled by exp(moment_transfer),
        whose gradient is scaled by ``moment_mul``. A bf16 point set's
        statistics stay bf16 and meet the fp32 transfer in fp32, as the
        JAX package's type promotion has it."""
        p = pts.reshape(*pts.shape[:-1], self.num_points, 2)
        py, px = (p[..., 0], p[..., 1]) if y_first else (p[..., 1],
                                                         p[..., 0])
        if self.transform_method != 'moment':
            if self.transform_method == 'partial_minmax':
                px, py = px[..., :4], py[..., :4]
            return torch.stack([px.amin(-1), py.amin(-1), px.amax(-1),
                                py.amax(-1)], -1)
        mx, my = px.mean(-1), py.mean(-1)
        denom = max(self.num_points - 1, 1)
        sx = torch.sqrt(torch.clamp(((px - mx[..., None]) ** 2).sum(-1)
                                    / denom, min=1e-12))
        sy = torch.sqrt(torch.clamp(((py - my[..., None]) ** 2).sum(-1)
                                    / denom, min=1e-12))
        mt = self.moment_transfer
        mt = mt * self.moment_mul + mt.detach() * (1 - self.moment_mul)
        half_w = sx.float() * torch.exp(mt[0])
        half_h = sy.float() * torch.exp(mt[1])
        mx, my = mx.float(), my.float()
        return torch.stack([mx - half_w, my - half_h, mx + half_w,
                            my + half_h], -1)

    def gen_grid_from_reg(self, reg: torch.Tensor,
                          previous_boxes: torch.Tensor):
        """A box regression (..., 4 = [dx, dy, dw, dh]) on
        ``previous_boxes`` -> the uniform k x k point grid inside the
        regressed box, y-first interleaved (..., 2K), and the box itself.
        Feature cells throughout."""
        k = int(np.sqrt(self.num_points))
        bxy = (previous_boxes[..., :2] + previous_boxes[..., 2:]) * 0.5
        bwh = (previous_boxes[..., 2:] - previous_boxes[..., :2]).clamp(
            min=1e-6)
        topleft = bxy + bwh * reg[..., :2] - 0.5 * bwh * torch.exp(
            reg[..., 2:])
        wh = bwh * torch.exp(reg[..., 2:])
        t = torch.linspace(0.0, 1.0, k, device=reg.device, dtype=reg.dtype)
        # point (i, j) = (top + h t[i], left + w t[j]), order i k + j
        gy = topleft[..., 1:2] + wh[..., 1:2] * t
        gx = topleft[..., 0:1] + wh[..., 0:1] * t
        yy = gy.repeat_interleave(k, dim=-1)
        xx = gx.repeat(*(1,) * (gx.ndim - 1), k)
        grid = torch.stack([yy, xx], -1).reshape(*reg.shape[:-1],
                                                 2 * self.num_points)
        return grid, torch.cat([topleft, topleft + wh], -1)

    # ---------------------------------------------------------- forward
    def forward_single(self, x: torch.Tensor):
        """x (B, H, W, C) -> class logits (B, H, W, classes), initial and
        refined point offsets (B, H, W, 2K) y-first, in feature cells."""
        d = self.compute_dtype
        scale = self.point_base_scale / 2
        base = self.dcn_base_offset.reshape(-1)
        bbox_init = None
        if self.use_grid_points or not self.center_init:
            points_init = torch.as_tensor(
                base / np.abs(self.dcn_base_offset).max() * scale,
                dtype=d, device=x.device)
            bbox_init = torch.tensor([-scale, -scale, scale, scale],
                                     device=x.device)
        else:
            points_init = 0.0
        cls_feat = pts_feat = x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            pts_feat = conv(pts_feat)
        pts_out_init = conv_nhwc(
            conv_nhwc(pts_feat, self.reppoints_pts_init_conv, True, d, False),
            self.reppoints_pts_init_out, False, d, False)
        if self.use_grid_points:
            pts_out_init, bbox_out_init = self.gen_grid_from_reg(
                pts_out_init.float(), bbox_init)
        else:
            pts_out_init = pts_out_init + points_init
        # the deformable convs see the offsets with their gradient scaled
        # by gradient_mul
        grad_pts = self.gradient_mul * pts_out_init \
            + (1 - self.gradient_mul) * pts_out_init.detach()
        dcn_offset = grad_pts - torch.as_tensor(base, dtype=grad_pts.dtype,
                                                device=x.device)
        cls_out = conv_nhwc(
            torch.relu(self.reppoints_cls_conv(cls_feat, dcn_offset)),
            self.reppoints_cls_out, False, d, False)
        pts_out_refine = conv_nhwc(
            torch.relu(self.reppoints_pts_refine_conv(pts_feat, dcn_offset)),
            self.reppoints_pts_refine_out, False, d, False)
        if self.use_grid_points:
            pts_out_refine, _ = self.gen_grid_from_reg(
                pts_out_refine.float(), bbox_out_init.detach())
        else:
            pts_out_refine = pts_out_refine + pts_out_init.detach()
        return cls_out, pts_out_init, pts_out_refine

    def forward(self, feats):
        """Per level class logits, initial and refined offsets."""
        outs = [self.forward_single(f) for f in feats]
        return tuple(list(t) for t in zip(*outs))

    # ----------------------------------------------------------- points
    def get_points(self, featmap_sizes, device):
        """Per level (N_l, 3) ``[x, y, stride]`` grid points, fp32."""
        return [self.point_generator.grid_points(fs, s, device)
                for fs, s in zip(featmap_sizes, self.point_strides)]

    def offsets_to_pts(self, pts_preds, featmap_sizes):
        """Per level offsets (B, H, W, 2K) y-first -> absolute xy points
        (B, N_l, K, 2) in pixels, fp32."""
        points = self.get_points(featmap_sizes, pts_preds[0].device)
        out = []
        for pred, pts, stride in zip(pts_preds, points, self.point_strides):
            o = pred.reshape(pred.shape[0], -1, self.num_points, 2)
            xy = torch.stack([o[..., 1], o[..., 0]], -1)
            out.append(pts[None, :, None, :2] + xy * stride)
        return out

    # ------------------------------------------------------------- loss
    def _full_point_targets(self, assigner, cands, gt_bboxes, gt_valid,
                            gt_labels):
        """One image's targets on its full candidate set: labels (the
        background ``num_classes`` off the positives), label weights (every
        positive and negative), box targets and weights, positive count."""
        assign = assigner.assign(cands, gt_bboxes, gt_valid, gt_labels)
        pos = assign.gt_inds > 0
        neg = assign.gt_inds == 0
        gt_idx = (assign.gt_inds.long() - 1).clamp(min=0)
        bbox_gt = torch.where(pos[:, None], gt_bboxes[gt_idx], 0.0)
        labels = torch.where(pos, gt_labels.long()[gt_idx], self.num_classes)
        return (labels, (pos | neg).float(), bbox_gt, pos.float(),
                pos.sum())

    def _targets(self, assigner, cands, gt_bboxes, gt_valid, gt_labels):
        """The batch's targets, stacked over images; ``cands`` (N, 3) for
        all images or (B, N, 4) per image."""
        per_image = [self._full_point_targets(
            assigner, cands if cands.ndim == 2 else cands[i], gt_bboxes[i],
            gt_valid[i], gt_labels[i]) for i in range(gt_bboxes.shape[0])]
        return [torch.stack(t) for t in zip(*per_image)]

    def loss(self, cls_scores, pts_init_preds, pts_refine_preds, gt_bboxes,
             gt_valid, gt_labels, img_shapes=None, pad_shapes=None
             ) -> Dict[str, torch.Tensor]:
        """Focal loss of the classes on the refined stage's targets, and
        SmoothL1 of the initial and refined boxes, each normalised by
        ``point_base_scale`` x its point's stride and averaged over its
        stage's positives of the batch (at least 1)."""
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        dev = cls_scores[0].device
        points = self.get_points(featmap_sizes, dev)
        all_points = torch.cat(points, 0)
        b = gt_bboxes.shape[0]
        k2 = 2 * self.num_points
        bbox_init = self.points2bbox(torch.cat(self.offsets_to_pts(
            pts_init_preds, featmap_sizes), 1).reshape(b, -1, k2),
            y_first=False)
        bbox_refine = self.points2bbox(torch.cat(self.offsets_to_pts(
            pts_refine_preds, featmap_sizes), 1).reshape(b, -1, k2),
            y_first=False)
        with torch.no_grad():
            _, _, bbox_gt_i, bbox_w_i, npos_i = self._targets(
                self.init_assigner, all_points, gt_bboxes, gt_valid,
                gt_labels)
            labels_r, label_w_r, bbox_gt_r, bbox_w_r, npos_r = \
                self._targets(self.refine_assigner, bbox_init.detach(),
                              gt_bboxes, gt_valid, gt_labels)
        strides = torch.cat([torch.full((p.shape[0],), float(s), device=dev)
                             for p, s in zip(points, self.point_strides)])
        norm = (self.point_base_scale * strides)[None, :, None]
        cls_flat = torch.cat([s.reshape(b, -1, self.cls_out_channels)
                              for s in cls_scores], 1)
        num_pos_r = npos_r.sum().float().clamp(min=1.0)
        num_pos_i = npos_i.sum().float().clamp(min=1.0)
        loss_cls = self.loss_cls(
            cls_flat.reshape(-1, self.cls_out_channels), labels_r.reshape(-1),
            weight=label_w_r.reshape(-1), avg_factor=num_pos_r)
        loss_pts_init = self.loss_bbox_init(
            bbox_init / norm, bbox_gt_i / norm,
            weight=bbox_w_i[..., None].expand_as(bbox_init),
            avg_factor=num_pos_i)
        loss_pts_refine = self.loss_bbox_refine(
            bbox_refine / norm, bbox_gt_r / norm,
            weight=bbox_w_r[..., None].expand_as(bbox_refine),
            avg_factor=num_pos_r)
        return dict(loss_cls=loss_cls, loss_pts_init=loss_pts_init,
                    loss_pts_refine=loss_pts_refine)

    # ------------------------------------------------------------ boxes
    def get_bboxes(self, cls_scores, pts_init_preds, pts_refine_preds,
                   img_shapes, scale_factors, cfg=None, rescale: bool = True,
                   with_nms: bool = True):
        """Per level the top ``nms_pre`` points by their best class score
        (sigmoid), their refined boxes in pixels clipped to the image,
        divided by the scale factor with ``rescale``; then the port's
        multiclass NMS (a ``MulticlassNMSResult``), or with
        ``with_nms=False`` the candidates (boxes (B, P, 4), scores
        (B, P, classes + 1) with a zero background column)."""
        cfg = dict(cfg or self.test_cfg)
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points = self.get_points(featmap_sizes, cls_scores[0].device)
        nms_pre = cfg.get('nms_pre', -1)
        b = cls_scores[0].shape[0]
        h = img_shapes[:, 0].float()[:, None]
        w = img_shapes[:, 1].float()[:, None]
        mlvl_boxes, mlvl_scores = [], []
        for lvl, (score, pred) in enumerate(zip(cls_scores,
                                                pts_refine_preds)):
            bbox = self.points2bbox(pred.reshape(b, -1, 2 * self.num_points),
                                    y_first=True)
            bbox = bbox * self.point_strides[lvl] \
                + points[lvl][:, :2].repeat(1, 2)[None]
            sc = torch.sigmoid(score.reshape(b, -1, self.cls_out_channels)
                               .float())
            if 0 < nms_pre < sc.shape[1]:
                _, top = fast_topk(sc.amax(-1), nms_pre)
                sc = torch.gather(sc, 1, top[..., None].expand(
                    -1, -1, sc.shape[-1]))
                bbox = torch.gather(bbox, 1, top[..., None].expand(-1, -1, 4))
            bbox = torch.stack([bbox[..., 0].clamp(min=0).minimum(w),
                                bbox[..., 1].clamp(min=0).minimum(h),
                                bbox[..., 2].clamp(min=0).minimum(w),
                                bbox[..., 3].clamp(min=0).minimum(h)], -1)
            mlvl_boxes.append(bbox)
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
