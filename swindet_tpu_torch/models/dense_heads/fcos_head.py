"""FCOS head (counterpart of
``swindet_tpu/models/dense_heads/fcos_head.py``: ``_build_towers`` :77,
``forward_single`` :98, ``_get_points`` :126, ``_target_single`` :133,
``centerness_target`` :183, ``loss`` :191, ``get_bboxes`` :248; reference
mmdet/models/dense_heads/fcos_head.py).

Anchor-free: every point of every level regresses its (left, top, right,
bottom) distances to a box and scores the classes and its centerness.
NHWC per level: two towers of ``stacked_convs`` 3x3 ReLU ``ConvModule``s
(norm-free ones with a bias at 128-multiple widths run the conv3x3
kernel, as the JAX package sends them to its Pallas kernel; the last a
DCNv2 with ``dcn_on_last_conv``), then plain 3x3 class, box and
centerness convs and a learnable scale a level (mmdet's ``Scale``,
``scales.{i}.scale``). Targets are computed on the full point set of each
image: a point is positive for the smallest-area gt that contains it (or
its centre-sampling box) and whose largest distance falls in the level's
regress range.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..builder import build_loss
from ..layers import ConvModule, conv_nhwc, init_conv, resolve_dtype
from ...core.anchors import PointGenerator
from ...core.bbox.coders import distance2bbox
from ...core.nms import fast_topk, multiclass_nms
from ...registries import HEADS

INF = 1e8


class Scale(nn.Module):
    """A learnable scalar (mmcv's ``Scale``): ``scale``, shape ()."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(scale, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


@HEADS.register_module()
class FCOSHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges: Sequence[Tuple[float, float]] = (
                     (-1, 64), (64, 128), (128, 256), (256, 512),
                     (512, INF)),
                 center_sampling: bool = False,
                 center_sample_radius: float = 1.5,
                 norm_on_bbox: bool = False, centerness_on_reg: bool = False,
                 dcn_on_last_conv: bool = False, conv_bias='auto',
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 loss_centerness: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = resolve_dtype(dtype)
        self.num_classes = num_classes
        self.cls_out_channels = num_classes  # sigmoid classifier
        self.in_channels = in_channels
        self.feat_channels = feat_channels
        self.stacked_convs = stacked_convs
        self.strides = list(strides)
        self.regress_ranges = [tuple(r) for r in regress_ranges]
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.norm_on_bbox = norm_on_bbox
        self.centerness_on_reg = centerness_on_reg
        self.dcn_on_last_conv = dcn_on_last_conv
        self.conv_bias = conv_bias
        self.norm_cfg = norm_cfg
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.point_generator = PointGenerator()
        self.loss_cls = build_loss(dict(loss_cls or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0)))
        self.loss_bbox = build_loss(dict(loss_bbox or dict(
            type='IoULoss', loss_weight=1.0)))
        self.loss_centerness = build_loss(dict(loss_centerness or dict(
            type='CrossEntropyLoss', use_sigmoid=True, loss_weight=1.0)))
        self.cls_convs, self.reg_convs = self._build_towers()
        self.conv_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.conv_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.conv_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList([Scale(1.0) for _ in self.strides])

    def _build_towers(self):
        """The stacked 3x3 towers; NASFCOSHead replaces them by the
        searched ops."""
        d = self.compute_dtype

        def tower():
            return nn.ModuleList([ConvModule(
                self.in_channels if i == 0 else self.feat_channels,
                self.feat_channels, 3, padding=1,
                conv_cfg=dict(type='DCNv2') if self.dcn_on_last_conv
                and i == self.stacked_convs - 1 else None,
                norm_cfg=self.norm_cfg, act_cfg=dict(type='ReLU'),
                bias=self.conv_bias, dtype=d)
                for i in range(self.stacked_convs)])
        return tower(), tower()

    def init_weights(self, gen: torch.Generator):
        """The JAX package's schemes: the towers' as built (lecun-normal
        convs, he-normal deformable ones), Normal(0, 0.01) on the three
        outputs, the class bias at the 0.01 prior, every scale 1."""
        for m in (*self.cls_convs, *self.reg_convs):
            m.init_weights(gen)
        for conv in (self.conv_cls, self.conv_reg, self.conv_centerness):
            init_conv(conv, gen, std=0.01)
        with torch.no_grad():
            self.conv_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))
            for s in self.scales:
                s.scale.fill_(1.0)

    def forward_single(self, x: torch.Tensor, lvl: int, train: bool):
        """One level: class logits (B, H, W, C), box distances (B, H, W, 4)
        in fp32 and centerness logits (B, H, W, 1). With ``norm_on_bbox``
        the distances are ReLU'd, in strides in training (``train``) and
        scaled to pixels at test time; else exp'd."""
        d = self.compute_dtype
        cls_feat = reg_feat = x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        cls_score = conv_nhwc(cls_feat, self.conv_cls, False, d, False)
        bbox_pred = self.scales[lvl](
            conv_nhwc(reg_feat, self.conv_reg, False, d, False).float())
        if self.norm_on_bbox:
            bbox_pred = torch.relu(bbox_pred)
            if not train:
                bbox_pred = bbox_pred * self.strides[lvl]
        else:
            bbox_pred = torch.exp(bbox_pred)
        cness_feat = reg_feat if self.centerness_on_reg else cls_feat
        centerness = conv_nhwc(cness_feat, self.conv_centerness, False, d,
                               False)
        return cls_score, bbox_pred, centerness

    def forward(self, feats, train: bool = False):
        """Per level class logits, box distances and centerness logits;
        ``train`` picks forward_single's training branch (the JAX
        package's ``train`` flag: FCOS.forward_train passes True, every
        test path the default)."""
        outs = [self.forward_single(x, i, train) for i, x in enumerate(feats)]
        return tuple([o[k] for o in outs] for k in range(3))

    # ------------------------------------------------------------ targets
    def _get_points(self, featmap_sizes, device):
        """Each level's points (H * W, 2): the cells' centres in pixels
        (the grid point plus stride // 2)."""
        return [self.point_generator.grid_points(fs, s, device)[:, :2]
                + s // 2 for fs, s in zip(featmap_sizes, self.strides)]

    def _target_single(self, points, strides_pts, ranges, gt_bboxes,
                       gt_valid, gt_labels):
        """Labels (N,) (``num_classes`` the background), box targets (N, 4)
        (left, top, right, bottom) and the positive mask of one image's
        points (N, 2), their strides (N,) and regress ranges (N, 2),
        against its padded gts (G, ...). Among the gts a point may take,
        the smallest area wins, the first on a tie."""
        areas = (gt_bboxes[:, 2] - gt_bboxes[:, 0]) \
            * (gt_bboxes[:, 3] - gt_bboxes[:, 1])
        areas = torch.where(gt_valid, areas, INF)
        xs = points[:, 0][:, None]
        ys = points[:, 1][:, None]
        left = xs - gt_bboxes[None, :, 0]
        right = gt_bboxes[None, :, 2] - xs
        top = ys - gt_bboxes[None, :, 1]
        bottom = gt_bboxes[None, :, 3] - ys
        ltrb = torch.stack([left, top, right, bottom], -1)     # (N, G, 4)
        if self.center_sampling:
            # a radius x stride box about the gt's centre, clipped to it
            r = (strides_pts * self.center_sample_radius)[:, None]
            cx = ((gt_bboxes[:, 0] + gt_bboxes[:, 2]) * 0.5)[None]
            cy = ((gt_bboxes[:, 1] + gt_bboxes[:, 3]) * 0.5)[None]
            x0 = torch.maximum(cx - r, gt_bboxes[None, :, 0])
            y0 = torch.maximum(cy - r, gt_bboxes[None, :, 1])
            x1 = torch.minimum(cx + r, gt_bboxes[None, :, 2])
            y1 = torch.minimum(cy + r, gt_bboxes[None, :, 3])
            cb = torch.stack([xs - x0, ys - y0, x1 - xs, y1 - ys], -1)
            inside = cb.amin(-1) > 0
        else:
            inside = ltrb.amin(-1) > 0
        maxd = ltrb.amax(-1)
        in_range = (maxd >= ranges[:, None, 0]) & (maxd <= ranges[:, None, 1])
        ok = inside & in_range & gt_valid[None]
        area_mat = torch.where(ok, areas[None], INF)
        # the first index of a tied minimum, as jnp.argmin
        min_area, gt_idx = area_mat.min(-1)
        pos = min_area < INF
        labels = torch.where(pos, gt_labels.long()[gt_idx], self.num_classes)
        bbox_targets = torch.gather(
            ltrb, 1, gt_idx[:, None, None].expand(-1, 1, 4))[:, 0]
        return labels, bbox_targets, pos

    @staticmethod
    def centerness_target(t: torch.Tensor) -> torch.Tensor:
        lr = t[..., [0, 2]]
        tb = t[..., [1, 3]]
        c = lr.amin(-1) / lr.amax(-1).clamp(min=1e-6) \
            * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6))
        return torch.sqrt(c.clamp(min=0.0))

    def get_targets(self, featmap_sizes, gt_bboxes, gt_valid, gt_labels):
        """Every point's (B, N) labels, (B, N, 4) box targets (in strides
        with ``norm_on_bbox``) and (B, N) positive mask, and the points
        (N, 2) themselves."""
        dev = gt_bboxes.device
        pts = self._get_points(featmap_sizes, dev)
        all_pts = torch.cat(pts)
        ranges = torch.cat([torch.tensor(r, dtype=torch.float32, device=dev)
                            [None].expand(len(p), 2)
                            for p, r in zip(pts, self.regress_ranges)])
        strides_pts = torch.cat([torch.full((len(p),), float(s), device=dev)
                                 for p, s in zip(pts, self.strides)])
        per_image = [self._target_single(
            all_pts, strides_pts, ranges, gt_bboxes[i].float(), gt_valid[i],
            gt_labels[i]) for i in range(gt_bboxes.shape[0])]
        labels, bbox_t, pos = (torch.stack(t) for t in zip(*per_image))
        if self.norm_on_bbox:
            bbox_t = bbox_t / strides_pts[None, :, None]
        return labels, bbox_t, pos, all_pts

    # --------------------------------------------------------------- loss
    def loss(self, cls_scores, bbox_preds, centernesses, gt_bboxes,
             gt_valid, gt_labels, img_shapes=None, pad_shapes=None
             ) -> Dict[str, torch.Tensor]:
        """loss_cls (focal, over the positives), loss_bbox (IoU of the
        decoded positives, weighted and averaged by their centerness
        targets) and loss_centerness (BCE against the continuous target,
        over the positives). The image shapes are taken and unused, as in
        the JAX package."""
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        labels, bbox_t, pos, all_pts = self.get_targets(
            featmap_sizes, gt_bboxes, gt_valid, gt_labels)
        b = gt_bboxes.shape[0]
        cls_flat = torch.cat([s.reshape(b, -1, self.num_classes)
                              for s in cls_scores], 1)
        reg_flat = torch.cat([p.reshape(b, -1, 4) for p in bbox_preds], 1)
        cness_flat = torch.cat([c.reshape(b, -1) for c in centernesses], 1)
        num_pos = pos.sum().float().clamp(min=1.0)
        loss_cls = self.loss_cls(
            cls_flat.reshape(-1, self.num_classes), labels.reshape(-1),
            weight=torch.ones_like(labels.reshape(-1), dtype=torch.float32),
            avg_factor=num_pos)
        cness_t = self.centerness_target(bbox_t)
        pts_b = all_pts[None].expand(b, -1, -1)
        decoded = distance2bbox(pts_b, reg_flat)
        decoded_t = distance2bbox(pts_b, bbox_t)
        weight = torch.where(pos, cness_t, 0.0)
        loss_bbox = self.loss_bbox(
            decoded.reshape(-1, 4), decoded_t.reshape(-1, 4),
            weight=weight.reshape(-1),
            avg_factor=weight.sum().clamp(min=1e-6))
        loss_cness = self.loss_centerness(
            cness_flat.reshape(-1), weight.reshape(-1),
            weight=pos.reshape(-1).float(), avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_cness)

    # -------------------------------------------------------------- boxes
    def get_bboxes(self, cls_scores, bbox_preds, centernesses, img_shapes,
                   scale_factors, cfg=None, rescale: bool = True,
                   with_nms: bool = True):
        """Per level the top ``nms_pre`` points by best class score times
        centerness (sigmoids), their boxes decoded and clipped to the
        image, divided by the scale factor with ``rescale``; then the
        multiclass NMS with the centerness as score factor (a
        ``MulticlassNMSResult``), or with ``with_nms=False`` the
        candidates (boxes (B, P, 4), scores (B, P, C + 1) with a zero
        background column, centerness (B, P))."""
        cfg = dict(cfg or self.test_cfg)
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        pts = self._get_points(featmap_sizes, cls_scores[0].device)
        nms_pre = cfg.get('nms_pre', -1)
        b = cls_scores[0].shape[0]
        max_shape = img_shapes[:, None, :]
        mlvl_boxes, mlvl_scores, mlvl_cness = [], [], []
        for p, sc, bp, cn in zip(pts, cls_scores, bbox_preds, centernesses):
            sc = torch.sigmoid(sc.reshape(b, -1, self.num_classes).float())
            cn = torch.sigmoid(cn.reshape(b, -1).float())
            bp = bp.reshape(b, -1, 4).float()
            pp = p[None].expand(b, -1, -1)
            if 0 < nms_pre < sc.shape[1]:
                _, top = fast_topk(sc.amax(-1) * cn, nms_pre)
                sc = torch.gather(sc, 1, top[..., None].expand(
                    -1, -1, self.num_classes))
                bp = torch.gather(bp, 1, top[..., None].expand(-1, -1, 4))
                cn = torch.gather(cn, 1, top)
                pp = p[top]
            mlvl_boxes.append(distance2bbox(pp, bp, max_shape=max_shape))
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
