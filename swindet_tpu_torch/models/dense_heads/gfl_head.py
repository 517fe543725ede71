"""GFL head (counterpart of ``swindet_tpu/models/dense_heads/gfl_head.py``:
``integral`` :27, ``GFLHead`` :38 with ``forward_single`` :75,
``_gfl_target_single`` :97, ``loss`` :124, ``get_bboxes`` :189; reference
mmdet/models/dense_heads/gfl_head.py:53, arXiv:2006.04388).

ATSS's towers and assignment; the class scores are joint class-quality
scores (QualityFocalLoss toward the IoU of the decoded box), and each box
side is a distribution over ``reg_max + 1`` distance bins (in strides),
read out as its softmax's expectation (:class:`Integral`) and trained by
the GIoU of the decoded box and DistributionFocalLoss toward the gt's
distances, both weighted by the detached best class score. One stride
vector over the concatenated anchors replaces the reference's per-level
loss loop. The targets are the raw gt boxes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..builder import build_loss
from ..layers import conv_nhwc
from ...core.bbox.coders import bbox2distance, distance2bbox
from ...core.bbox.iou import bbox_overlaps
from ...core.nms import fast_topk, multiclass_nms
from ...registries import HEADS
from .atss_head import ATSSHead, conv_towers
from .fcos_head import Scale


class Integral(nn.Module):
    """The expected bin of each side's softmax over ``reg_max + 1`` bins:
    (..., 4 (reg_max + 1)) -> (..., 4), in fp32. ``project`` is mmdet's
    buffer of the bins 0..reg_max, kept so that a released GFL checkpoint
    loads strictly."""

    def __init__(self, reg_max: int = 16):
        super().__init__()
        self.reg_max = reg_max
        self.register_buffer('project', torch.linspace(0, reg_max,
                                                       reg_max + 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.softmax(x.float().reshape(*x.shape[:-1], 4,
                                            self.reg_max + 1), -1)
        return (p * self.project).sum(-1)


def anchor_center(anchors: torch.Tensor) -> torch.Tensor:
    return torch.stack([(anchors[..., 0] + anchors[..., 2]) / 2,
                        (anchors[..., 1] + anchors[..., 3]) / 2], -1)


@HEADS.register_module()
class GFLHead(ATSSHead):

    def __init__(self, num_classes: int, in_channels: int,
                 stacked_convs: int = 4, conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None, reg_max: int = 16,
                 loss_dfl: Optional[dict] = None, **kwargs):
        self.reg_max = reg_max
        super().__init__(num_classes, in_channels, stacked_convs, conv_cfg,
                         norm_cfg, **kwargs)
        # GFL has no centerness branch and no centerness loss
        del self.loss_centerness
        self.loss_dfl = build_loss(dict(loss_dfl or dict(
            type='DistributionFocalLoss', loss_weight=0.25)))

    def _init_layers(self):
        self.cls_convs, self.reg_convs = conv_towers(
            self.in_channels, self.feat_channels, self.stacked_convs,
            self.norm_cfg, self.compute_dtype)
        self.gfl_cls = nn.Conv2d(self.feat_channels, self.cls_out_channels,
                                 3, padding=1)
        self.gfl_reg = nn.Conv2d(self.feat_channels, 4 * (self.reg_max + 1),
                                 3, padding=1)
        self.scales = nn.ModuleList(
            [Scale(1.0) for _ in self.prior_generator.strides])
        self.integral = Integral(self.reg_max)

    def _outputs(self):
        return self.gfl_cls, self.gfl_reg

    def forward_single(self, x: torch.Tensor, lvl: int):
        """One level: class-quality logits (B, H, W, C) and scaled bin
        logits (B, H, W, 4 (reg_max + 1)) in fp32."""
        d = self.compute_dtype
        cls_feat, reg_feat = self._tower_feats(x)
        return (conv_nhwc(cls_feat, self.gfl_cls, False, d, False),
                self.scales[lvl](conv_nhwc(reg_feat, self.gfl_reg, False, d,
                                           False).float()))

    def _strides(self):
        return [s[0] if isinstance(s, (tuple, list)) else s
                for s in self.prior_generator.strides]

    # --------------------------------------------------------------- loss
    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_valid, gt_labels,
             img_shapes, pad_shapes) -> Dict[str, torch.Tensor]:
        """loss_cls (QFL toward the detached IoU of each positive's decoded
        box, over the positives), loss_bbox (GIoU in strides) and loss_dfl
        (over the four sides), both weighted by the detached best class
        score of each positive and divided by its sum (four times it for
        the DFL)."""
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        flat, labels, label_weights, pos, bbox_t = self.atss_targets(
            featmap_sizes, gt_bboxes, gt_valid, gt_labels, img_shapes,
            pad_shapes)
        dev = flat.device
        strides = torch.cat([torch.full((h * w,), float(s), device=dev)
                             for (h, w), s in zip(featmap_sizes,
                                                  self._strides())])
        b, c, n_bins = gt_bboxes.shape[0], self.cls_out_channels, \
            self.reg_max + 1
        cls_flat = torch.cat([s.reshape(b, -1, c) for s in cls_scores], 1)
        box_flat = torch.cat([p.reshape(b, -1, 4 * n_bins)
                              for p in bbox_preds], 1)
        centers = (anchor_center(flat) / strides[:, None])[None] \
            .expand(b, -1, -1)
        decoded = distance2bbox(centers, self.integral(box_flat))
        decoded_t = bbox_t / strides[None, :, None]
        score = torch.where(pos, bbox_overlaps(
            decoded.detach(), decoded_t, is_aligned=True), 0.0)
        weight_t = torch.where(
            pos, torch.sigmoid(cls_flat.detach().float()).amax(-1), 0.0)
        num_total = pos.sum().float().clamp(min=1.0)
        loss_cls = self.loss_cls(
            cls_flat.reshape(-1, c), (labels.reshape(-1), score.reshape(-1)),
            weight=label_weights.reshape(-1), avg_factor=num_total)
        avg = weight_t.sum().clamp(min=1e-6)
        loss_bbox = self.loss_bbox(
            decoded.reshape(-1, 4), decoded_t.reshape(-1, 4),
            weight=weight_t.reshape(-1), avg_factor=avg)
        target_corners = bbox2distance(centers, decoded_t,
                                       max_dis=self.reg_max)
        loss_dfl = self.loss_dfl(
            box_flat.reshape(-1, n_bins), target_corners.reshape(-1),
            weight=weight_t[..., None].expand(-1, -1, 4).reshape(-1),
            avg_factor=4.0 * avg)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_dfl=loss_dfl)

    # -------------------------------------------------------------- boxes
    def get_bboxes(self, cls_scores, bbox_preds, img_shapes, scale_factors,
                   cfg=None, rescale: bool = True, with_nms: bool = True):
        """Per level the top ``nms_pre`` anchors by their best class score,
        each side the bins' expectation times the level's stride from the
        anchor's centre, clipped to the image, divided by the scale factor
        with ``rescale``; then the multiclass NMS, or with
        ``with_nms=False`` the candidates (boxes (B, P, 4), scores (B, P,
        C + 1) with a zero background column)."""
        cfg = dict(cfg or self.test_cfg)
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_generator.grid_anchors(featmap_sizes,
                                                    cls_scores[0].device)
        nms_pre = cfg.get('nms_pre', -1)
        b, c = cls_scores[0].shape[0], self.cls_out_channels
        width = 4 * (self.reg_max + 1)
        max_shape = img_shapes[:, None, :]
        mlvl_boxes, mlvl_scores = [], []
        for a, stride, sc, bp in zip(anchors, self._strides(), cls_scores,
                                     bbox_preds):
            sc = torch.sigmoid(sc.reshape(b, -1, c).float())
            bp = bp.reshape(b, -1, width)
            a = a[None].expand(b, -1, -1)
            if 0 < nms_pre < sc.shape[1]:
                _, top = fast_topk(sc.amax(-1), nms_pre)
                sc = torch.gather(sc, 1, top[..., None].expand(-1, -1, c))
                bp = torch.gather(bp, 1, top[..., None].expand(-1, -1,
                                                                width))
                a = torch.gather(a, 1, top[..., None].expand(-1, -1, 4))
            dist = self.integral(bp) * float(stride)
            mlvl_boxes.append(distance2bbox(anchor_center(a), dist,
                                            max_shape=max_shape))
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
