"""Box coding (counterpart of ``swindet_tpu/core/bbox/coders.py``:
``bbox2delta`` :21, ``delta2bbox`` :49, ``distance2bbox`` :94,
``bbox2distance`` :111, ``DeltaXYWHBBoxCoder`` :126)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ...registries import BBOX_CODERS


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.),
               eps: float = 1e-6) -> torch.Tensor:
    """Encode gt boxes as (dx, dy, dw, dh) deltas w.r.t. proposals, both
    (..., 4); widths and heights are clamped at ``eps``."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=eps)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=eps)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw.clamp(min=eps) / pw),
                          torch.log(gh.clamp(min=eps) / ph)], dim=-1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.),
               max_shape: Optional[torch.Tensor] = None,
               wh_ratio_clip: float = 16 / 1000,
               clip_border: bool = True) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas on top of rois.

    rois (..., 4); deltas (..., 4k) -> boxes (..., 4k). ``max_shape`` is a
    (..., 2) tensor of (H, W) broadcastable against rois' leading dims, or
    None."""
    k = deltas.shape[-1] // 4
    means_t = deltas.new_tensor(means)
    stds_t = deltas.new_tensor(stds)
    d = deltas.reshape(deltas.shape[:-1] + (k, 4)) * stds_t + means_t
    dx, dy, dw, dh = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)

    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1 = gx - gw * 0.5
    y1 = gy - gh * 0.5
    x2 = gx + gw * 0.5
    y2 = gy + gh * 0.5
    if clip_border and max_shape is not None:
        h = max_shape[..., 0:1].to(x1.dtype)
        w = max_shape[..., 1:2].to(x1.dtype)
        x1 = torch.minimum(x1.clamp(min=0), w)
        y1 = torch.minimum(y1.clamp(min=0), h)
        x2 = torch.minimum(x2.clamp(min=0), w)
        y2 = torch.minimum(y2.clamp(min=0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(deltas.shape)


def distance2bbox(points: torch.Tensor, distance: torch.Tensor,
                  max_shape: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boxes from points (..., 2) and their (left, top, right, bottom)
    distances (..., 4), each coordinate clipped to [0, W] or [0, H] of
    ``max_shape`` ((..., 2) (H, W), broadcastable against the points'
    leading dims) where given."""
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        h = max_shape[..., 0].to(x1.dtype)
        w = max_shape[..., 1].to(x1.dtype)
        x1 = torch.minimum(x1.clamp(min=0), w)
        y1 = torch.minimum(y1.clamp(min=0), h)
        x2 = torch.minimum(x2.clamp(min=0), w)
        y2 = torch.minimum(y2.clamp(min=0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox2distance(points: torch.Tensor, bbox: torch.Tensor,
                  max_dis: Optional[float] = None,
                  eps: float = 0.1) -> torch.Tensor:
    """The (left, top, right, bottom) distances (..., 4) from points
    (..., 2) to boxes (..., 4), clipped to [0, ``max_dis`` - ``eps``]
    where ``max_dis`` is given (GFL's DFL targets, in bins)."""
    d = torch.stack([points[..., 0] - bbox[..., 0],
                     points[..., 1] - bbox[..., 1],
                     bbox[..., 2] - points[..., 0],
                     bbox[..., 3] - points[..., 1]], dim=-1)
    if max_dis is not None:
        d = d.clamp(0, max_dis - eps)
    return d


@BBOX_CODERS.register_module()
class DeltaXYWHBBoxCoder:
    """(dx, dy, dw, dh) coder with mean / std normalisation (reference
    delta_xywh_bbox_coder.py:10)."""

    def __init__(self, target_means=(0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1.), clip_border: bool = True):
        self.means = tuple(target_means)
        self.stds = tuple(target_stds)
        self.clip_border = clip_border

    def encode(self, bboxes, gt_bboxes):
        return bbox2delta(bboxes, gt_bboxes, self.means, self.stds)

    def decode(self, bboxes, pred_bboxes, max_shape=None,
               wh_ratio_clip=16 / 1000):
        return delta2bbox(bboxes, pred_bboxes, self.means, self.stds,
                          max_shape, wh_ratio_clip, self.clip_border)
