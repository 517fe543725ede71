"""Max-IoU and point assignment on fixed-size, masked inputs (counterpart
of ``swindet_tpu/core/bbox/assigners.py``: ``AssignResult`` :27,
``MaxIoUAssigner`` :34, ``add_gt_as_candidates`` :155, ``PointAssigner``
:176; reference mmdet/core/bbox/assigners/max_iou_assigner.py:10,
point_assigner.py).

Every candidate keeps its slot; gt boxes arrive padded to a static G with
a ``gt_valid`` mask, and invalid rows and columns are masked to -1
overlap. ``gt_inds``: -1 ignore, 0 negative, g + 1 assigned to gt g.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...registries import BBOX_ASSIGNERS
from .iou import bbox_overlaps


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor        # (N,) int32
    max_overlaps: torch.Tensor   # (N,) float
    labels: torch.Tensor         # (N,) int32, -1 where not positive


@BBOX_ASSIGNERS.register_module()
class MaxIoUAssigner:
    """Negatives below ``neg_iou_thr``, positives from ``pos_iou_thr``,
    then each gt claims its best candidates (``match_low_quality``), the
    last eligible gt winning as in the reference's in-order overwrite.
    Ignore regions (``ignore_iof_thr`` > 0) and one best candidate per gt
    (``gt_max_assign_all=False``) are not ported: the Swin detectors use
    neither."""

    def __init__(self, pos_iou_thr: float, neg_iou_thr: float,
                 min_pos_iou: float = 0., gt_max_assign_all: bool = True,
                 ignore_iof_thr: float = -1,
                 ignore_wrt_candidates: bool = True,
                 match_low_quality: bool = True, gpu_assign_thr: int = -1,
                 iou_calculator: Optional[dict] = None):
        if ignore_iof_thr > 0 or not gt_max_assign_all \
                or isinstance(neg_iou_thr, (tuple, list)):
            raise NotImplementedError('MaxIoUAssigner: ignore regions, '
                                      'gt_max_assign_all=False and negative '
                                      'ranges are not ported yet')
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.match_low_quality = match_low_quality

    def assign(self, bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
               gt_valid: torch.Tensor,
               gt_labels: Optional[torch.Tensor] = None,
               bbox_valid: Optional[torch.Tensor] = None) -> AssignResult:
        """bboxes (N, 4), gt_bboxes (G, 4), gt_valid (G,) bool, gt_labels
        (G,) or None, bbox_valid (N,) bool or None (invalid candidates
        stay at -1)."""
        n = bboxes.shape[0]
        g = gt_bboxes.shape[0]
        overlaps = bbox_overlaps(bboxes, gt_bboxes)
        overlaps = torch.where(gt_valid[None, :], overlaps, -1.0)
        if bbox_valid is not None:
            overlaps = torch.where(bbox_valid[:, None], overlaps, -1.0)
        floor = overlaps.new_full((n, 1), -1.0)
        max_overlaps, argmax_gt = torch.cat([overlaps, floor], 1).max(1)
        argmax_gt = torch.where(argmax_gt == g, 0, argmax_gt)

        gt_inds = torch.full((n,), -1, dtype=torch.int32,
                             device=bboxes.device)
        neg = (max_overlaps >= 0) & (max_overlaps < self.neg_iou_thr)
        gt_inds = torch.where(neg, 0, gt_inds)
        pos = max_overlaps >= self.pos_iou_thr
        gt_inds = torch.where(pos, (argmax_gt + 1).to(torch.int32), gt_inds)

        if self.match_low_quality:
            gt_max = torch.cat([overlaps, overlaps.new_full((1, g), -1.0)],
                               0).max(0).values
            eligible = ((overlaps == gt_max[None, :])
                        & (gt_max[None, :] >= self.min_pos_iou)
                        & (gt_max[None, :] > -1.0) & gt_valid[None, :])
            # last eligible gt wins (the reference's in-order overwrite)
            last_g = g - 1 - eligible.flip(1).to(torch.uint8).argmax(1)
            gt_inds = torch.where(eligible.any(1),
                                  (last_g + 1).to(torch.int32), gt_inds)

        if bbox_valid is not None:
            gt_inds = torch.where(bbox_valid, gt_inds, -1)
        if gt_labels is not None:
            safe = (gt_inds.long() - 1).clamp(min=0)
            labels = torch.where(gt_inds > 0, gt_labels.long()[safe], -1)
        else:
            labels = torch.full((n,), -1, device=bboxes.device)
        return AssignResult(gt_inds=gt_inds, max_overlaps=max_overlaps,
                            labels=labels.to(torch.int32))


def add_gt_as_candidates(assign_result: AssignResult, gt_valid: torch.Tensor,
                         gt_labels: Optional[torch.Tensor]) -> AssignResult:
    """Prepend the gt boxes, each assigned to itself, to an assignment
    over proposals (reference base_sampler.py + assign_result.add_gt_)."""
    g = gt_valid.shape[0]
    dev = gt_valid.device
    gt_self = torch.where(gt_valid, torch.arange(1, g + 1, dtype=torch.int32,
                                                 device=dev), -1)
    gt_ovr = torch.where(gt_valid, 1.0, -1.0).to(
        assign_result.max_overlaps.dtype)
    if gt_labels is None:
        gt_lab = torch.full((g,), -1, dtype=torch.int32, device=dev)
    else:
        gt_lab = torch.where(gt_valid, gt_labels.to(torch.int32), -1)
    return AssignResult(
        gt_inds=torch.cat([gt_self, assign_result.gt_inds.to(torch.int32)]),
        max_overlaps=torch.cat([gt_ovr, assign_result.max_overlaps]),
        labels=torch.cat([gt_lab, assign_result.labels.to(torch.int32)]))


@BBOX_ASSIGNERS.register_module()
class PointAssigner:
    """Each gt claims the ``pos_num`` points closest to its centre at its
    scale-matched pyramid level; where claims conflict, the closest
    claiming gt wins and a tie goes to the earlier gt (the reference's
    in-order loop overwrites only on a strictly smaller distance)."""

    def __init__(self, scale: int = 4, pos_num: int = 3):
        self.scale = scale
        self.pos_num = pos_num

    def assign(self, points: torch.Tensor, gt_bboxes: torch.Tensor,
               gt_valid: torch.Tensor,
               gt_labels: Optional[torch.Tensor] = None,
               bbox_valid: Optional[torch.Tensor] = None) -> AssignResult:
        """points (N, 3) ``[x, y, stride]``, gt_bboxes (G, 4) padded,
        gt_valid (G,) bool, gt_labels (G,) or None, bbox_valid (N,) bool
        or None (invalid points claim nothing)."""
        n = points.shape[0]
        px, py = points[:, 0], points[:, 1]
        lvl = torch.trunc(torch.log2(points[:, 2]))
        cx = (gt_bboxes[:, 0] + gt_bboxes[:, 2]) * 0.5
        cy = (gt_bboxes[:, 1] + gt_bboxes[:, 3]) * 0.5
        gw = (gt_bboxes[:, 2] - gt_bboxes[:, 0]).clamp(min=1e-6)
        gh = (gt_bboxes[:, 3] - gt_bboxes[:, 1]).clamp(min=1e-6)
        # the gt level: mean log2 size truncated toward zero (the
        # reference's `.int()`), clamped to the point levels
        gt_lvl = torch.trunc((torch.log2(gw / self.scale)
                              + torch.log2(gh / self.scale)) / 2)
        gt_lvl = torch.maximum(torch.minimum(gt_lvl, lvl.max()), lvl.min())
        # elliptical distance to the gt centre, per axis over its size
        dist = torch.sqrt(((px[:, None] - cx[None]) / gw[None]) ** 2
                          + ((py[:, None] - cy[None]) / gh[None]) ** 2)
        big = 1e8
        ok = ((lvl[:, None] - gt_lvl[None]).abs() < 0.5) & gt_valid[None]
        if bbox_valid is not None:
            ok = ok & bbox_valid[:, None]
        dist = torch.where(ok, dist, big)
        # a point's rank among a gt's points is its place in the stable
        # sort (the JAX package's double argsort): the first pos_num of
        # each column claim
        order = torch.argsort(dist, dim=0, stable=True)
        claims = torch.zeros_like(ok).scatter_(
            0, order[:self.pos_num], True) & (dist < big)
        win = torch.where(claims, dist, big).argmin(1)
        gt_inds = torch.where(claims.any(1), win + 1, 0).to(torch.int32)
        if gt_labels is not None:
            lab = gt_labels.long()[(gt_inds.long() - 1).clamp(min=0)]
            labels = torch.where(gt_inds > 0, lab, -1)
        else:
            labels = torch.full((n,), -1, device=points.device)
        return AssignResult(gt_inds=gt_inds,
                            max_overlaps=(gt_inds > 0).to(points.dtype),
                            labels=labels.to(torch.int32))
