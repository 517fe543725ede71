"""Max-IoU assignment on fixed-size, masked inputs (counterpart of
``swindet_tpu/core/bbox/assigners.py``: ``AssignResult`` :27,
``MaxIoUAssigner`` :34, ``add_gt_as_candidates`` :155; reference
mmdet/core/bbox/assigners/max_iou_assigner.py:10).

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
