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
               bbox_valid: Optional[torch.Tensor] = None,
               pos_iou_thr=None, neg_iou_thr=None,
               min_pos_iou=None) -> AssignResult:
        """bboxes (N, 4), gt_bboxes (G, 4), gt_valid (G,) bool, gt_labels
        (G,) or None, bbox_valid (N,) bool or None (invalid candidates
        stay at -1). ``pos_iou_thr``, ``neg_iou_thr`` and ``min_pos_iou``,
        floats or 0-d tensors (Dynamic R-CNN's adaptive threshold), take
        the place of the configured ones where given."""
        p_thr = self.pos_iou_thr if pos_iou_thr is None else pos_iou_thr
        n_thr = self.neg_iou_thr if neg_iou_thr is None else neg_iou_thr
        m_thr = self.min_pos_iou if min_pos_iou is None else min_pos_iou
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
        neg = (max_overlaps >= 0) & (max_overlaps < n_thr)
        gt_inds = torch.where(neg, 0, gt_inds)
        pos = max_overlaps >= p_thr
        gt_inds = torch.where(pos, (argmax_gt + 1).to(torch.int32), gt_inds)

        if self.match_low_quality:
            gt_max = torch.cat([overlaps, overlaps.new_full((1, g), -1.0)],
                               0).max(0).values
            eligible = ((overlaps == gt_max[None, :])
                        & (gt_max[None, :] >= m_thr)
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


def smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """The indices (G, k) of each row's ``k`` smallest entries of ``d``
    (G, N), ascending, the lower index first among equal entries: the
    order of ``jax.lax.top_k(-d, k)``. ``torch.topk`` leaves the order of
    ties unspecified, and on an anchor grid symmetric anchors sit at equal
    distance from a gt's centre, so it would pick other candidates."""
    return torch.sort(d, dim=1, stable=True).indices[:, :k]


@BBOX_ASSIGNERS.register_module()
class ATSSAssigner:
    """Adaptive Training Sample Selection over the full, level-concatenated
    anchor set. Each gt takes as candidates the ``topk`` anchors of each
    level whose centres lie closest to its centre (anchors outside
    ``bbox_valid`` or in an ignore region at +INF distance, and not
    candidates); its IoU threshold is the candidates' mean IoU plus their
    standard deviation (Bessel's, over the valid candidates); a candidate
    over the threshold whose centre lies inside the gt is positive. An
    anchor claimed by several gts takes the one of largest IoU, the first
    on a tie (``jnp.argmax``)."""

    INF = 1e8

    def __init__(self, topk: int, ignore_iof_thr: float = -1, **kwargs):
        self.topk = int(topk)
        self.ignore_iof_thr = ignore_iof_thr

    def assign(self, bboxes: torch.Tensor, num_level_bboxes,
               gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
               gt_labels: Optional[torch.Tensor] = None,
               bbox_valid: Optional[torch.Tensor] = None,
               gt_bboxes_ignore: Optional[torch.Tensor] = None,
               gt_ignore_valid: Optional[torch.Tensor] = None
               ) -> AssignResult:
        """bboxes (N, 4) concatenated over the levels of
        ``num_level_bboxes`` anchors each, gt_bboxes (G, 4) padded with
        gt_valid (G,), gt_labels (G,) or None, bbox_valid (N,) (the inside
        flags) or None; ignore regions (I, 4) with their validity (I,)
        take part where ``ignore_iof_thr`` > 0."""
        n, g = bboxes.shape[0], gt_bboxes.shape[0]
        dev = bboxes.device
        if bbox_valid is None:
            bbox_valid = torch.ones((n,), dtype=torch.bool, device=dev)
        overlaps = bbox_overlaps(bboxes, gt_bboxes)                 # (N, G)
        cx = (bboxes[:, 0] + bboxes[:, 2]) / 2.0
        cy = (bboxes[:, 1] + bboxes[:, 3]) / 2.0
        gcx = (gt_bboxes[:, 0] + gt_bboxes[:, 2]) / 2.0
        gcy = (gt_bboxes[:, 1] + gt_bboxes[:, 3]) / 2.0
        dist = torch.sqrt((cx[:, None] - gcx[None]) ** 2
                          + (cy[:, None] - gcy[None]) ** 2)        # (N, G)
        ignored = torch.zeros((n,), dtype=torch.bool, device=dev)
        if self.ignore_iof_thr > 0 and gt_bboxes_ignore is not None \
                and gt_ignore_valid is not None:
            iof = bbox_overlaps(bboxes, gt_bboxes_ignore, mode='iof')
            iof = torch.where(gt_ignore_valid[None], iof, 0.0)
            ignored = iof.amax(1) > self.ignore_iof_thr
        dist = torch.where((bbox_valid & ~ignored)[:, None], dist, self.INF)

        # each level's topk closest candidates of every gt: (K, G)
        cand_idx, start = [], 0
        for lvl_n in num_level_bboxes:
            k = min(self.topk, int(lvl_n))
            cand_idx.append(smallest_k(dist[start:start + lvl_n].T, k).T
                            + start)
            start += lvl_n
        cand_idx = torch.cat(cand_idx)
        cand_ok = torch.gather(dist, 0, cand_idx) < self.INF

        cand_ovr = torch.gather(overlaps, 0, cand_idx)
        cnt = cand_ok.sum(0).float().clamp(min=1.0)
        mean = torch.where(cand_ok, cand_ovr, 0.0).sum(0) / cnt
        var = torch.where(cand_ok, (cand_ovr - mean[None]) ** 2, 0.0) \
            .sum(0) / (cnt - 1.0).clamp(min=1.0)
        is_pos = cand_ovr >= (mean + torch.sqrt(var))[None]

        # the candidates' centres inside their gt
        ccx, ccy = cx[cand_idx], cy[cand_idx]
        in_gt = torch.minimum(
            torch.minimum(ccx - gt_bboxes[None, :, 0],
                          ccy - gt_bboxes[None, :, 1]),
            torch.minimum(gt_bboxes[None, :, 2] - ccx,
                          gt_bboxes[None, :, 3] - ccy)) > 0.01
        is_pos = is_pos & in_gt & cand_ok & gt_valid[None]

        pos_mask = torch.zeros((n, g), dtype=torch.uint8, device=dev) \
            .scatter_reduce(0, cand_idx, is_pos.to(torch.uint8), 'amax') \
            .bool()
        claimed = torch.where(pos_mask, overlaps, -self.INF)
        max_ovr, argmax = claimed.amax(1), claimed.argmax(1)
        has_pos = max_ovr > -self.INF
        gt_inds = torch.where(has_pos, argmax + 1, 0)
        gt_inds = torch.where(ignored | ~bbox_valid, -1, gt_inds)
        if gt_labels is not None:
            labels = torch.where(has_pos & bbox_valid,
                                 gt_labels.long()[argmax], -1)
        else:
            labels = torch.full((n,), -1, device=dev)
        return AssignResult(gt_inds=gt_inds.to(torch.int32),
                            max_overlaps=torch.where(has_pos, max_ovr, 0.0),
                            labels=labels.to(torch.int32))
