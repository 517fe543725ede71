"""Positive / negative sampling into fixed slots (counterpart of
``swindet_tpu/core/bbox/samplers.py``: ``SamplingResult`` :21,
``_ranked_select`` :47, ``RandomSampler`` :68, ``PseudoSampler`` :185;
reference mmdet/core/bbox/samplers/random_sampler.py:8,
pseudo_sampler.py).

Every candidate gets a uniform key; each class (positive, negative) takes
its top keys up to the expected count. The ``num`` slots hold the
positives first, then the negatives, then filler slots whose indices are
distinct and out of range (``valid`` False). Slots follow the key rank
inside each class; the JAX package shuffles them with extra noise
(:151), which orders slots only, and every loss is a sum or a masked mean
over slots. Counts stay tensors: nothing here reads back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ...registries import BBOX_SAMPLERS
from .assigners import AssignResult, add_gt_as_candidates


class SamplingResult(NamedTuple):
    """``num`` candidate slots. ``inds`` index the candidate set
    (gt-prepended with ``add_gt_as_proposals``), out of range where
    ``valid`` is False; ``bboxes`` of such slots repeat the last
    candidate (the JAX package's gather fills them with NaN); the
    ``pos_gt_*`` fields are 0 / -1 outside positives."""
    inds: torch.Tensor
    valid: torch.Tensor
    is_pos: torch.Tensor
    bboxes: torch.Tensor
    pos_gt_bboxes: torch.Tensor
    pos_gt_labels: torch.Tensor
    pos_gt_inds: torch.Tensor
    num_pos: torch.Tensor
    num_neg: torch.Tensor


def ranked_select(mask: torch.Tensor, keys: torch.Tensor,
                  expected, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``cap`` entries of ``mask`` by descending key and which of
    them are taken (the first ``expected``, a tensor or an int, that lie
    in ``mask``): (top_idx (cap,), taken (cap,))."""
    score = torch.where(mask, keys, -torch.inf)
    cap = min(cap, mask.shape[0])
    top_idx = torch.topk(score, cap).indices
    rank = torch.arange(cap, device=mask.device)
    return top_idx, (rank < expected) & mask[top_idx]


@BBOX_SAMPLERS.register_module()
class RandomSampler:
    """Uniform random positive / negative sampling."""

    def __init__(self, num: int, pos_fraction: float,
                 neg_pos_ub: int = -1, add_gt_as_proposals: bool = True,
                 **kwargs):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals

    def sample(self, assign_result: AssignResult, bboxes: torch.Tensor,
               gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
               gt_labels: Optional[torch.Tensor] = None,
               bbox_valid: Optional[torch.Tensor] = None,
               gen: Optional[torch.Generator] = None,
               keys: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> SamplingResult:
        """Sample ``num`` slots from bboxes (P, 4), with the gt boxes
        prepended as trivially positive candidates when
        ``add_gt_as_proposals``. The selection keys are uniform draws from
        ``gen`` (a generator on the data's device), or ``keys`` =
        (keys_pos, keys_neg), one per candidate, given by the caller."""
        if self.add_gt_as_proposals:
            assign_result = add_gt_as_candidates(assign_result, gt_valid,
                                                 gt_labels)
            cand_boxes = torch.cat([gt_bboxes[:, :4], bboxes[:, :4]])
        else:
            cand_boxes = bboxes[:, :4]
        n = cand_boxes.shape[0]
        dev = cand_boxes.device
        gt_inds = assign_result.gt_inds
        pos_mask = gt_inds > 0
        neg_mask = gt_inds == 0
        if bbox_valid is not None:
            full_valid = bbox_valid
            if self.add_gt_as_proposals:
                full_valid = torch.cat([torch.ones(
                    n - bbox_valid.shape[0], dtype=torch.bool, device=dev),
                    bbox_valid])
            pos_mask = pos_mask & full_valid
            neg_mask = neg_mask & full_valid
        if keys is None:
            keys = (torch.rand(n, generator=gen, device=dev),
                    torch.rand(n, generator=gen, device=dev))
        keys_pos, keys_neg = keys

        pos_idx, pos_taken = ranked_select(
            pos_mask, keys_pos, int(self.num * self.pos_fraction), self.num)
        num_pos = pos_taken.sum().to(torch.int32)
        expected_neg = self.num - num_pos
        if self.neg_pos_ub >= 0:
            expected_neg = torch.minimum(
                expected_neg, num_pos.clamp(min=1) * self.neg_pos_ub)
        neg_idx, neg_taken = ranked_select(neg_mask, keys_neg, expected_neg,
                                           self.num)
        num_neg = neg_taken.sum().to(torch.int32)

        # pack: positives first, then negatives, each in key rank order
        cand_idx = torch.cat([pos_idx, neg_idx])
        taken = torch.cat([pos_taken, neg_taken])
        is_pos_entry = torch.arange(cand_idx.shape[0], device=dev) \
            < pos_idx.shape[0]
        short = self.num - cand_idx.shape[0]
        if short > 0:
            cand_idx = torch.cat([cand_idx, cand_idx.new_zeros(short)])
            taken = torch.cat([taken, taken.new_zeros(short)])
            is_pos_entry = torch.cat([is_pos_entry,
                                      is_pos_entry.new_zeros(short)])
        flags = torch.where(taken, torch.where(is_pos_entry, 2, 1), 0)
        order = torch.sort(flags, descending=True, stable=True) \
            .indices[:self.num]
        slot_taken = taken[order]
        slot_pos = slot_taken & is_pos_entry[order]
        filler = n + torch.arange(self.num, device=dev)
        inds = torch.where(slot_taken, cand_idx[order], filler)
        safe = inds.clamp(max=n - 1)

        slot_gt = gt_inds[safe]
        pos_gt_inds = torch.where(slot_pos, (slot_gt.long() - 1).clamp(min=0),
                                  0)
        pos_gt_bboxes = torch.where(slot_pos[:, None],
                                    gt_bboxes[pos_gt_inds, :4], 0.0)
        if gt_labels is not None:
            pos_gt_labels = torch.where(slot_pos,
                                        gt_labels.long()[pos_gt_inds], -1)
        else:
            pos_gt_labels = torch.full((self.num,), -1, device=dev)
        return SamplingResult(
            inds=inds.to(torch.int32), valid=slot_taken, is_pos=slot_pos,
            bboxes=cand_boxes[safe], pos_gt_bboxes=pos_gt_bboxes,
            pos_gt_labels=pos_gt_labels.to(torch.int32),
            pos_gt_inds=pos_gt_inds.to(torch.int32), num_pos=num_pos,
            num_neg=num_neg)


@BBOX_SAMPLERS.register_module()
class PseudoSampler:
    """No sampling (counterpart of ``swindet_tpu/core/bbox/samplers.py:185``;
    reference pseudo_sampler.py): every positive and every negative is
    kept in place, as full-set masks over the N candidates rather than
    packed slots. ``inds`` is the identity; ``valid`` the kept ones."""

    def __init__(self, **kwargs):
        pass

    def sample(self, assign_result: AssignResult, bboxes: torch.Tensor,
               gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
               gt_labels: Optional[torch.Tensor] = None,
               bbox_valid: Optional[torch.Tensor] = None,
               gen: Optional[torch.Generator] = None,
               keys=None) -> SamplingResult:
        """``gen`` and ``keys`` are taken and unused: nothing is drawn."""
        n = bboxes.shape[0]
        gt_inds = assign_result.gt_inds
        pos_mask = gt_inds > 0
        neg_mask = gt_inds == 0
        if bbox_valid is not None:
            pos_mask = pos_mask & bbox_valid
            neg_mask = neg_mask & bbox_valid
        pos_gt_inds = torch.where(pos_mask, (gt_inds.long() - 1).clamp(min=0),
                                  0)
        pos_gt_bboxes = torch.where(pos_mask[:, None],
                                    gt_bboxes[pos_gt_inds, :4], 0.0)
        if gt_labels is not None:
            labels = torch.where(pos_mask, gt_labels.long()[pos_gt_inds], -1)
        else:
            labels = torch.full((n,), -1, device=bboxes.device)
        return SamplingResult(
            inds=torch.arange(n, dtype=torch.int32, device=bboxes.device),
            valid=pos_mask | neg_mask, is_pos=pos_mask,
            bboxes=bboxes[:, :4], pos_gt_bboxes=pos_gt_bboxes,
            pos_gt_labels=labels.to(torch.int32),
            pos_gt_inds=pos_gt_inds.to(torch.int32),
            num_pos=pos_mask.sum().to(torch.int32),
            num_neg=neg_mask.sum().to(torch.int32))
