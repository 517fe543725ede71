"""Exact greedy NMS over padded, batched inputs (counterpart of
``swindet_tpu/core/nms.py``: ``fast_topk`` :42, ``nms`` :98,
``batched_nms`` :215, ``multiclass_nms`` :244).

Keep set and keep order equal the JAX package's. Ties sort as there: a
stable sort on the negated score (``jnp.argsort``) and lower index first
among equal scores (``lax.top_k``). Every output is a fixed number of
slots plus a validity mask.

The greedy scan itself is ``ops/nms.py:nms_sorted``: the hand-written
kernel on the card, the plain IoU matrix and Jacobi sweeps on the CPU.
The stable sort that fixes the tie order stays here, outside the kernel,
as the JAX package sorts before ``nms_pallas_sorted``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.nms import nms_sorted


class NMSResult(NamedTuple):
    dets: torch.Tensor    # (B, max_out, 5) x1, y1, x2, y2, score
    inds: torch.Tensor    # (B, max_out) int64 index into the inputs
    valid: torch.Tensor   # (B, max_out) bool


class MulticlassNMSResult(NamedTuple):
    dets: torch.Tensor    # (B, max_per_img, 5)
    labels: torch.Tensor  # (B, max_per_img) int64
    inds: torch.Tensor    # (B, max_per_img) index into the N boxes
    valid: torch.Tensor   # (B, max_per_img) bool


def fast_topk(scores: torch.Tensor, k: int):
    """Exact top-k over the last axis, descending, lower index first among
    ties (``jax.lax.top_k``)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, valid: Optional[torch.Tensor] = None) -> NMSResult:
    """Greedy NMS of boxes (B, N, 4) by scores (B, N) among ``valid``
    (B, N); keeps at most ``max_out`` per image, in score order. Every
    valid candidate must carry a finite score."""
    b, n = scores.shape
    dev = scores.device
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    score = torch.where(valid, scores, -torch.inf)
    order = torch.sort(-score, dim=1, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
    score_s = torch.gather(score, 1, order)
    valid_s = torch.gather(valid, 1, order)
    dets, inds, count = nms_sorted(boxes_s, score_s, valid_s, order,
                                   iou_threshold, max_out)
    out_valid = torch.arange(max_out, device=dev)[None] < count[:, None]
    return NMSResult(dets=dets, inds=inds, valid=out_valid)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                idxs: torch.Tensor, iou_threshold: float, max_out: int,
                valid: Optional[torch.Tensor] = None) -> NMSResult:
    """NMS where boxes of different ``idxs`` never suppress each other
    (the class-offset trick of the reference's batched_nms)."""
    sel = boxes if valid is None else torch.where(valid[..., None], boxes,
                                                  0.0)
    max_coord = sel.amax(dim=(1, 2))
    offsets = idxs.to(boxes.dtype) * (max_coord[:, None] + 1.0)
    res = nms(boxes + offsets[..., None], scores, iou_threshold, max_out,
              valid)
    kept_off = torch.gather(offsets, 1, res.inds)
    dets_boxes = res.dets[..., :4] - torch.where(res.valid, kept_off,
                                                 0.0)[..., None]
    dets = torch.cat([dets_boxes, res.dets[..., 4:]], dim=-1)
    dets = torch.where(res.valid[..., None], dets, 0.0)
    return NMSResult(dets=dets, inds=res.inds, valid=res.valid)


def multiclass_nms(multi_bboxes: torch.Tensor, multi_scores: torch.Tensor,
                   score_thr: float, nms_cfg: dict, max_per_img: int = -1,
                   valid: Optional[torch.Tensor] = None,
                   pre_nms_cap: int = 2048,
                   score_factors: Optional[torch.Tensor] = None
                   ) -> MulticlassNMSResult:
    """Class-aware NMS over (B, N, #cls*4 or 4) boxes and (B, N, #cls+1)
    scores, the last score column being background. ``score_factors``
    (B, N) multiply each box's class scores first (FCOS's centerness).
    Candidates over ``score_thr``; the top ``pre_nms_cap`` (box, class)
    pairs enter one batched NMS."""
    b, n = multi_scores.shape[:2]
    num_classes = multi_scores.shape[2] - 1
    scores = multi_scores[..., :-1]
    if score_factors is not None:
        scores = scores * score_factors[..., None]
    if multi_bboxes.shape[-1] > 4:
        bboxes = multi_bboxes.reshape(b, n, num_classes, 4)
    else:
        bboxes = multi_bboxes[:, :, None, :].expand(b, n, num_classes, 4)
    cand = scores > score_thr
    if valid is not None:
        cand = cand & valid[..., None]
    flat_scores = torch.where(cand, scores, -torch.inf).reshape(b, -1)
    cap = min(pre_nms_cap, flat_scores.shape[1])
    top_scores, top_idx = fast_topk(flat_scores, cap)
    top_box_idx = top_idx // num_classes
    top_cls = top_idx % num_classes
    top_boxes = torch.gather(bboxes.reshape(b, -1, 4), 1,
                             top_idx[..., None].expand(-1, -1, 4))
    top_valid = top_scores > -torch.inf
    max_out = max_per_img if max_per_img > 0 else cap
    res = batched_nms(top_boxes, top_scores, top_cls,
                      nms_cfg['iou_threshold'], max_out, valid=top_valid)
    labels = torch.where(res.valid, torch.gather(top_cls, 1, res.inds), 0)
    box_inds = torch.where(res.valid,
                           torch.gather(top_box_idx, 1, res.inds), 0)
    return MulticlassNMSResult(dets=res.dets, labels=labels, inds=box_inds,
                               valid=res.valid)
