"""Box overlaps (counterpart of ``swindet_tpu/core/bbox/iou.py:18``: its
'iou' mode, the one the max-IoU assigner uses, pairwise or aligned, and
its aligned 'giou' mode, the one ``GIoULoss`` uses; reference
mmdet/core/bbox/iou_calculators/iou2d_calculator.py:43). Boxes are
(x1, y1, x2, y2) with widths ``x2 - x1``."""
from __future__ import annotations

import torch


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def clamp_min(x: torch.Tensor, lo: float) -> torch.Tensor:
    """max(x, lo) with ``jnp.clip``'s gradient: half where x == lo (a
    degenerate box, as FCOS's ReLU'd distances give), where
    ``torch.clamp`` passes all of it."""
    return torch.maximum(x, x.new_tensor(lo))


def bbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                  eps: float = 1e-6, mode: str = 'iou',
                  is_aligned: bool = False) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) -> (..., M, N) overlaps, or with
    ``is_aligned`` (M == N) the (..., M) overlaps of each pair. The union,
    and for 'giou' the enclosing box's area, are clamped at ``eps``, so
    empty boxes give 0 IoU; every clamp has ``jnp.clip``'s gradient
    (:func:`clamp_min`)."""
    if mode not in ('iou', 'giou'):
        raise ValueError(f'bbox_overlaps: mode {mode}')
    area1, area2 = bbox_area(bboxes1), bbox_area(bboxes2)
    if is_aligned:
        b1, b2 = bboxes1, bboxes2
    else:
        b1, b2 = bboxes1[..., :, None, :], bboxes2[..., None, :, :]
        area1, area2 = area1[..., :, None], area2[..., None, :]
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = clamp_min(rb - lt, 0.0)
    overlap = wh[..., 0] * wh[..., 1]
    union = clamp_min(area1 + area2 - overlap, eps)
    ious = overlap / union
    if mode == 'iou':
        return ious
    # GIoU: less the share of the smallest enclosing box outside the union
    enclose = clamp_min(torch.maximum(b1[..., 2:], b2[..., 2:])
                        - torch.minimum(b1[..., :2], b2[..., :2]), 0.0)
    enclose_area = clamp_min(enclose[..., 0] * enclose[..., 1], eps)
    return ious - (enclose_area - union) / enclose_area
