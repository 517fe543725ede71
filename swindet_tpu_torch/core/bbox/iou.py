"""Pairwise IoU (counterpart of ``swindet_tpu/core/bbox/iou.py:18`` in its
'iou' mode, the one the max-IoU assigner uses; reference
mmdet/core/bbox/iou_calculators/iou2d_calculator.py:43). Boxes are
(x1, y1, x2, y2) with widths ``x2 - x1``."""
from __future__ import annotations

import torch


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def bbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) -> (..., M, N) IoU; the union is clamped
    at ``eps``, so empty boxes give 0."""
    area1 = bbox_area(bboxes1)[..., :, None]
    area2 = bbox_area(bboxes2)[..., None, :]
    lt = torch.maximum(bboxes1[..., :, None, :2], bboxes2[..., None, :, :2])
    rb = torch.minimum(bboxes1[..., :, None, 2:], bboxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    return overlap / (area1 + area2 - overlap).clamp(min=eps)
