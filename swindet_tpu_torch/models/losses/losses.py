"""Detection losses with elementwise weights, fp32 accumulation and
tensor ``avg_factor``s (counterpart of
``swindet_tpu/models/losses/losses.py``: ``weight_reduce_loss`` :20,
``CrossEntropyLoss`` :47, ``FocalLoss`` :94, ``L1Loss`` :126,
``SmoothL1Loss`` :141, ``GIoULoss`` :190, ``accuracy`` :280; reference
mmdet/models/losses/cross_entropy_loss.py, focal_loss.py, smooth_l1_loss.py,
iou_loss.py). Padded entries carry weight 0."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...core.bbox.iou import bbox_overlaps
from ...registries import LOSSES


def weight_reduce_loss(loss: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = 'mean',
                       avg_factor: Optional[torch.Tensor] = None):
    """Elementwise weight, then reduce; with ``avg_factor`` the sum over
    ``avg_factor`` (reference mmdet/models/losses/utils.py)."""
    if weight is not None:
        loss = loss * weight
    if reduction == 'none':
        return loss
    if reduction == 'sum':
        return loss.sum()
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / torch.clamp(torch.as_tensor(avg_factor), min=1e-12)


def _expand_onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """labels in [0, C) -> one-hot (N, C); background (C) or ignore (< 0)
    -> all-zero rows."""
    valid = (labels >= 0) & (labels < num_classes)
    oh = F.one_hot(torch.where(valid, labels, 0).long(), num_classes)
    return torch.where(valid[..., None], oh.float(), 0.0)


def _bce_with_logits(logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * targets \
        + torch.log1p(torch.exp(-logits.abs()))


@LOSSES.register_module()
class CrossEntropyLoss:
    """Softmax CE, sigmoid BCE (``use_sigmoid``) or per-roi mask BCE
    (``use_mask``: pred (N, H, W) logits of the target class, label the
    binary targets, averaged over pixels per roi)."""

    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = 'mean', class_weight=None,
                 loss_weight: float = 1.0):
        if class_weight is not None:
            raise NotImplementedError('CrossEntropyLoss: class_weight is '
                                      'not ported yet')
        self.use_sigmoid = use_sigmoid
        self.use_mask = use_mask
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, label, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        pred = pred.float()
        if self.use_mask:
            loss = _bce_with_logits(pred, label.float())
            loss = loss.mean(dim=tuple(range(1, loss.ndim)))
        elif self.use_sigmoid:
            if pred.ndim > 1 and label.ndim == pred.ndim - 1:
                target = _expand_onehot(label, pred.shape[-1])
            else:
                target = label.float()
            loss = _bce_with_logits(pred, target)
            if weight is not None and weight.ndim < loss.ndim:
                weight = weight[..., None]
        else:
            logp = torch.log_softmax(pred, dim=-1)
            safe = label.long().clamp(0, pred.shape[-1] - 1)
            loss = -logp.gather(-1, safe[..., None])[..., 0]
            loss = torch.where(label >= 0, loss, 0.0)
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)


@LOSSES.register_module()
class FocalLoss:
    """Sigmoid focal loss in fp32 (reference focal_loss.py
    py_sigmoid_focal_loss, the spec of its CUDA kernel): BCE scaled by
    (alpha t + (1 - alpha)(1 - t)) |t - p|^gamma. Integer labels one-hot
    over the classes, the background label (C) to an all-zero row; an
    (N,) weight is broadcast over the classes."""

    def __init__(self, use_sigmoid: bool = True, gamma: float = 2.0,
                 alpha: float = 0.25, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        if not use_sigmoid:
            raise NotImplementedError('FocalLoss: only the sigmoid focal '
                                      'loss is ported')
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        pred = pred.float()
        if target.ndim == pred.ndim - 1:
            target = _expand_onehot(target, pred.shape[-1])
        target = target.float()
        p = torch.sigmoid(pred)
        pt = (1 - p) * target + p * (1 - target)
        focal_weight = (self.alpha * target + (1 - self.alpha)
                        * (1 - target)) * pt.pow(self.gamma)
        loss = _bce_with_logits(pred, target) * focal_weight
        if weight is not None and weight.ndim < loss.ndim:
            weight = weight[..., None]
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)


@LOSSES.register_module()
class L1Loss:

    def __init__(self, reduction: str = 'mean', loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        loss = (pred.float() - target.float()).abs()
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)


@LOSSES.register_module()
class SmoothL1Loss:
    """0.5 d^2 / beta where |d| < beta, else |d| - 0.5 beta."""

    def __init__(self, beta: float = 1.0, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        b = self.beta
        diff = (pred.float() - target.float()).abs()
        loss = torch.where(diff < b, 0.5 * diff * diff / b, diff - 0.5 * b)
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)


@LOSSES.register_module()
class GIoULoss:
    """1 - GIoU of aligned (N, 4) boxes; an (N, 4) weight is averaged over
    its last axis (the cascade Swin configs' box loss, weight 10)."""

    def __init__(self, eps: float = 1e-7, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        loss = 1 - bbox_overlaps(pred.float(), target.float(), eps=self.eps,
                                 mode='giou', is_aligned=True)
        if weight is not None and weight.ndim == loss.ndim + 1:
            weight = weight.mean(-1)
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)


def accuracy(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-1 accuracy in percent, over the entries of ``mask`` if
    given."""
    correct = (pred.argmax(-1) == target).float()
    if mask is not None:
        return (correct * mask).sum() / mask.sum().clamp(min=1.0) * 100
    return correct.mean() * 100
