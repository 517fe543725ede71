"""Detection losses with elementwise weights, fp32 accumulation and
tensor ``avg_factor``s (counterpart of
``swindet_tpu/models/losses/losses.py``: ``weight_reduce_loss`` :20,
``CrossEntropyLoss`` :47, ``FocalLoss`` :94, ``L1Loss`` :126,
``SmoothL1Loss`` :141, ``IoULoss`` :160, ``GIoULoss`` :190,
``QualityFocalLoss`` :214, ``DistributionFocalLoss`` :252, ``accuracy``
:280, ``VarifocalLoss`` :450, ``KnowledgeDistillationKLDivLoss`` :595;
reference mmdet/models/losses/cross_entropy_loss.py, focal_loss.py,
smooth_l1_loss.py, iou_loss.py, gfocal_loss.py, varifocal_loss.py,
kd_loss.py). Padded entries carry weight 0."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...core.bbox.iou import bbox_overlaps, clamp_min
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
class IoULoss:
    """IoU loss of aligned (N, 4) boxes, the IoU clipped at ``eps`` from
    below: -log(IoU) (mode 'log'), 1 - IoU ('linear', or ``linear``
    True) or 1 - IoU^2 ('square'); an (N, 4) weight is averaged over its
    last axis (FCOS's box loss)."""

    def __init__(self, linear: bool = False, mode: str = 'log',
                 eps: float = 1e-6, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        mode = 'linear' if linear else mode
        if mode not in ('log', 'linear', 'square'):
            raise ValueError(f'IoULoss: mode {mode}')
        self.mode = mode
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        ious = clamp_min(bbox_overlaps(pred.float(), target.float(),
                                       is_aligned=True), self.eps)
        if self.mode == 'linear':
            loss = 1 - ious
        elif self.mode == 'square':
            loss = 1 - ious ** 2
        else:
            loss = -torch.log(ious)
        if weight is not None and weight.ndim == loss.ndim + 1:
            weight = weight.mean(-1)
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


@LOSSES.register_module()
class QualityFocalLoss:
    """Quality focal loss (reference gfocal_loss.py:11, arXiv:2006.04388):
    ``target`` is (labels (N,), quality scores (N,)). Every logit is
    pulled toward 0 by BCE times sigmoid^beta; a positive's own class
    (label in [0, C)) toward its quality score by BCE times
    |quality - sigmoid|^beta. Summed over the classes."""

    def __init__(self, use_sigmoid: bool = True, beta: float = 2.0,
                 reduction: str = 'mean', loss_weight: float = 1.0):
        if not use_sigmoid:
            raise NotImplementedError('QualityFocalLoss: only the sigmoid '
                                      'form is ported')
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        label, score = target
        pred = pred.float()
        sig = torch.sigmoid(pred)
        loss = _bce_with_logits(pred, torch.zeros_like(pred)) \
            * sig.pow(self.beta)
        score_b = score.float()[..., None].expand_as(pred)
        pos_loss = _bce_with_logits(pred, score_b) \
            * (score_b - sig).abs().pow(self.beta)
        own = _expand_onehot(label, pred.shape[-1]).bool()
        loss = torch.where(own, pos_loss, loss).sum(-1)
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)


@LOSSES.register_module()
class DistributionFocalLoss:
    """Distribution focal loss (reference gfocal_loss.py:55): the
    cross-entropy of the bins' softmax (N, n_bins) toward the two integer
    bins around the continuous label (N,), each weighted by its nearness;
    the label is clipped to [0, n_bins - 1 - 1e-6] first, so the right bin
    exists."""

    def __init__(self, reduction: str = 'mean', loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, label, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        pred = pred.float()
        n_bins = pred.shape[-1]
        label = label.float().clamp(0, n_bins - 1 - 1e-6)
        left = torch.floor(label).long()
        right = left + 1
        logp = torch.log_softmax(pred, dim=-1)
        loss = -logp.gather(-1, left[..., None])[..., 0] \
            * (right.float() - label) \
            - logp.gather(-1, right.clamp(max=n_bins - 1)[..., None])[..., 0] \
            * (label - left.float())
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)


@LOSSES.register_module()
class VarifocalLoss:
    """Varifocal loss (reference varifocal_loss.py:10, arXiv:2008.13367):
    BCE toward the IoU-aware targets (N, C), a positive (target > 0)
    weighted by its target (by 1 without ``iou_weighted``), a negative by
    alpha |sigmoid - target|^gamma; an (N,) weight is broadcast over the
    classes."""

    def __init__(self, use_sigmoid: bool = True, alpha: float = 0.75,
                 gamma: float = 2.0, iou_weighted: bool = True,
                 reduction: str = 'mean', loss_weight: float = 1.0):
        if not use_sigmoid:
            raise NotImplementedError('VarifocalLoss: only the sigmoid form '
                                      'is ported')
        self.alpha = alpha
        self.gamma = gamma
        self.iou_weighted = iou_weighted
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        pred, target = pred.float(), target.float()
        sig = torch.sigmoid(pred)
        pos = (target > 0.0).float()
        neg_weight = self.alpha * (sig - target).abs().pow(self.gamma) \
            * (1 - pos)
        focal_weight = (target * pos if self.iou_weighted else pos) \
            + neg_weight
        loss = _bce_with_logits(pred, target) * focal_weight
        if weight is not None and weight.ndim < loss.ndim:
            weight = weight[..., None]
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)


@LOSSES.register_module()
class KnowledgeDistillationKLDivLoss:
    """Temperature-scaled KL divergence (reference kd_loss.py:39,
    arXiv:1503.02531, LD arXiv:2102.12252): with p = softmax(pred / T) and
    q = softmax(soft_label / T) (detached), q (log max(q, 1e-12) - log p)
    where q > 0 and 0 elsewhere, averaged over the last axis, times T^2."""

    def __init__(self, reduction: str = 'mean', loss_weight: float = 1.0,
                 T: float = 10.0):
        if T < 1:
            raise ValueError(f'KnowledgeDistillationKLDivLoss: T {T} < 1')
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.T = float(T)

    def __call__(self, pred, soft_label, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        t = self.T
        logp = torch.log_softmax(pred.float() / t, dim=-1)
        q = torch.softmax(soft_label.detach().float() / t, dim=-1)
        kl = torch.where(q > 0, q * (torch.log(q.clamp(min=1e-12)) - logp),
                         0.0)
        loss = kl.mean(-1) * (t * t)
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
