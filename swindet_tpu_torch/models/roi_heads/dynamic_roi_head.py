"""Dynamic R-CNN (counterpart of
``swindet_tpu/models/roi_heads/dynamic_roi_head.py:28``; reference
mmdet/models/roi_heads/dynamic_roi_head.py:14, arXiv:2004.06002): the
RCNN assigner's IoU threshold and the SmoothL1 beta follow the training
proposals' statistics.

Each training step records, per image, the ``iou_topk``-th largest IoU of
the valid proposals with their gts (k clamped to the valid count), their
mean over the batch, and the ``beta_topk * B``-th smallest mean |dx, dy|
box target of the positives (``initial_beta`` where there is none). Every
``update_iter_interval`` steps the threshold becomes the mean of the
recorded IoUs, at least ``initial_iou``, and beta the median of the
recorded betas (the two middle values averaged for an even count, as
``jnp.median``; ``torch.median`` takes the lower), at most
``initial_beta``, unchanged where the median is under 1e-15.

The five values are buffers (``iou_thr``, ``beta``, the two histories of
``update_iter_interval`` entries and ``count``), advanced on the device in
each ``forward_train`` with no host read, as the JAX package's
``dynamic`` collection is in its train step. They stay out of the
``state_dict``: mmdet keeps them as Python lists, so its released weights
load strictly. ``dynamic_iou_thr`` and ``dynamic_beta`` join the loss
dict, logged but not summed (no 'loss' in their names).
"""
from __future__ import annotations

from typing import Dict

import torch

from ...registries import HEADS
from .standard_roi_head import (StandardRoIHead, boxes_to_rois, mask_losses,
                                sample_batch)

EPS = 1e-15


def median(x: torch.Tensor) -> torch.Tensor:
    """The median of a 1-d tensor as ``jnp.median`` takes it: the linear
    quantile at 0.5, lo * (1 - w) + hi * w of the sorted values."""
    s = x.sort().values
    pos = 0.5 * (x.numel() - 1)
    lo, hi = int(pos), int(-(-pos // 1))
    w = pos - lo
    return s[lo] * (1.0 - w) + s[hi] * w


@HEADS.register_module()
class DynamicRoIHead(StandardRoIHead):

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        d = dict(dict(self.train_cfg or {}).get('dynamic_rcnn', {}))
        self.iou_topk = int(d.get('iou_topk', 75))
        self.beta_topk = int(d.get('beta_topk', 10))
        self.interval = int(d.get('update_iter_interval', 100))
        self.initial_iou = float(d.get('initial_iou', 0.4))
        self.initial_beta = float(d.get('initial_beta', 1.0))
        for name, value in (
                ('iou_thr', torch.tensor(self.initial_iou)),
                ('beta', torch.tensor(self.initial_beta)),
                ('iou_hist', torch.zeros(self.interval)),
                ('beta_hist', torch.zeros(self.interval)),
                ('count', torch.zeros((), dtype=torch.int32))):
            self.register_buffer(name, value, persistent=False)

    def forward_train(self, feats, proposals, proposal_valid, gt_bboxes,
                      gt_valid, gt_labels, gt_masks, gen=None, keys=None,
                      img_shapes=None) -> Dict[str, torch.Tensor]:
        """StandardRoIHead's losses with the assigner's thresholds at
        ``iou_thr`` and the box loss's beta at ``beta`` (their values at
        the call), then the statistics recorded and, every
        ``update_iter_interval`` calls, both updated."""
        b = proposals.shape[0]
        iou_thr, beta = self.iou_thr.clone(), self.beta.clone()
        assigns = []
        samp = sample_batch(
            self.assigner, self.sampler, proposals, proposal_valid,
            gt_bboxes, gt_valid, gt_labels, gen, keys,
            assign_kwargs=dict(pos_iou_thr=iou_thr, neg_iou_thr=iou_thr,
                               min_pos_iou=iou_thr), assigns=assigns)
        kth = []
        for assign, valid in zip(assigns, proposal_valid):
            ov = torch.where(valid, assign.max_overlaps, -torch.inf)
            k = min(self.iou_topk, ov.shape[0])
            top = ov.topk(k).values
            n_valid = valid.sum()
            at = (torch.clamp(n_valid, max=k) - 1).clamp(min=0)
            kth.append(torch.where(n_valid > 0, top[at], 0.0))
        cur_iou = torch.stack(kth).mean()

        rois = boxes_to_rois(samp.bboxes)
        cls_score, bbox_pred = self._bbox_forward(feats, rois)
        labels, label_weights, bbox_targets, bbox_weights = \
            self.bbox_head.get_targets(samp, self.train_cfg)
        bbox_targets = bbox_targets.reshape(-1, 4)
        bbox_weights = bbox_weights.reshape(-1, 4)
        pos = bbox_weights[:, 0] > 0
        mag = torch.where(pos, bbox_targets[:, :2].abs().mean(1), torch.inf)
        k = min(self.beta_topk * b, mag.shape[0])
        small = (-mag).topk(k).values
        at = (torch.clamp(pos.sum(), max=k) - 1).clamp(min=0)
        cur_beta = -small[at]
        cur_beta = torch.where(torch.isfinite(cur_beta), cur_beta,
                               self.initial_beta)

        losses = self.bbox_head.loss(
            cls_score, bbox_pred, rois, labels.reshape(-1),
            label_weights.reshape(-1), bbox_targets, bbox_weights,
            loss_bbox_kwargs=dict(beta=beta))
        if self.with_mask and gt_masks is not None:
            losses.update(mask_losses(
                self.mask_head, self._mask_feats, feats, samp,
                int(self.sampler.num * self.sampler.pos_fraction), gt_masks,
                self.train_cfg.get('mask_size', 28)))
        self._update(cur_iou.detach(), cur_beta.detach())
        losses['dynamic_iou_thr'] = self.iou_thr.clone()
        losses['dynamic_beta'] = self.beta.clone()
        return losses

    @torch.no_grad()
    def _update(self, cur_iou: torch.Tensor, cur_beta: torch.Tensor) -> None:
        """Record this step's statistics in the histories' slot ``count``
        mod ``update_iter_interval``; after every ``update_iter_interval``
        records, the threshold and beta from the histories."""
        slot = torch.arange(self.interval, device=self.count.device) \
            == self.count % self.interval
        self.iou_hist.copy_(torch.where(slot, cur_iou, self.iou_hist))
        self.beta_hist.copy_(torch.where(slot, cur_beta, self.beta_hist))
        self.count += 1
        update = self.count % self.interval == 0
        new_iou = self.iou_hist.mean().clamp(min=self.initial_iou)
        med = median(self.beta_hist)
        new_beta = torch.where(med < EPS, self.beta,
                               med.clamp(max=self.initial_beta))
        self.iou_thr.copy_(torch.where(update, new_iou, self.iou_thr))
        self.beta.copy_(torch.where(update, new_beta, self.beta))
