"""CascadeRoIHead (counterpart of
``swindet_tpu/models/roi_heads/cascade_roi_head.py``: ``forward_train``
:88, ``_ms_bbox_forward`` :196, ``bbox_test`` :222, ``mask_test`` :239,
``simple_test`` :256; reference mmdet/models/roi_heads/cascade_roi_head.py:13).

Train: each stage assigns and samples its candidates into fixed slots,
runs its bbox head and loss (weighted by ``stage_loss_weights``; keys
``s{i}.loss_cls``, ``s{i}.loss_bbox``, ``s{i}.acc``) and its mask head on
the first ``num * pos_fraction`` slots, then refines the slots' boxes
with its own class deltas (the argmax class on background slots) into
the next stage's candidates, detached, with the gt-sourced positives
dropped (the reference removes ``pos_is_gt`` rois).

Filler slots read zero roi features, as the JAX package's gather of
their out-of-range indices gives NaN boxes and its RoIAlign zeros for
them; a bbox head's norm statistics in training then run over all
B x num slots, filler slots included, as the JAX package's static layout
does (mmdet counts only the sampled rois).

Test: each stage's bbox head on the previous stage's refined rois (by
the argmax class); the raw logits averaged over the stages, softmax
after; the last stage's deltas decoded on the twice-refined rois, then
multiclass NMS. The mask probabilities are the mean of the stages' mask
heads' sigmoids over one mask RoIAlign.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from .standard_roi_head import boxes_to_rois, mask_losses, sample_batch
from ..builder import (build_assigner, build_head, build_roi_extractor,
                       build_sampler)
from ...registries import HEADS


@HEADS.register_module()
class CascadeRoIHead(nn.Module):

    def __init__(self, bbox_roi_extractor: dict, bbox_head: Sequence[dict],
                 num_stages: int = 3,
                 stage_loss_weights: Sequence[float] = (1.0, 0.5, 0.25),
                 mask_roi_extractor: Optional[dict] = None,
                 mask_head=None, test_cfg: Optional[dict] = None,
                 train_cfg=None, dtype=torch.float32):
        super().__init__()
        if len(bbox_head) != num_stages:
            raise ValueError(f'CascadeRoIHead: {len(bbox_head)} bbox heads '
                             f'for {num_stages} stages')
        self.num_stages = num_stages
        self.stage_loss_weights = list(stage_loss_weights)
        self.bbox_roi_extractor = build_roi_extractor(
            dict(bbox_roi_extractor))
        self.bbox_head = nn.ModuleList([build_head(dict(h, dtype=dtype))
                                        for h in bbox_head])
        self.mask_head = None
        if mask_head is not None:
            # one mask head config is repeated per stage (Swin configs)
            heads = list(mask_head) if isinstance(mask_head, (list, tuple)) \
                else [mask_head] * num_stages
            self.mask_roi_extractor = build_roi_extractor(
                dict(mask_roi_extractor or bbox_roi_extractor))
            self.mask_head = nn.ModuleList([build_head(dict(h, dtype=dtype))
                                            for h in heads])
        self.test_cfg = dict(test_cfg or {})
        self.train_cfg = train_cfg
        if train_cfg:
            stages = list(train_cfg) if isinstance(train_cfg, (list, tuple)) \
                else [train_cfg] * num_stages
            self.stage_cfgs = [dict(c) for c in stages]
            self.assigners = [build_assigner(dict(c['assigner']))
                              for c in self.stage_cfgs]
            self.samplers = [build_sampler(dict(c['sampler']))
                             for c in self.stage_cfgs]

    @property
    def with_mask(self) -> bool:
        return self.mask_head is not None

    def init_weights(self, gen: torch.Generator):
        for head in self.bbox_head:
            head.init_weights(gen)
        for head in self.mask_head or ():
            head.init_weights(gen)

    def forward_train(self, feats, proposals, proposal_valid, gt_bboxes,
                      gt_valid, gt_labels, gt_masks,
                      gen: Optional[torch.Generator] = None,
                      keys: Optional[Sequence] = None,
                      img_shapes: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """feats: per-level (B, H, W, C); proposals (B, P, 4) detached;
        gt_bboxes (B, G, 4); gt_masks (B, G, H_pad, W_pad) or None;
        img_shapes (B, 2), which clip the refined boxes. ``keys``: per
        stage, per image the sampler's (keys_pos, keys_neg) over that
        stage's candidates (G + P at stage 0, G + num after), or None to
        draw them from ``gen``."""
        losses: Dict[str, torch.Tensor] = {}
        cur_props, cur_valid = proposals, proposal_valid
        for stage in range(self.num_stages):
            lw = self.stage_loss_weights[stage]
            head = self.bbox_head[stage]
            sampler = self.samplers[stage]
            num = sampler.num
            samp = sample_batch(self.assigners[stage], sampler, cur_props,
                                cur_valid, gt_bboxes, gt_valid, gt_labels,
                                gen, None if keys is None else keys[stage])
            rois = boxes_to_rois(samp.bboxes)
            cls_score, bbox_pred = head(self.bbox_roi_extractor(
                feats, rois, roi_valid=samp.valid.reshape(-1)))
            labels, label_weights, bbox_targets, bbox_weights = \
                head.get_targets(samp, self.stage_cfgs[stage])
            labels = labels.reshape(-1)
            stage_losses = head.loss(
                cls_score, bbox_pred, rois, labels,
                label_weights.reshape(-1), bbox_targets.reshape(-1, 4),
                bbox_weights.reshape(-1, 4))
            for k, v in stage_losses.items():
                losses[f's{stage}.{k}'] = v * lw if 'loss' in k else v

            if self.with_mask and gt_masks is not None:
                mloss = mask_losses(
                    self.mask_head[stage], self.mask_roi_extractor, feats,
                    samp, int(num * sampler.pos_fraction), gt_masks,
                    self.stage_cfgs[stage].get('mask_size', 28))
                losses[f's{stage}.loss_mask'] = mloss['loss_mask'] * lw

            if stage < self.num_stages - 1:
                cur_props, cur_valid = self._refine(
                    stage, samp, rois, labels, cls_score, bbox_pred,
                    img_shapes, gt_bboxes.shape[1])
        return losses

    def _refine(self, stage, samp, rois, labels, cls_score, bbox_pred,
                img_shapes, num_gts):
        """A stage's sampled slots regressed by their class (the argmax
        class on background slots), detached: the next candidates (B,
        num, 4) and their validity, the gt-sourced positives dropped."""
        head = self.bbox_head[stage]
        b, num = samp.valid.shape
        with torch.no_grad():
            cls_arg = cls_score[:, :-1].argmax(-1)
            roi_labels = torch.where(labels == head.num_classes, cls_arg,
                                     labels)
            new_rois = head.regress_by_class(
                rois, roi_labels, bbox_pred,
                img_shapes.repeat_interleave(num, 0))
        is_gt = samp.is_pos & (samp.inds < num_gts) \
            if self.samplers[stage].add_gt_as_proposals \
            else torch.zeros_like(samp.is_pos)
        return new_rois[:, 1:].reshape(b, num, 4), samp.valid & ~is_gt

    def _ms_bbox_forward(self, feats, rois, img_shapes, fuse=None):
        """The stages on rois (R, 5) whose images are (R, 2)
        ``img_shapes``: (stage-averaged scores, softmax after the mean of
        the logits; the last stage's rois; its deltas). ``fuse`` maps
        (roi features, rois) to a stage's head input, where the roi
        features are not that input as they are."""
        ms_scores = []
        for stage, head in enumerate(self.bbox_head):
            x = self.bbox_roi_extractor(feats, rois)
            cls_score, bbox_pred = head(x if fuse is None else fuse(x, rois))
            ms_scores.append(cls_score.float())
            if stage < self.num_stages - 1:
                rois = head.regress_by_class(
                    rois, cls_score[:, :-1].argmax(-1), bbox_pred,
                    img_shapes)
        scores = torch.softmax(sum(ms_scores) / self.num_stages, dim=-1)
        return scores, rois, bbox_pred

    def bbox_test(self, feats, proposals, img_shapes):
        """Per-proposal class scores (B, P, K+1) averaged over the stages
        and the last stage's boxes (B, P, 4K) decoded in the frame of
        ``img_shapes``, before NMS and rescale: the per-augmentation half
        of test-time augmentation."""
        b, p = proposals.shape[:2]
        scores, rois, bbox_pred = self._ms_bbox_forward(
            feats, boxes_to_rois(proposals),
            img_shapes.repeat_interleave(p, 0))
        boxes = self.bbox_head[-1].decode_for_test(
            rois.view(b, p, 5), bbox_pred.view(b, p, -1), img_shapes)
        return scores.view(b, p, -1), boxes

    def mask_test(self, feats, det_boxes, det_labels):
        """Mask probabilities (B, M, 2s, 2s) of each box's own class, the
        mean of the stages' mask heads on one RoIAlign, for (B, M, 4)
        boxes in the frame of ``feats``."""
        b, m = det_boxes.shape[:2]
        mask_feats = self.mask_roi_extractor(feats,
                                             boxes_to_rois(det_boxes))
        labels = det_labels.reshape(-1)
        probs = 0.0
        for head in self.mask_head:
            probs = probs + head.get_mask_probs(head(mask_feats), labels)
        probs = probs / self.num_stages
        return probs.view(b, m, *probs.shape[1:])

    def simple_test(self, feats, proposals, proposal_valid, img_shapes,
                    scale_factors, rescale: bool = True):
        """Returns dets (B, max, 5), labels (B, max), det_valid (B, max)
        and, with mask heads, mask_probs (B, max, 2s, 2s)."""
        scores, boxes = self.bbox_test(feats, proposals, img_shapes)
        res = self.bbox_head[-1].nms(scores, boxes, scale_factors, rescale,
                                     self.test_cfg, roi_valid=proposal_valid)
        out = dict(dets=res.dets, labels=res.labels, det_valid=res.valid)
        if self.with_mask:
            det_boxes = res.dets[..., :4]
            if rescale:  # the mask RoIAlign runs at input scale
                det_boxes = det_boxes * scale_factors[:, None, :4]
            out['mask_probs'] = self.mask_test(feats, det_boxes, res.labels)
        return out
