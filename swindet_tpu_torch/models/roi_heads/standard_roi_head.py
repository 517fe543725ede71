"""StandardRoIHead (counterpart of
``swindet_tpu/models/roi_heads/standard_roi_head.py``: ``forward_train`` /
``_forward_train_impl`` :223-316, ``simple_test`` :349; reference
mmdet/models/roi_heads/standard_roi_head.py:10).

Train: per-image assignment and sampling of the padded proposals with the
gt boxes prepended, RoIAlign over the batch's fixed slots, bbox losses,
then the mask branch on the first ``num * pos_fraction`` slots, where the
sampler packs the positives. The default path only: no OHEM, no
score-HLR.

Test: padded proposals -> bbox head -> per-image multiclass NMS -> mask
probs of the kept detections, batched over images.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..builder import (build_assigner, build_head, build_roi_extractor,
                       build_sampler)
from ...registries import HEADS


@HEADS.register_module()
class StandardRoIHead(nn.Module):

    def __init__(self, bbox_roi_extractor: dict, bbox_head: dict,
                 mask_roi_extractor: Optional[dict] = None,
                 mask_head: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, train_cfg=None,
                 dtype=torch.float32):
        super().__init__()
        self.bbox_roi_extractor = build_roi_extractor(
            dict(bbox_roi_extractor))
        self.bbox_head = build_head(dict(bbox_head, dtype=dtype))
        self.mask_head = None
        if mask_head is not None:
            self.mask_roi_extractor = build_roi_extractor(
                dict(mask_roi_extractor or bbox_roi_extractor))
            self.mask_head = build_head(dict(mask_head, dtype=dtype))
        self.test_cfg = dict(test_cfg or {})
        self.train_cfg = train_cfg
        if train_cfg:
            self.assigner = build_assigner(dict(train_cfg['assigner']))
            self.sampler = build_sampler(dict(train_cfg['sampler']))

    @property
    def with_mask(self) -> bool:
        return self.mask_head is not None

    def init_weights(self, gen: torch.Generator):
        self.bbox_head.init_weights(gen)
        if self.with_mask:
            self.mask_head.init_weights(gen)

    def forward_train(self, feats, proposals, proposal_valid, gt_bboxes,
                      gt_valid, gt_labels, gt_masks,
                      gen: Optional[torch.Generator] = None,
                      keys: Optional[Sequence] = None
                      ) -> Dict[str, torch.Tensor]:
        """feats: per-level (B, H, W, C); proposals (B, P, 4) detached;
        gt_bboxes (B, G, 4); gt_masks (B, G, H_pad, W_pad) or None.
        ``keys``: per image the sampler's (keys_pos, keys_neg), or None to
        draw them from ``gen``."""
        b = proposals.shape[0]
        num = self.sampler.num
        dev = proposals.device
        samples = []
        for i in range(b):
            assign = self.assigner.assign(proposals[i], gt_bboxes[i],
                                          gt_valid[i], gt_labels[i],
                                          bbox_valid=proposal_valid[i])
            samples.append(self.sampler.sample(
                assign, proposals[i], gt_bboxes[i], gt_valid[i],
                gt_labels[i], bbox_valid=proposal_valid[i], gen=gen,
                keys=None if keys is None else keys[i]))
        samp = type(samples[0])(*[torch.stack(t) for t in zip(*samples)])

        batch_col = torch.arange(b, dtype=torch.float32, device=dev) \
            .repeat_interleave(num)
        rois = torch.cat([batch_col[:, None], samp.bboxes.reshape(-1, 4)], 1)
        cls_score, bbox_pred = self.bbox_head(
            self.bbox_roi_extractor(feats, rois))
        labels, label_weights, bbox_targets, bbox_weights = \
            self.bbox_head.get_targets(samp, self.train_cfg)
        losses = self.bbox_head.loss(
            cls_score, bbox_pred, labels.reshape(-1),
            label_weights.reshape(-1), bbox_targets.reshape(-1, 4),
            bbox_weights.reshape(-1, 4))

        if self.with_mask and gt_masks is not None:
            m = int(num * self.sampler.pos_fraction)
            pos_boxes = samp.bboxes[:, :m]
            pos_inds = samp.pos_gt_inds[:, :m]
            pos_mask = samp.is_pos[:, :m]
            pos_labels = samp.pos_gt_labels[:, :m].clamp(min=0)
            mask_col = torch.arange(b, dtype=torch.float32, device=dev) \
                .repeat_interleave(m)
            mask_rois = torch.cat([mask_col[:, None],
                                   pos_boxes.reshape(-1, 4)], 1)
            mask_pred = self.mask_head(
                self.mask_roi_extractor(feats, mask_rois))
            size = self.train_cfg.get('mask_size', 28)
            targets = torch.stack([
                self.mask_head.get_targets(gt_masks[i], pos_boxes[i],
                                           pos_inds[i], size)
                for i in range(b)])
            losses.update(self.mask_head.loss(
                mask_pred, targets.reshape(-1, size, size),
                pos_labels.reshape(-1), pos_mask.reshape(-1).float()))
        return losses

    def simple_test(self, feats, proposals, proposal_valid, img_shapes,
                    scale_factors, rescale: bool = True):
        """Returns dets (B, max, 5), labels (B, max), det_valid (B, max)
        and, with a mask head, mask_probs (B, max, 2s, 2s)."""
        cfg = self.test_cfg
        b, p = proposals.shape[:2]
        dev = proposals.device
        batch_col = torch.arange(b, device=dev, dtype=torch.float32) \
            .repeat_interleave(p)
        rois = torch.cat([batch_col[:, None], proposals.reshape(-1, 4)], 1)
        cls_score, bbox_pred = self.bbox_head(
            self.bbox_roi_extractor(feats, rois))
        res = self.bbox_head.get_bboxes(
            rois.view(b, p, 5), cls_score.view(b, p, -1),
            bbox_pred.view(b, p, -1), img_shapes, scale_factors, rescale,
            cfg, roi_valid=proposal_valid)
        out = dict(dets=res.dets, labels=res.labels, det_valid=res.valid)
        if self.with_mask:
            max_out = res.dets.shape[1]
            det_boxes = res.dets[..., :4]
            if rescale:  # the mask RoIAlign runs at input scale
                det_boxes = det_boxes * scale_factors[:, None, :4]
            mask_col = torch.arange(b, device=dev, dtype=torch.float32) \
                .repeat_interleave(max_out)
            mask_rois = torch.cat([mask_col[:, None],
                                   det_boxes.reshape(-1, 4)], 1)
            mask_pred = self.mask_head(
                self.mask_roi_extractor(feats, mask_rois))
            probs = self.mask_head.get_mask_probs(mask_pred,
                                                  res.labels.reshape(-1))
            out['mask_probs'] = probs.view(b, max_out, *probs.shape[1:])
        return out
