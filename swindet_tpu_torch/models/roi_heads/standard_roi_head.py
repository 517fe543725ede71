"""StandardRoIHead (counterpart of
``swindet_tpu/models/roi_heads/standard_roi_head.py``: ``_bbox_forward``
:62, ``_mask_feats`` :72, ``forward_train`` / ``_forward_train_impl``
:223-316, ``bbox_test`` :319, ``mask_test`` :337, ``simple_test`` :349;
reference mmdet/models/roi_heads/standard_roi_head.py:10).

A ``shared_head`` (the C4 configs' ResLayer) runs on the roi features of
both branches, after each branch's extractor: with no
``mask_roi_extractor`` the mask branch pools again with its copy of the
bbox extractor, as the JAX package does.

Train: per-image assignment and sampling of the padded proposals with the
gt boxes prepended, RoIAlign over the batch's fixed slots, bbox losses,
then the mask branch on the first ``num * pos_fraction`` slots, where the
sampler packs the positives. The default path only: no OHEM, no
score-HLR.

Test: padded proposals -> bbox head (``bbox_test``) -> per-image
multiclass NMS -> mask probs of the kept detections (``mask_test``),
batched over images; test-time augmentation runs the two halves apart.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..builder import (build_assigner, build_head, build_roi_extractor,
                       build_sampler, build_shared_head)
from ...registries import HEADS


def boxes_to_rois(boxes: torch.Tensor) -> torch.Tensor:
    """(B, P, 4) boxes -> (B * P, 5) rois with their image index."""
    b, p = boxes.shape[:2]
    col = torch.arange(b, device=boxes.device, dtype=torch.float32) \
        .repeat_interleave(p)
    return torch.cat([col[:, None], boxes.reshape(-1, 4)], 1)


def sample_batch(assigner, sampler, proposals, proposal_valid, gt_bboxes,
                 gt_valid, gt_labels, gen=None, keys=None):
    """Per-image assignment and sampling of (B, P, 4) proposals into the
    sampler's fixed slots, stacked over the batch; ``keys`` per image the
    sampler's (keys_pos, keys_neg), or None to draw them from ``gen``."""
    samples = []
    for i in range(proposals.shape[0]):
        assign = assigner.assign(proposals[i], gt_bboxes[i], gt_valid[i],
                                 gt_labels[i], bbox_valid=proposal_valid[i])
        samples.append(sampler.sample(
            assign, proposals[i], gt_bboxes[i], gt_valid[i], gt_labels[i],
            bbox_valid=proposal_valid[i], gen=gen,
            keys=None if keys is None else keys[i]))
    return type(samples[0])(*[torch.stack(t) for t in zip(*samples)])


def mask_losses(mask_head, extract, feats, samp, m: int, gt_masks,
                size: int, predict=None) -> Dict[str, torch.Tensor]:
    """The mask head's loss on the first ``m`` slots of a stacked
    sampling result, where the sampler packs the positives; ``extract``
    maps (feats, rois) to the mask head's input, ``predict`` that input
    to the logits (the mask head itself by default)."""
    pos_boxes = samp.bboxes[:, :m]
    mask_pred = (predict or mask_head)(
        extract(feats, boxes_to_rois(pos_boxes)))
    targets = torch.stack([
        mask_head.get_targets(gt_masks[i], pos_boxes[i],
                              samp.pos_gt_inds[i, :m], size)
        for i in range(pos_boxes.shape[0])])
    return mask_head.loss(mask_pred, targets.reshape(-1, size, size),
                          samp.pos_gt_labels[:, :m].clamp(min=0).reshape(-1),
                          samp.is_pos[:, :m].reshape(-1).float())


@HEADS.register_module()
class StandardRoIHead(nn.Module):

    def __init__(self, bbox_roi_extractor: dict, bbox_head: dict,
                 mask_roi_extractor: Optional[dict] = None,
                 mask_head: Optional[dict] = None,
                 shared_head: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, train_cfg=None,
                 dtype=torch.float32):
        super().__init__()
        self.bbox_roi_extractor = build_roi_extractor(
            dict(bbox_roi_extractor))
        self.shared_head = None if shared_head is None else \
            build_shared_head(dict(shared_head, dtype=dtype))
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
        if isinstance(self.bbox_roi_extractor, nn.Module):
            self.bbox_roi_extractor.init_weights(gen)
        if self.shared_head is not None:
            self.shared_head.init_weights(gen)
        self.bbox_head.init_weights(gen)
        if self.with_mask:
            if isinstance(self.mask_roi_extractor, nn.Module):
                self.mask_roi_extractor.init_weights(gen)
            self.mask_head.init_weights(gen)

    def _bbox_feats(self, feats, rois):
        x = self.bbox_roi_extractor(feats, rois)
        return x if self.shared_head is None else self.shared_head(x)

    def _mask_feats(self, feats, rois):
        x = self.mask_roi_extractor(feats, rois)
        return x if self.shared_head is None else self.shared_head(x)

    def forward_train(self, feats, proposals, proposal_valid, gt_bboxes,
                      gt_valid, gt_labels, gt_masks,
                      gen: Optional[torch.Generator] = None,
                      keys: Optional[Sequence] = None,
                      img_shapes: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """feats: per-level (B, H, W, C); proposals (B, P, 4) detached;
        gt_bboxes (B, G, 4); gt_masks (B, G, H_pad, W_pad) or None.
        ``keys``: per image the sampler's (keys_pos, keys_neg), or None to
        draw them from ``gen``. ``img_shapes`` is the cascade's argument
        and unused here."""
        samp = sample_batch(self.assigner, self.sampler, proposals,
                            proposal_valid, gt_bboxes, gt_valid, gt_labels,
                            gen, keys)
        rois = boxes_to_rois(samp.bboxes)
        cls_score, bbox_pred = self.bbox_head(self._bbox_feats(feats, rois))
        labels, label_weights, bbox_targets, bbox_weights = \
            self.bbox_head.get_targets(samp, self.train_cfg)
        losses = self.bbox_head.loss(
            cls_score, bbox_pred, rois, labels.reshape(-1),
            label_weights.reshape(-1), bbox_targets.reshape(-1, 4),
            bbox_weights.reshape(-1, 4))
        if self.with_mask and gt_masks is not None:
            losses.update(mask_losses(
                self.mask_head, self._mask_feats, feats, samp,
                int(self.sampler.num * self.sampler.pos_fraction), gt_masks,
                self.train_cfg.get('mask_size', 28)))
        return losses

    def bbox_test(self, feats, proposals, img_shapes):
        """Per-proposal class scores (B, P, K+1) (softmax, fp32) and boxes
        (B, P, 4K) decoded in the frame of ``img_shapes``, before NMS and
        rescale: the per-augmentation half of test-time augmentation."""
        b, p = proposals.shape[:2]
        rois = boxes_to_rois(proposals)
        cls_score, bbox_pred = self.bbox_head(self._bbox_feats(feats, rois))
        return self.bbox_head.decode(rois.view(b, p, 5),
                                     cls_score.view(b, p, -1),
                                     bbox_pred.view(b, p, -1), img_shapes)

    def mask_test(self, feats, det_boxes, det_labels):
        """Mask probabilities (B, M, 2s, 2s) of each box's own class, for
        (B, M, 4) boxes in the frame of ``feats``."""
        b, m = det_boxes.shape[:2]
        mask_pred = self.mask_head(self._mask_feats(
            feats, boxes_to_rois(det_boxes)))
        probs = self.mask_head.get_mask_probs(mask_pred,
                                              det_labels.reshape(-1))
        return probs.view(b, m, *probs.shape[1:])

    def simple_test(self, feats, proposals, proposal_valid, img_shapes,
                    scale_factors, rescale: bool = True):
        """Returns dets (B, max, 5), labels (B, max), det_valid (B, max)
        and, with a mask head, mask_probs (B, max, 2s, 2s)."""
        scores, boxes = self.bbox_test(feats, proposals, img_shapes)
        res = self.bbox_head.nms(scores, boxes, scale_factors, rescale,
                                 self.test_cfg, roi_valid=proposal_valid)
        out = dict(dets=res.dets, labels=res.labels, det_valid=res.valid)
        if self.with_mask:
            det_boxes = res.dets[..., :4]
            if rescale:  # the mask RoIAlign runs at input scale
                det_boxes = det_boxes * scale_factors[:, None, :4]
            out['mask_probs'] = self.mask_test(feats, det_boxes, res.labels)
        return out
