"""Two-stage detector (counterpart of
``swindet_tpu/models/detectors/two_stage.py``: ``forward_train`` :92,
``simple_test`` :127, the per-augmentation halves ``aug_rpn_test``,
``aug_bbox_test`` and ``aug_mask_test`` :144-162, ``CascadeRCNN`` :166,
``MaskRCNN`` :171, ``FasterRCNN`` :175, ``HybridTaskCascade`` :181,
``MaskScoringRCNN`` :186, ``FastRCNN`` :208; reference
mmdet/models/detectors/two_stage.py:10, htc.py:6, fast_rcnn.py:6,
mask_scoring_rcnn.py:6).

The ``state_dict`` uses mmdet's key names (``backbone.``, ``neck.``,
``rpn_head.``, ``roi_head.``), so a released ``.pth`` loads as it is.
A list of necks is refused: the JAX ``TwoStageDetector`` builds one
(``two_stage.py:41-47``) but calls the list whole in ``extract_feat``
(:73-75), which raises there (TypeError: 'tuple' object is not
callable).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..builder import build_backbone, build_head, build_neck
from ..layers import resolve_dtype
from ...registries import DETECTORS


@DETECTORS.register_module()
class TwoStageDetector(nn.Module):

    def __init__(self, backbone: dict, roi_head: dict, test_cfg: dict,
                 rpn_head: Optional[dict] = None,
                 neck: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None, dtype=torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.dtype = dtype

        def with_dtype(cfg):
            out = dict(cfg)
            out.setdefault('dtype', dtype)
            return out

        if isinstance(neck, (list, tuple)):
            raise TypeError(f'{type(self).__name__}: a list of necks, which '
                            f'the JAX two-stage detector cannot run either')
        self.backbone = build_backbone(with_dtype(backbone))
        # the C4 and DC5 configs feed the backbone's one map as it is
        self.neck = None if neck is None else build_neck(with_dtype(neck))
        train_cfg = dict(train_cfg) if train_cfg else {}
        # Fast R-CNN has no RPN: its proposals are handed in
        self.rpn_head = None if rpn_head is None else build_head(with_dtype(
            dict(rpn_head, test_cfg=dict(test_cfg)['rpn'],
                 train_cfg=train_cfg.get('rpn'))))
        self.roi_head = build_head(with_dtype(dict(
            roi_head, test_cfg=dict(test_cfg)['rcnn'],
            train_cfg=train_cfg.get('rcnn'))))
        self.test_cfg = test_cfg
        self.train_cfg = train_cfg

    def init_weights(self, seed: int = 0) -> None:
        """Seeded random weights with the JAX package's init schemes."""
        gen = torch.Generator().manual_seed(seed)
        for part in (self.backbone, self.neck, self.rpn_head,
                     self.roi_head):
            if part is not None:
                part.init_weights(gen)

    def extract_feat(self, img: torch.Tensor,
                     gen: Optional[torch.Generator] = None):
        """img (B, H, W, 3) NHWC -> FPN levels (B, H_l, W_l, C), or the
        backbone's outputs without a neck; ``gen`` draws the backbone's
        stochastic depth in training mode."""
        feats = self.backbone(img, gen)
        return feats if self.neck is None else self.neck(feats)

    def forward_train(self, img: torch.Tensor, img_shapes: torch.Tensor,
                      pad_shapes: torch.Tensor, gt_bboxes: torch.Tensor,
                      gt_valid: torch.Tensor, gt_labels: torch.Tensor,
                      gt_masks: Optional[torch.Tensor] = None,
                      gen: Optional[torch.Generator] = None,
                      sampler_keys: Optional[Dict[str, Sequence]] = None,
                      gt_semantic_seg: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """The loss dict of one batch. img (B, H, W, 3); img / pad_shapes
        (B, 2); gt_bboxes (B, G, 4); gt_valid (B, G); gt_labels (B, G);
        gt_masks (B, G, H, W) or None; gt_semantic_seg (B, H', W') uint8
        or None, handed to the RoI head where given (HTC's semantic
        branch). ``gen`` (on the data's device)
        draws stochastic depth and the samplers' keys; ``sampler_keys``
        {'rpn': ..., 'rcnn': ...} gives the keys per image instead (for a
        cascade, 'rcnn' holds them per stage, then per image).
        ``train_cfg['rcnn']``, a list of per-stage configs for a cascade,
        goes to the RoI head as it is."""
        keys = sampler_keys or {}
        feats = self.extract_feat(img, gen)
        cls_scores, bbox_preds = self.rpn_head(feats)
        losses = self.rpn_head.loss(cls_scores, bbox_preds, gt_bboxes,
                                    gt_valid, img_shapes, pad_shapes, gen,
                                    keys.get('rpn'))
        proposal_cfg = dict(self.train_cfg.get('rpn_proposal',
                                               dict(self.test_cfg)['rpn']))
        with torch.no_grad():
            proposals, _, prop_valid = self.rpn_head.get_proposals(
                [s.detach() for s in cls_scores],
                [p.detach() for p in bbox_preds], img_shapes, proposal_cfg)
        roi_kwargs = {} if gt_semantic_seg is None \
            else dict(gt_semantic_seg=gt_semantic_seg)
        losses.update(self.roi_head.forward_train(
            feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
            gt_masks, gen, keys.get('rcnn'), img_shapes=img_shapes,
            **roi_kwargs))
        return losses

    def simple_test(self, img: torch.Tensor, img_shapes: torch.Tensor,
                    scale_factors: torch.Tensor,
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """Padded dets / labels / det_valid (+ mask_probs) per image."""
        feats = self.extract_feat(img)
        cls_scores, bbox_preds = self.rpn_head(feats)
        proposals, _, prop_valid = self.rpn_head.get_proposals(
            cls_scores, bbox_preds, img_shapes,
            dict(dict(self.test_cfg)['rpn']))
        return self.roi_head.simple_test(feats, proposals, prop_valid,
                                         img_shapes, scale_factors,
                                         rescale=rescale)


    # The per-augmentation halves of test-time augmentation
    # (apis/aug_test.py maps boxes between frames and merges the
    # augmentations). Each takes the augmentation's features when the
    # caller has them: the JAX halves extract them again each time.
    def aug_rpn_test(self, img, img_shapes, feats=None):
        """One augmentation's proposals in its own frame: (proposals
        (B, P, 4), scores (B, P), valid (B, P))."""
        feats = self.extract_feat(img) if feats is None else feats
        cls_scores, bbox_preds = self.rpn_head(feats)
        return self.rpn_head.get_proposals(cls_scores, bbox_preds,
                                           img_shapes,
                                           dict(dict(self.test_cfg)['rpn']))

    def aug_bbox_test(self, img, proposals, img_shapes, feats=None):
        """The bbox branch on given proposals (the augmentation's frame, no
        NMS): (scores (B, P, K+1), boxes (B, P, 4K))."""
        feats = self.extract_feat(img) if feats is None else feats
        return self.roi_head.bbox_test(feats, proposals, img_shapes)

    def aug_mask_test(self, img, det_boxes, det_labels, feats=None):
        """Mask probabilities (B, M, s, s) of boxes in the augmentation's
        frame."""
        feats = self.extract_feat(img) if feats is None else feats
        return self.roi_head.mask_test(feats, det_boxes, det_labels)


@DETECTORS.register_module()
class CascadeRCNN(TwoStageDetector):
    """(reference cascade_rcnn.py:6)."""


@DETECTORS.register_module()
class MaskRCNN(TwoStageDetector):
    """(reference mask_rcnn.py:6)."""


@DETECTORS.register_module()
class FasterRCNN(TwoStageDetector):
    """(reference faster_rcnn.py): a bbox-only ``StandardRoIHead``."""


@DETECTORS.register_module()
class HybridTaskCascade(CascadeRCNN):
    """(reference htc.py:6): a ``HybridTaskCascadeRoIHead``, its semantic
    branch trained on ``gt_semantic_seg``."""


@DETECTORS.register_module()
class MaskScoringRCNN(TwoStageDetector):
    """(reference mask_scoring_rcnn.py:6): its RoI head is a
    MaskScoringRoIHead."""


@DETECTORS.register_module()
class FastRCNN(TwoStageDetector):
    """(reference fast_rcnn.py:6): a two-stage detector without an RPN,
    driven by proposals handed in (B, P, 4) with their validity (B, P):
    static proposal slots, the padding masked by ``prop_valid``."""

    def forward_train(self, img, img_shapes, pad_shapes, gt_bboxes,
                      gt_valid, gt_labels, proposals, prop_valid,
                      gt_masks=None, gen: Optional[torch.Generator] = None,
                      sampler_keys: Optional[Dict[str, Sequence]] = None
                      ) -> Dict[str, torch.Tensor]:
        """The RoI head's losses on ``proposals``, in the JAX package's
        argument order; ``sampler_keys['rcnn']`` gives the sampler's keys
        per image (its G + P candidates: the gts, added as proposals
        first, then the proposals)."""
        feats = self.extract_feat(img, gen)
        return dict(self.roi_head.forward_train(
            feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
            gt_masks, gen, (sampler_keys or {}).get('rcnn'),
            img_shapes=img_shapes))

    def simple_test(self, img, img_shapes, scale_factors, proposals,
                    prop_valid, rescale: bool = True):
        """Padded dets / labels / det_valid (+ mask_probs) per image."""
        return self.roi_head.simple_test(self.extract_feat(img), proposals,
                                         prop_valid, img_shapes,
                                         scale_factors, rescale=rescale)
