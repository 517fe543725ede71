"""RPN-only detector (counterpart of
``swindet_tpu/models/detectors/rpn.py:14``; reference
mmdet/models/detectors/rpn.py:12).

Backbone, optional neck (none in the C4 config: the RPN reads the
backbone's one stride-16 map) and an ``RPNHead`` trained alone.
``simple_test`` returns the proposals as class-agnostic detections: every
box labelled 0 with its objectness score, for proposal recall
(``CocoDataset.evaluate(metric='proposal')``). The ``state_dict`` uses
mmdet's key names (``backbone.``, ``neck.``, ``rpn_head.``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..builder import build_backbone, build_head, build_neck
from ..layers import resolve_dtype
from ...registries import DETECTORS


@DETECTORS.register_module()
class RPN(nn.Module):

    def __init__(self, backbone: dict, rpn_head: dict,
                 test_cfg: Optional[dict] = None,
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

        self.backbone = build_backbone(with_dtype(backbone))
        self.neck = None if neck is None else build_neck(with_dtype(neck))
        # the head's train_cfg is train_cfg['rpn'] where there is one, as
        # in the JAX package (rpn.py:31-32)
        train_cfg = dict(train_cfg) if train_cfg else {}
        test_cfg = dict(test_cfg) if test_cfg else {}
        self.rpn_head = build_head(with_dtype(dict(
            rpn_head, train_cfg=train_cfg.get('rpn', train_cfg) or None,
            test_cfg=test_cfg.get('rpn', test_cfg))))
        self.test_cfg = test_cfg

    def init_weights(self, seed: int = 0) -> None:
        """Seeded random weights with the JAX package's init schemes."""
        gen = torch.Generator().manual_seed(seed)
        for part in (self.backbone, self.neck, self.rpn_head):
            if part is not None:
                part.init_weights(gen)

    def extract_feat(self, img: torch.Tensor,
                     gen: Optional[torch.Generator] = None):
        """img (B, H, W, 3) NHWC -> the neck's levels, or the backbone's
        outputs without a neck."""
        feats = self.backbone(img, gen)
        return feats if self.neck is None else self.neck(feats)

    def forward_train(self, img: torch.Tensor, img_shapes: torch.Tensor,
                      pad_shapes: torch.Tensor, gt_bboxes: torch.Tensor,
                      gt_valid: torch.Tensor, gt_labels=None,
                      gt_masks: Optional[torch.Tensor] = None,
                      gen: Optional[torch.Generator] = None,
                      sampler_keys: Optional[Dict[str, Sequence]] = None
                      ) -> Dict[str, torch.Tensor]:
        """loss_rpn_cls and loss_rpn_bbox of one batch (the arguments of
        ``TwoStageDetector.forward_train``; the labels and masks are taken
        and unused). ``sampler_keys['rpn']`` gives the sampler's keys per
        image, or ``gen`` draws them."""
        cls_scores, bbox_preds = self.rpn_head(self.extract_feat(img, gen))
        return self.rpn_head.loss(cls_scores, bbox_preds, gt_bboxes,
                                  gt_valid, img_shapes, pad_shapes, gen,
                                  (sampler_keys or {}).get('rpn'))

    def simple_test(self, img: torch.Tensor, img_shapes: torch.Tensor,
                    scale_factors: torch.Tensor,
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """dets (B, max_per_img, 5): the proposals (divided by the scale
        factors with ``rescale``) and their scores; labels (all 0) and
        det_valid."""
        cls_scores, bbox_preds = self.rpn_head(self.extract_feat(img))
        cfg = dict(self.test_cfg.get('rpn', self.test_cfg))
        props, scores, valid = self.rpn_head.get_proposals(
            cls_scores, bbox_preds, img_shapes, cfg)
        if rescale:
            props = props / scale_factors.float()[:, None, :4]
        dets = torch.cat([props, scores[..., None]], -1)
        return dict(dets=dets, labels=torch.zeros_like(scores,
                                                       dtype=torch.long),
                    det_valid=valid)
