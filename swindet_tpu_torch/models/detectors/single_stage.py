"""Single-stage detector (counterpart of
``swindet_tpu/models/detectors/single_stage.py``: ``SingleStageDetector``
:18 with ``aug_bbox_test`` :86, ``RetinaNet`` :113, ``RepPointsDetector``
:119, ``ATSS`` :143, ``GFL`` :168, ``FCOS`` :174, ``NASFCOS`` :198,
``VFNet`` :226, ``PAA`` :274, ``KnowledgeDistillationSingleStageDetector``
:290; reference mmdet/models/detectors/single_stage.py:10, retinanet.py,
reppoints_detector.py:6, atss.py, gfl.py, fcos.py, nasfcos.py, vfnet.py,
paa.py, kd_one_stage.py:11).

Backbone, neck (one, or a list chained in order, as the JAX package
chains them) and one dense head whose outputs go to its ``loss``
and ``get_bboxes`` as they come. The ``state_dict`` uses mmdet's key
names (``backbone.``, ``neck.``, a list's ``neck.{i}.``, ``bbox_head.``),
so a released ``.pth`` loads as it is.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..builder import (build_backbone, build_detector, build_head,
                       build_neck)
from ..layers import resolve_dtype
from ...registries import DETECTORS
from ...utils.config import Config


@DETECTORS.register_module()
class SingleStageDetector(nn.Module):

    def __init__(self, backbone: dict, neck, bbox_head: dict,
                 test_cfg: dict, train_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None, dtype=torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.dtype = dtype

        def with_dtype(cfg):
            out = dict(cfg)
            out.setdefault('dtype', dtype)
            return out

        self.backbone = build_backbone(with_dtype(backbone))
        self.neck = nn.ModuleList([build_neck(with_dtype(n)) for n in neck]) \
            if isinstance(neck, (list, tuple)) else build_neck(
                with_dtype(neck))
        self.bbox_head = build_head(with_dtype(dict(
            bbox_head, train_cfg=train_cfg, test_cfg=test_cfg)))
        self.test_cfg = test_cfg
        self.train_cfg = dict(train_cfg) if train_cfg else {}

    def init_weights(self, seed: int = 0) -> None:
        """Seeded random weights with the JAX package's init schemes."""
        gen = torch.Generator().manual_seed(seed)
        for part in (self.backbone, *self._necks(), self.bbox_head):
            part.init_weights(gen)

    def _necks(self):
        return list(self.neck) if isinstance(self.neck, nn.ModuleList) \
            else [self.neck]

    def extract_feat(self, img: torch.Tensor,
                     gen: Optional[torch.Generator] = None):
        """img (B, H, W, 3) NHWC -> FPN levels (B, H_l, W_l, C), each neck
        of a list taking the last one's levels; ``gen`` draws the
        backbone's stochastic depth in training mode."""
        x = self.backbone(img, gen)
        for neck in self._necks():
            x = neck(x)
        return x

    def forward_train(self, img: torch.Tensor, img_shapes: torch.Tensor,
                      pad_shapes: torch.Tensor, gt_bboxes: torch.Tensor,
                      gt_valid: torch.Tensor, gt_labels: torch.Tensor,
                      gt_masks: Optional[torch.Tensor] = None,
                      gen: Optional[torch.Generator] = None,
                      sampler_keys: Optional[Dict[str, Sequence]] = None
                      ) -> Dict[str, torch.Tensor]:
        """The head's loss dict of one batch (the arguments of
        ``TwoStageDetector.forward_train``; ``gt_masks`` and
        ``sampler_keys`` are taken and unused: a dense head samples
        nothing)."""
        outs = self.bbox_head(self.extract_feat(img, gen))
        return self.bbox_head.loss(*outs, gt_bboxes, gt_valid, gt_labels,
                                   img_shapes, pad_shapes)

    def simple_test(self, img: torch.Tensor, img_shapes: torch.Tensor,
                    scale_factors: torch.Tensor,
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """Padded dets (B, max_per_img, 5), labels and det_valid."""
        outs = self.bbox_head(self.extract_feat(img))
        res = self.bbox_head.get_bboxes(*outs, img_shapes, scale_factors,
                                        cfg=dict(self.test_cfg),
                                        rescale=rescale)
        return dict(dets=res.dets, labels=res.labels, det_valid=res.valid)

    def aug_bbox_test(self, img: torch.Tensor, img_shapes: torch.Tensor,
                      feats=None):
        """One augmentation's pre-NMS candidates in its own frame, for
        ``apis/aug_test.py``: (boxes (B, P, 4), scores (B, P, classes + 1),
        score factors or None)."""
        feats = self.extract_feat(img) if feats is None else feats
        outs = self.bbox_head(feats)
        sf = torch.ones((img.shape[0], 4), device=img.device)
        res = self.bbox_head.get_bboxes(*outs, img_shapes, sf,
                                        cfg=dict(self.test_cfg),
                                        rescale=False, with_nms=False)
        return res[0], res[1], res[2] if len(res) > 2 else None


@DETECTORS.register_module()
class RetinaNet(SingleStageDetector):
    """(reference retinanet.py)."""


@DETECTORS.register_module()
class RepPointsDetector(SingleStageDetector):
    """(reference reppoints_detector.py:6): the head's three outputs go
    to its loss and get_bboxes as they come."""


@DETECTORS.register_module()
class FCOS(SingleStageDetector):
    """(reference fcos.py): the head's three outputs (classes, box
    distances, centerness), its training branch in ``forward_train``."""

    def forward_train(self, img, img_shapes, pad_shapes, gt_bboxes,
                      gt_valid, gt_labels, gt_masks=None, gen=None,
                      sampler_keys=None):
        outs = self.bbox_head(self.extract_feat(img, gen), train=True)
        return self.bbox_head.loss(*outs, gt_bboxes, gt_valid, gt_labels,
                                   img_shapes, pad_shapes)


@DETECTORS.register_module()
class NASFCOS(FCOS):
    """(reference nasfcos.py): FCOS with the searched neck and head."""


@DETECTORS.register_module()
class ATSS(SingleStageDetector):
    """(reference atss.py): the head's three outputs (classes, box deltas,
    centerness)."""


@DETECTORS.register_module()
class GFL(SingleStageDetector):
    """(reference gfl.py): the head's two outputs (class-quality scores,
    box-side bins)."""


@DETECTORS.register_module()
class VFNet(SingleStageDetector):
    """(reference vfnet.py): the head's three outputs (classes, initial and
    refined box distances)."""


@DETECTORS.register_module()
class PAA(SingleStageDetector):
    """(reference paa.py:6): the head's three outputs (classes, box deltas,
    IoU)."""


@DETECTORS.register_module()
class KnowledgeDistillationSingleStageDetector(SingleStageDetector):
    """(reference kd_one_stage.py:11): a student single-stage detector and
    a teacher, ``teacher_model``, built from ``teacher_config`` (a model
    dict, or a config file's path, read relative to the working directory
    as the JAX package reads it) in the student's dtype. In training the
    teacher's head outputs, under ``torch.no_grad()``, give the student's
    head its soft targets (LD: the teacher's box-side bin logits). The
    teacher's parameters take no gradient, so ``build_optimizer`` leaves
    them out; with ``eval_teacher`` it stays in eval mode whatever
    ``train()`` is given. ``teacher_ckpt`` is taken and ignored, as in the
    JAX package. Testing runs the student alone."""

    def __init__(self, backbone: dict, neck, bbox_head: dict, test_cfg: dict,
                 teacher_config, teacher_ckpt: Optional[str] = None,
                 eval_teacher: bool = True, train_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None, dtype=torch.float32):
        super().__init__(backbone, neck, bbox_head, test_cfg, train_cfg,
                         pretrained, dtype)
        if isinstance(teacher_config, str):
            teacher_config = Config.fromfile(teacher_config).model
        self.teacher_model = build_detector(dict(teacher_config,
                                                 dtype=self.dtype))
        self.teacher_model.requires_grad_(False)
        self.eval_teacher = eval_teacher

    def init_weights(self, seed: int = 0) -> None:
        """The student's seeded weights, and the teacher's from seed + 1."""
        super().init_weights(seed)
        self.teacher_model.init_weights(seed + 1)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.eval_teacher:
            self.teacher_model.train(False)
        return self

    def forward_train(self, img, img_shapes, pad_shapes, gt_bboxes,
                      gt_valid, gt_labels, gt_masks=None, gen=None,
                      sampler_keys=None):
        outs = self.bbox_head(self.extract_feat(img, gen))
        with torch.no_grad():
            teacher = self.teacher_model
            soft = teacher.bbox_head(teacher.extract_feat(img))[1]
        return self.bbox_head.loss(*outs, gt_bboxes, gt_valid, gt_labels,
                                   img_shapes, pad_shapes,
                                   soft_targets=soft)
