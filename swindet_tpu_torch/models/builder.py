"""Model builders over the port's registries."""
from __future__ import annotations

from ..registries import (ANCHOR_GENERATORS, BACKBONES, BBOX_ASSIGNERS,
                          BBOX_CODERS, BBOX_SAMPLERS, DETECTORS, HEADS,
                          LOSSES, NECKS, ROI_EXTRACTORS, SHARED_HEADS)
from ..utils.registry import build_from_cfg


def build_backbone(cfg):
    return build_from_cfg(cfg, BACKBONES)


def build_neck(cfg):
    return build_from_cfg(cfg, NECKS)


def build_head(cfg):
    return build_from_cfg(cfg, HEADS)


def build_roi_extractor(cfg):
    return build_from_cfg(cfg, ROI_EXTRACTORS)


def build_shared_head(cfg):
    return build_from_cfg(cfg, SHARED_HEADS)


def build_detector(cfg):
    return build_from_cfg(cfg, DETECTORS)


def build_anchor_generator(cfg):
    return build_from_cfg(cfg, ANCHOR_GENERATORS)


def build_bbox_coder(cfg):
    return build_from_cfg(cfg, BBOX_CODERS)


def build_assigner(cfg):
    return build_from_cfg(cfg, BBOX_ASSIGNERS)


def build_sampler(cfg):
    return build_from_cfg(cfg, BBOX_SAMPLERS)


def build_loss(cfg):
    return build_from_cfg(cfg, LOSSES)
