"""Registries of the port, under the JAX package's registry names so that
the repo's ``configs/`` build either package."""
from .utils.registry import Registry

BACKBONES = Registry('backbone')
NECKS = Registry('neck')
HEADS = Registry('head')
ROI_EXTRACTORS = Registry('roi_extractor')
DETECTORS = Registry('detector')
ANCHOR_GENERATORS = Registry('anchor_generator')
BBOX_CODERS = Registry('bbox_coder')
BBOX_ASSIGNERS = Registry('bbox_assigner')
BBOX_SAMPLERS = Registry('bbox_sampler')
LOSSES = Registry('loss')
PIPELINES = Registry('pipeline')
DATASETS = Registry('dataset')
