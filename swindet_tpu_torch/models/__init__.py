"""Models of the port; importing this package registers them."""
from .. import core  # noqa: F401  (registers anchor generators and coders)
from . import (backbones, dense_heads, detectors, losses,  # noqa: F401
               necks, roi_heads)
from .builder import build_detector

__all__ = ['build_detector']
