from .single_stage import RepPointsDetector, SingleStageDetector
from .two_stage import CascadeRCNN, MaskRCNN, TwoStageDetector

__all__ = ['CascadeRCNN', 'MaskRCNN', 'RepPointsDetector',
           'SingleStageDetector', 'TwoStageDetector']
