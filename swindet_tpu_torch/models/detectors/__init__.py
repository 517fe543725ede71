from .single_stage import RepPointsDetector, RetinaNet, SingleStageDetector
from .two_stage import CascadeRCNN, FasterRCNN, MaskRCNN, TwoStageDetector

__all__ = ['CascadeRCNN', 'FasterRCNN', 'MaskRCNN', 'RepPointsDetector',
           'RetinaNet', 'SingleStageDetector', 'TwoStageDetector']
