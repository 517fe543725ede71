from .rpn import RPN
from .single_stage import (FCOS, NASFCOS, RepPointsDetector, RetinaNet,
                           SingleStageDetector)
from .two_stage import (CascadeRCNN, FasterRCNN, FastRCNN, MaskRCNN,
                        TwoStageDetector)

__all__ = ['CascadeRCNN', 'FCOS', 'FasterRCNN', 'FastRCNN', 'MaskRCNN',
           'NASFCOS', 'RPN', 'RepPointsDetector', 'RetinaNet',
           'SingleStageDetector', 'TwoStageDetector']
