from .rpn import RPN
from .single_stage import (ATSS, FCOS, GFL, NASFCOS, RepPointsDetector,
                           RetinaNet, SingleStageDetector, VFNet)
from .two_stage import (CascadeRCNN, FasterRCNN, FastRCNN, MaskRCNN,
                        TwoStageDetector)

__all__ = ['ATSS', 'CascadeRCNN', 'FCOS', 'FasterRCNN', 'FastRCNN', 'GFL',
           'MaskRCNN', 'NASFCOS', 'RPN', 'RepPointsDetector', 'RetinaNet',
           'SingleStageDetector', 'TwoStageDetector', 'VFNet']
