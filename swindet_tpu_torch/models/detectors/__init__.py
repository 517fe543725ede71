from .rpn import RPN
from .single_stage import (ATSS, FCOS, GFL, NASFCOS, PAA,
                           KnowledgeDistillationSingleStageDetector,
                           RepPointsDetector, RetinaNet, SingleStageDetector,
                           VFNet)
from .two_stage import (CascadeRCNN, FasterRCNN, FastRCNN,
                        HybridTaskCascade, MaskRCNN, TwoStageDetector)

__all__ = ['ATSS', 'CascadeRCNN', 'FCOS', 'FasterRCNN', 'FastRCNN', 'GFL',
           'HybridTaskCascade', 'KnowledgeDistillationSingleStageDetector',
           'MaskRCNN', 'NASFCOS', 'PAA', 'RPN', 'RepPointsDetector',
           'RetinaNet', 'SingleStageDetector', 'TwoStageDetector', 'VFNet']
