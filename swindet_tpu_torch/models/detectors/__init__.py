from .two_stage import CascadeRCNN, MaskRCNN, TwoStageDetector

__all__ = ['CascadeRCNN', 'MaskRCNN', 'TwoStageDetector']
