from .assigners import (AssignResult, ATSSAssigner, MaxIoUAssigner,
                        PointAssigner, add_gt_as_candidates)
from .coders import (DeltaXYWHBBoxCoder, bbox2delta, bbox2distance,
                     delta2bbox, distance2bbox)
from .iou import bbox_overlaps
from .samplers import PseudoSampler, RandomSampler, SamplingResult
from .transforms import bbox2result

__all__ = ['AssignResult', 'ATSSAssigner', 'MaxIoUAssigner', 'PointAssigner',
           'add_gt_as_candidates',
           'DeltaXYWHBBoxCoder', 'bbox2delta', 'bbox2distance', 'delta2bbox',
           'distance2bbox',
           'bbox_overlaps', 'PseudoSampler', 'RandomSampler', 'SamplingResult',
           'bbox2result']
