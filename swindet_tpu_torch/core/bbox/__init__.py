from .assigners import AssignResult, MaxIoUAssigner, add_gt_as_candidates
from .coders import DeltaXYWHBBoxCoder, bbox2delta, delta2bbox
from .iou import bbox_overlaps
from .samplers import RandomSampler, SamplingResult
from .transforms import bbox2result

__all__ = ['AssignResult', 'MaxIoUAssigner', 'add_gt_as_candidates',
           'DeltaXYWHBBoxCoder', 'bbox2delta', 'delta2bbox',
           'bbox_overlaps', 'RandomSampler', 'SamplingResult',
           'bbox2result']
