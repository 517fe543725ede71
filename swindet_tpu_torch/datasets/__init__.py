"""Datasets, pipelines and the loader of the port (counterpart of
``swindet_tpu/datasets/``)."""
from ..registries import DATASETS, PIPELINES
from . import pipelines
from .builder import (DetDataLoader, GroupBatchSampler, build_dataloader,
                      build_dataset, collate_detection, derive_canvas)
from .coco import CocoDataset
from .custom import CustomDataset, sample_rng
from .dataset_wrappers import (ClassBalancedDataset, ConcatDataset,
                               RepeatDataset)

__all__ = ['DATASETS', 'PIPELINES', 'pipelines', 'DetDataLoader',
           'GroupBatchSampler', 'build_dataloader', 'build_dataset',
           'collate_detection', 'derive_canvas', 'CocoDataset',
           'CustomDataset', 'sample_rng', 'ClassBalancedDataset',
           'ConcatDataset', 'RepeatDataset']
