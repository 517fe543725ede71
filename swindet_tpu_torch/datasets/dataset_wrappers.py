"""Dataset wrappers (counterpart of
``swindet_tpu/datasets/dataset_wrappers.py``: ``ConcatDataset`` :15,
``RepeatDataset`` :40, ``ClassBalancedDataset`` :61; reference
mmdet/datasets/dataset_wrappers.py). Each passes the sample's generator
on to the dataset it wraps (:meth:`get`)."""
from __future__ import annotations

import bisect
import math
from collections import defaultdict

import numpy as np

from ..registries import DATASETS
from .custom import sample_rng


class _Wrapper:
    def __getitem__(self, idx):
        return self.get(idx, sample_rng(0, 0, idx))


@DATASETS.register_module()
class ConcatDataset(_Wrapper):

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.CLASSES = self.datasets[0].CLASSES
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()
        if all(hasattr(d, 'flag') for d in self.datasets):
            self.flag = np.concatenate([d.flag for d in self.datasets])

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx):
        di = bisect.bisect_right(self.cumulative_sizes, idx)
        return di, idx if di == 0 else idx - self.cumulative_sizes[di - 1]

    def get(self, idx, rng):
        di, si = self._locate(idx)
        return self.datasets[di].get(si, rng)

    def get_cat_ids(self, idx):
        di, si = self._locate(idx)
        return self.datasets[di].get_cat_ids(si)


@DATASETS.register_module()
class RepeatDataset(_Wrapper):

    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times
        self.CLASSES = dataset.CLASSES
        if hasattr(dataset, 'flag'):
            self.flag = np.tile(dataset.flag, times)
        self._ori_len = len(dataset)

    def __len__(self):
        return self.times * self._ori_len

    def get(self, idx, rng):
        return self.dataset.get(idx % self._ori_len, rng)

    def get_cat_ids(self, idx):
        return self.dataset.get_cat_ids(idx % self._ori_len)


@DATASETS.register_module()
class ClassBalancedDataset(_Wrapper):
    """Repeat each image ceil(r) times, r the largest over its categories
    of max(1, sqrt(oversample_thr / f)), f the share of images holding the
    category (the LVIS paper's eq. 1)."""

    def __init__(self, dataset, oversample_thr, filter_empty_gt=True):
        self.dataset = dataset
        self.oversample_thr = oversample_thr
        self.CLASSES = dataset.CLASSES

        repeat_factors = self._get_repeat_factors(dataset, oversample_thr)
        repeat_indices = []
        for di, rf in enumerate(repeat_factors):
            repeat_indices.extend([di] * math.ceil(rf))
        self.repeat_indices = repeat_indices
        if hasattr(dataset, 'flag'):
            self.flag = np.asarray(
                [dataset.flag[i] for i in repeat_indices], np.uint8)

    def _get_repeat_factors(self, dataset, repeat_thr):
        category_freq = defaultdict(float)
        num_images = len(dataset)
        for idx in range(num_images):
            for cat_id in set(dataset.get_cat_ids(idx)):
                category_freq[cat_id] += 1
        for k in category_freq:
            category_freq[k] /= num_images
        category_repeat = {
            cat_id: max(1.0, math.sqrt(repeat_thr / cat_freq))
            for cat_id, cat_freq in category_freq.items()}
        return [max({category_repeat[c] for c in set(dataset.get_cat_ids(i))},
                    default=1.0) for i in range(num_images)]

    def __len__(self):
        return len(self.repeat_indices)

    def get(self, idx, rng):
        return self.dataset.get(self.repeat_indices[idx], rng)
