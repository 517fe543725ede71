"""Base detection dataset (counterpart of ``swindet_tpu/datasets/custom.py:17``;
reference mmdet/datasets/custom.py:16): annotation loading, the filter of
empty and small images, the aspect-ratio group flag and the train-time
redraw of a sample the pipeline drops.

Randomness is explicit: :meth:`CustomDataset.get` takes the sample's own
``np.random.RandomState`` (:func:`sample_rng`), puts it in the pipeline's
``results['_rng']``, where every random transform draws from it, and
draws the redraw's index from it too.
"""
from __future__ import annotations

import json
import os.path as osp
from typing import List, Optional, Sequence

import numpy as np

from ..registries import DATASETS
from .pipelines import Compose


def sample_rng(seed: int, epoch: int, idx: int) -> np.random.RandomState:
    """The generator of sample ``idx`` in ``epoch`` of a run seeded with
    ``seed``: a Mersenne Twister keyed by ``SeedSequence([seed, epoch,
    idx])``, so every sample of every epoch draws its own numbers, in any
    order and on any worker thread."""
    return np.random.RandomState(np.random.MT19937(
        np.random.SeedSequence([int(seed), int(epoch), int(idx)])))


@DATASETS.register_module()
class CustomDataset:
    """Annotation format::

        [{'filename': 'a.jpg', 'width': 1280, 'height': 720,
          'ann': {'bboxes': (n, 4) float32 [x1,y1,x2,y2],
                  'labels': (n,) int64,
                  'bboxes_ignore': (k, 4), 'labels_ignore': (k,)}}, ...]
    """

    CLASSES: Optional[Sequence[str]] = None

    def __init__(self,
                 ann_file: str,
                 pipeline: List[dict],
                 classes: Optional[Sequence[str]] = None,
                 data_root: Optional[str] = None,
                 img_prefix: str = '',
                 seg_prefix: Optional[str] = None,
                 proposal_file: Optional[str] = None,
                 test_mode: bool = False,
                 filter_empty_gt: bool = True):
        self.ann_file = ann_file
        self.data_root = data_root
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix
        self.proposal_file = proposal_file
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.CLASSES = self.get_classes(classes)

        if self.data_root is not None:
            if not osp.isabs(self.ann_file):
                self.ann_file = osp.join(self.data_root, self.ann_file)
            if not (self.img_prefix is None or osp.isabs(self.img_prefix)):
                self.img_prefix = osp.join(self.data_root, self.img_prefix)

        self.data_infos = self.load_annotations(self.ann_file)

        if not test_mode:
            valid_inds = self._filter_imgs()
            self.data_infos = [self.data_infos[i] for i in valid_inds]
            self._set_group_flag()
        else:
            self.flag = np.zeros(len(self.data_infos), np.uint8)

        self.pipeline = Compose(pipeline)

    def __len__(self):
        return len(self.data_infos)

    @classmethod
    def get_classes(cls, classes=None):
        if classes is None:
            return cls.CLASSES
        if isinstance(classes, str):
            with open(classes) as f:
                return [line.strip() for line in f]
        return list(classes)

    # ------------------------------------------------------------ loading
    def load_annotations(self, ann_file):
        with open(ann_file) as f:
            return json.load(f)

    def get_ann_info(self, idx):
        return self.data_infos[idx]['ann']

    def get_cat_ids(self, idx):
        return self.data_infos[idx]['ann']['labels'].astype(int).tolist()

    def _filter_imgs(self, min_size=32):
        """Indices of the images with ground truth (when
        ``filter_empty_gt``) whose shorter side is at least ``min_size``."""
        valid_inds = []
        for i, info in enumerate(self.data_infos):
            if self.filter_empty_gt and len(
                    info.get('ann', {}).get('labels', [])) == 0:
                continue
            if min(info['width'], info['height']) >= min_size:
                valid_inds.append(i)
        return valid_inds

    def _set_group_flag(self):
        """flag 1 if w / h > 1 else 0: a batch is drawn within one group,
        so its images share a canvas orientation."""
        self.flag = np.zeros(len(self), np.uint8)
        for i in range(len(self)):
            info = self.data_infos[i]
            if info['width'] / info['height'] > 1:
                self.flag[i] = 1

    # ------------------------------------------------------------ access
    def pre_pipeline(self, results):
        results['img_prefix'] = self.img_prefix
        results['seg_prefix'] = self.seg_prefix
        results['proposal_file'] = self.proposal_file
        results['bbox_fields'] = []
        results['mask_fields'] = []
        results['seg_fields'] = []

    def prepare_train_img(self, idx, rng: np.random.RandomState):
        results = dict(img_info=self.data_infos[idx],
                       ann_info=self.get_ann_info(idx), _rng=rng)
        self.pre_pipeline(results)
        return self.pipeline(results)

    def prepare_test_img(self, idx):
        results = dict(img_info=self.data_infos[idx])
        self.pre_pipeline(results)
        return self.pipeline(results)

    def _rand_another(self, idx, rng: np.random.RandomState):
        pool = np.where(self.flag == self.flag[idx])[0]
        return int(rng.choice(pool))

    def get(self, idx, rng: np.random.RandomState):
        """Sample ``idx`` through the pipeline, drawing from ``rng``; in
        training, a sample the pipeline drops (None) is replaced by
        another of its group, drawn from ``rng``, until one passes."""
        if self.test_mode:
            return self.prepare_test_img(idx)
        while True:
            data = self.prepare_train_img(idx, rng)
            if data is None:
                idx = self._rand_another(idx, rng)
                continue
            return data

    def __getitem__(self, idx):
        return self.get(idx, sample_rng(0, 0, idx))
