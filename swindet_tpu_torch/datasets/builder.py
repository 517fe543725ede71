"""Dataset and loader construction (counterpart of
``swindet_tpu/datasets/builder.py``: ``build_dataset`` :24,
``GroupBatchSampler`` :44, ``derive_canvas`` :112, ``collate_detection``
:200, ``DetDataLoader`` :411, ``build_dataloader`` :730; reference
mmdet/datasets/builder.py and samplers/group_sampler.py).

Host worker threads run the numpy pipeline. A batch is drawn within one
aspect-ratio group and padded onto that group's static canvas
(landscape or portrait), so the training step sees two shapes, and a
third, square one only for a batch a crop turned round. The JAX
package's C++ batch path (``NativeTrainPlan`` :274, ``_load_batch_native``
:465) is not ported (ROADMAP §1 item 5).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..registries import DATASETS
from ..utils.registry import build_from_cfg
from .custom import sample_rng


def build_dataset(cfg, default_args=None):
    from .dataset_wrappers import (ClassBalancedDataset, ConcatDataset,
                                   RepeatDataset)
    if isinstance(cfg, (list, tuple)):
        return ConcatDataset([build_dataset(c, default_args) for c in cfg])
    if cfg['type'] == 'RepeatDataset':
        return RepeatDataset(build_dataset(cfg['dataset'], default_args),
                             cfg['times'])
    if cfg['type'] == 'ClassBalancedDataset':
        return ClassBalancedDataset(
            build_dataset(cfg['dataset'], default_args),
            cfg['oversample_thr'])
    if cfg['type'] == 'ConcatDataset':
        return ConcatDataset([build_dataset(c, default_args)
                              for c in cfg['datasets']])
    return build_from_cfg(cfg, DATASETS, default_args)


# ------------------------------------------------------------------ sampling
class GroupBatchSampler:
    """Epoch-deterministic batches drawn within one aspect-ratio group
    (flag 0: w <= h, 1: w > h); a shuffled group is topped up to whole
    batches from its own start. (The JAX sampler's ``num_replicas`` /
    ``rank`` sharding waits for DDP, ROADMAP §1 item 5.)"""

    def __init__(self, flags: np.ndarray, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        self.flags = np.asarray(flags)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.RandomState(self.seed + self.epoch)
        batches = []
        bs = self.batch_size
        for g in np.unique(self.flags):
            idxs = np.where(self.flags == g)[0]
            if self.shuffle:
                idxs = idxs[rng.permutation(len(idxs))]
            pad = (-len(idxs)) % bs
            if pad and self.shuffle:
                idxs = np.concatenate([idxs, idxs[:pad]])
            elif pad:
                idxs = idxs[:len(idxs) - len(idxs) % bs] \
                    if len(idxs) >= bs else idxs
            for i in range(0, len(idxs) - bs + 1, bs):
                batches.append(idxs[i:i + bs].tolist())
        if self.shuffle:
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        return iter(batches)

    def __len__(self):
        n = 0
        bs = self.batch_size
        for g in np.unique(self.flags):
            cnt = int((self.flags == g).sum())
            n += (cnt + bs - 1) // bs if self.shuffle else cnt // bs
        return n


# ------------------------------------------------------------------ batching
def _round_up(v: int, d: int) -> int:
    return (v + d - 1) // d * d


_CANVAS_NEUTRAL = {
    'LoadImageFromFile', 'LoadAnnotations', 'LoadProposals',
    'LoadPanopticAnnotations', 'RandomFlip', 'Normalize',
    'PhotoMetricDistortion', 'CutOut', 'Corrupt', 'SegRescale',
    'DefaultFormatBundle', 'ImageToTensor', 'ToTensor', 'Collect',
    'FilterAnnotations', 'InstaBoost',
}


def derive_canvas(pipeline,
                  default: Tuple[int, int] = (1344, 832),
                  divisor_default: int = 32) -> Tuple[int, int]:
    """The static train canvas (long, short) of a pipeline config: the
    declared geometric transforms walked in order, tracking a bound on
    the output size, rounded up to the Pad divisor; ``default`` where a
    transform cannot be bounded. (A small-resolution config on COCO's
    default canvas would be almost all padding, whose constant tokens
    blow up LayerNorm's gradients.)"""
    divisor = divisor_default

    def scale_bound(p):
        scales = p.get('img_scale')
        if scales is None:
            return None
        if isinstance(scales, (tuple, list)) and scales and \
                not isinstance(scales[0], (tuple, list)):
            scales = [tuple(scales)]
        lo = max(max(s) for s in scales)
        sh = max(min(s) for s in scales)
        rr = p.get('ratio_range')
        if rr:
            lo = int(np.ceil(lo * max(rr)))
            sh = int(np.ceil(sh * max(rr)))
        return (lo, sh)

    def walk(steps, bound):
        nonlocal divisor
        for p in steps:
            t = p.get('type')
            if t in _CANVAS_NEUTRAL:
                continue
            if t == 'Resize':
                b = scale_bound(p)
                if b is None:
                    return None     # a Resize driven by runtime scales
                bound = b
            elif t == 'RandomCrop':
                cs = p.get('crop_size')
                if cs is None:
                    return None
                b = (max(cs), min(cs))
                bound = b if bound is None else (min(bound[0], b[0]),
                                                 min(bound[1], b[1]))
            elif t == 'RandomCenterCropPad':
                cs = p.get('crop_size')
                if cs is None:
                    return None
                bound = (max(cs), min(cs))
            elif t == 'Pad':
                if p.get('size') is not None:
                    s = p['size']
                    b = (max(s), min(s))
                    bound = b if bound is None else (
                        max(bound[0], b[0]), max(bound[1], b[1]))
                if p.get('size_divisor'):
                    divisor = max(divisor, int(p['size_divisor']))
            elif t == 'AutoAugment':
                bs = [walk(branch, bound)
                      for branch in p.get('policies', [])]
                if any(b is None for b in bs) or not bs:
                    return None
                bound = (max(b[0] for b in bs), max(b[1] for b in bs))
            elif t == 'Expand':
                bound = None    # bounded again only by a later Resize
            elif t == 'MinIoURandomCrop':
                pass            # keeps or shrinks the bound
            else:
                return None     # a transform it cannot bound
        return bound

    bound = walk(pipeline or [], None)
    if bound is None:
        bound = default
    return (_round_up(int(bound[0]), divisor),
            _round_up(int(bound[1]), divisor))


def collate_detection(samples: List[dict], canvas: Tuple[int, int],
                      max_gts: int = 100,
                      with_mask: bool = True) -> Dict[str, np.ndarray]:
    """Pad pipeline outputs onto one static (H, W) canvas: the train
    batch dict (img, img_shapes, pad_shapes, gt_bboxes, gt_valid,
    gt_labels[, gt_masks][, gt_semantic_seg], img_metas). A batch that
    does not fit ``canvas`` (AutoAugment's crop branch can turn a
    sample's orientation round) goes on the square max(H, W) canvas.
    Semantic label maps (HTC) go on a uint8 canvas of 255 (ignored) at
    the canvas size over their stride, the ratio of the first sample's
    image height to its map's, as the JAX package's collate does
    (``swindet_tpu/datasets/builder.py:255-269``)."""
    b = len(samples)
    ch, cw = canvas
    if max(s['img'].shape[0] for s in samples) > ch \
            or max(s['img'].shape[1] for s in samples) > cw:
        ch = cw = max(ch, cw)
    img = np.zeros((b, ch, cw, 3), np.float32)
    img_shapes = np.zeros((b, 2), np.int32)
    pad_shapes = np.zeros((b, 2), np.int32)
    gt_bboxes = np.zeros((b, max_gts, 4), np.float32)
    gt_valid = np.zeros((b, max_gts), bool)
    gt_labels = np.zeros((b, max_gts), np.int32)
    if with_mask:
        gt_masks = np.zeros((b, max_gts, ch, cw), np.uint8)
    for i, s in enumerate(samples):
        h, w = s['img'].shape[:2]
        img[i, :h, :w] = s['img']
        img_shapes[i] = s['img_metas'].get('img_shape', (h, w))[:2]
        pad_shapes[i] = (h, w)
        n = min(len(s.get('gt_bboxes', ())), max_gts)
        if n:
            gt_bboxes[i, :n] = s['gt_bboxes'][:n]
            gt_valid[i, :n] = True
            gt_labels[i, :n] = s['gt_labels'][:n]
            if with_mask and 'gt_masks' in s:
                m = s['gt_masks'][:n]
                gt_masks[i, :n, :m.shape[1], :m.shape[2]] = m
    batch = dict(img=img, img_shapes=img_shapes, pad_shapes=pad_shapes,
                 gt_bboxes=gt_bboxes, gt_valid=gt_valid,
                 gt_labels=gt_labels)
    if with_mask:
        batch['gt_masks'] = gt_masks
    seg_samples = [s for s in samples if 'gt_semantic_seg' in s]
    if seg_samples:
        stride = max(round(samples[0]['img'].shape[0]
                           / seg_samples[0]['gt_semantic_seg'].shape[0]), 1)
        sh, sw = ch // stride, cw // stride
        seg = np.full((b, sh, sw), 255, np.uint8)
        for i, s in enumerate(samples):
            if 'gt_semantic_seg' in s:
                g = s['gt_semantic_seg'][:sh, :sw]
                seg[i, :g.shape[0], :g.shape[1]] = g
        batch['gt_semantic_seg'] = seg
    batch['img_metas'] = [s['img_metas'] for s in samples]
    return batch


class DetDataLoader:
    """Threaded loader yielding static-shape numpy batches in the
    sampler's order.

    Group-aware: every batch comes from one aspect-ratio group and is
    padded to that group's canvas (landscape (short, long), portrait
    (long, short)). Sample ``i`` of epoch ``e`` draws from
    ``sample_rng(seed, e, i)``, so a batch is the same whichever thread
    loads it. ``num_workers`` threads load whole batches and run at most
    ``prefetch`` batches ahead of the consumer.
    """

    def __init__(self, dataset, batch_size: int,
                 canvas_long: int = 1344, canvas_short: int = 832,
                 max_gts: int = 100, with_mask: bool = True,
                 seed: int = 0, shuffle: bool = True, num_workers: int = 4,
                 prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.canvas_long = canvas_long
        self.canvas_short = canvas_short
        self.max_gts = max_gts
        self.with_mask = with_mask
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self._epoch = 0
        flags = getattr(dataset, 'flag',
                        np.zeros(len(dataset), np.uint8))
        self.sampler = GroupBatchSampler(flags, batch_size, seed, shuffle)
        self.flags = flags

    def __len__(self):
        return len(self.sampler)

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        self.sampler.set_epoch(epoch)

    def _canvas_for(self, idx: int) -> Tuple[int, int]:
        if self.flags[idx] == 1:  # landscape, w > h
            return self.canvas_short, self.canvas_long
        return self.canvas_long, self.canvas_short

    def _load_batch(self, indices: List[int]) -> Dict[str, np.ndarray]:
        samples = [self.dataset.get(i, sample_rng(self.seed, self._epoch, i))
                   for i in indices]
        return collate_detection(samples,
                                 canvas=self._canvas_for(indices[0]),
                                 max_gts=self.max_gts,
                                 with_mask=self.with_mask)

    def __iter__(self):
        batches = list(self.sampler)
        results: Dict[int, object] = {}
        cond = threading.Condition()
        state = {'next_put': 0, 'taken': 0, 'stop': False}

        def worker():
            while True:
                with cond:
                    # stay within ``prefetch`` batches of the consumer
                    while (not state['stop'] and state['next_put']
                           >= state['taken'] + self.prefetch):
                        cond.wait(timeout=60)
                    if state['stop'] or state['next_put'] >= len(batches):
                        return
                    ticket = state['next_put']
                    state['next_put'] += 1
                try:
                    out = self._load_batch(batches[ticket])
                except Exception as e:  # raised again in the consumer
                    out = e
                with cond:
                    results[ticket] = out
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with cond:
                    while i not in results:
                        cond.wait(timeout=60)
                    out = results.pop(i)
                    state['taken'] = i + 1
                    cond.notify_all()
                if isinstance(out, Exception):
                    raise out
                yield out
        finally:
            with cond:
                state['stop'] = True
                cond.notify_all()
            for t in threads:
                t.join(timeout=60)


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int,
                     num_gpus: int = 1, dist: bool = False, seed: int = 0,
                     shuffle: bool = True, **kwargs) -> DetDataLoader:
    """mmdet's surface (reference datasets/builder.py:76) on one card."""
    if dist:
        raise NotImplementedError('build_dataloader: distributed loading '
                                  'is not ported (ROADMAP §1 item 5)')
    return DetDataLoader(dataset, batch_size=samples_per_gpu * num_gpus,
                         seed=seed, shuffle=shuffle,
                         num_workers=workers_per_gpu, **kwargs)
