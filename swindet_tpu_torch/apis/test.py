"""Evaluation loop (counterpart of ``swindet_tpu/apis/test.py``:
``_round_up`` :24, ``single_gpu_test`` :143-243, ``_tta_test`` :245-310;
reference mmdet/apis/test.py:16 single_gpu_test).

Every image of a test-mode dataset runs through its test pipeline on the
host first. The images are then grouped by orientation (portrait, then
landscape) and each group is padded onto one canvas, its largest height
and width each rounded up to 32, as the JAX package pads them: the Swin
window partition sees that padding, so the canvas decides the numbers.
A group runs in batches of ``batch_size`` images in dataset order; a
batch's outputs come back to the host, masks are pasted into each
original image and encoded as COCO RLE (as mmdet's single_gpu_test
does), and results are returned in dataset order.

A pipeline whose MultiScaleFlipAug gives more than one augmentation runs
test-time augmentation (``apis/aug_test.py``, the two-stage or the
single-stage merge): one canvas per (orientation, augmentation), the
merged detections in the original frame.

The model runs where its parameters are. The native batched loader of
the JAX package (``SWINDET_NATIVE_IMAGE=1``) is not ported.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.masks import encode_mask_results
from .aug_test import aug_test_single_stage, aug_test_two_stage
from .inference import format_results


def _round_up(v: int, d: int = 32) -> int:
    return (v + d - 1) // d * d


def _aug(r: Dict, a: int) -> Tuple[np.ndarray, Dict]:
    """Augmentation ``a`` of a pipeline output: its image and metas (those
    that Collect gathered, or the output's own keys)."""
    pick = lambda v: v[a] if isinstance(v, list) else v  # noqa: E731
    if 'img_metas' in r:
        return pick(r['img']), dict(pick(r['img_metas']))
    return pick(r['img']), {k: pick(v) for k, v in r.items() if k != 'img'}


def _add(times: Optional[Dict[str, float]], key: str, t0: float) -> float:
    t1 = time.perf_counter()
    if times is not None:
        times[key] = times.get(key, 0.0) + t1 - t0
    return t1


def _batch(processed: List[Dict], chunk: List[int], a: int,
           canvas: Tuple[int, int], device: torch.device) -> Dict:
    """Augmentation ``a`` of the images of ``chunk`` padded onto
    ``canvas``, on ``device``."""
    b = len(chunk)
    img = np.zeros((b, *canvas, 3), np.float32)
    shapes = np.ones((b, 2), np.int32)
    sfs = np.ones((b, 4), np.float32)
    for j, i in enumerate(chunk):
        im, meta = _aug(processed[i], a)
        h, w = im.shape[:2]
        img[j, :h, :w] = im
        shapes[j] = (h, w)
        sfs[j] = meta.get('scale_factor', np.ones(4, np.float32))
    _, meta0 = _aug(processed[chunk[0]], a)
    to = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return dict(img=to(img), img_shapes=to(shapes), scale_factors=to(sfs),
                flip=bool(meta0.get('flip', False)),
                flip_direction=meta0.get('flip_direction') or 'horizontal')


def eval_batches(model: torch.nn.Module, dataset, batch_size: int = 8,
                 times: Optional[Dict[str, float]] = None
                 ) -> Iterator[Tuple[List[int], Dict[str, np.ndarray],
                                     List[Dict]]]:
    """The batches of an evaluation: (dataset indices, the model's padded
    outputs as numpy, each image's metas for ``format_results``). The
    outputs are in each image's original frame. ``times``, when given,
    gains the seconds of the pipeline ('pipeline') and of the batches'
    copy to the device, the model and its outputs' copy back ('device')."""
    if os.environ.get('SWINDET_NATIVE_IMAGE') == '1':
        raise NotImplementedError('single_gpu_test: the native batched test '
                                  'loader (SWINDET_NATIVE_IMAGE=1) is not '
                                  'ported (ROADMAP §1 item 4)')
    device = next(model.parameters()).device
    t0 = time.perf_counter()
    processed = [dataset[i] for i in range(len(dataset))]
    groups: Dict[int, List[int]] = {0: [], 1: []}
    for i, r in enumerate(processed):
        h, w = _aug(r, 0)[0].shape[:2]
        groups[1 if w >= h else 0].append(i)
    t0 = _add(times, 'pipeline', t0)
    for idxs in groups.values():
        if not idxs:
            continue
        img0 = processed[idxs[0]]['img']
        n_aug = len(img0) if isinstance(img0, list) else 1
        # a two-stage detector has the RPN's half, a single-stage one only
        # the bbox half (swindet_tpu/apis/test.py:181-185)
        aug_test = aug_test_two_stage if hasattr(model, 'aug_rpn_test') \
            else aug_test_single_stage if hasattr(model, 'aug_bbox_test') \
            else None
        if n_aug > 1 and aug_test is None:
            raise NotImplementedError(
                f'{type(model).__name__} has no test-time augmentation '
                f'path')
        canvases = [(_round_up(max(_aug(processed[i], a)[0].shape[0]
                                   for i in idxs)),
                     _round_up(max(_aug(processed[i], a)[0].shape[1]
                                   for i in idxs))) for a in range(n_aug)]
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s:s + batch_size]
            t0 = time.perf_counter()
            batches = [_batch(processed, chunk, a, canvases[a], device)
                       for a in range(n_aug)]
            with torch.inference_mode():
                if n_aug > 1:
                    out = aug_test(model, batches)
                else:
                    out = model.simple_test(batches[0]['img'],
                                            batches[0]['img_shapes'],
                                            batches[0]['scale_factors'])
                out = {k: v.cpu().numpy() for k, v in out.items()}
            _add(times, 'device', t0)
            metas = []
            for i in chunk:
                im, meta = _aug(processed[i], 0)
                # merged detections are in the original frame already
                metas.append(dict(
                    ori_shape=meta['ori_shape'], img_shape=im.shape[:2],
                    scale_factor=np.ones(4, np.float32) if n_aug > 1
                    else meta.get('scale_factor', np.ones(4, np.float32))))
            yield chunk, out, metas


def single_gpu_test(model: torch.nn.Module, dataset, batch_size: int = 8,
                    show: bool = False, out_dir: Optional[str] = None,
                    logger=None, times: Optional[Dict[str, float]] = None
                    ) -> List:
    """Every image of a test-mode ``dataset`` through ``model``. Returns per
    image, in dataset order, a list of per-class (k, 5) box arrays, with a
    list of per-class RLE masks beside it when the model has a mask head.
    ``times``, when given, gains the seconds of each stage: 'pipeline',
    'device', 'paste' (masks into each image) and 'encode' (RLE)."""
    if show or out_dir:
        raise NotImplementedError('single_gpu_test: drawing results '
                                  '(show_result) is not ported '
                                  '(ROADMAP §1 item 6)')
    classes = getattr(model, 'CLASSES', None) or dataset.CLASSES
    rcnn = dict(model.test_cfg).get('rcnn') or {}
    mask_thr = dict(rcnn).get('mask_thr_binary', 0.5)
    results: List = [None] * len(dataset)
    start = time.perf_counter()
    done = 0
    for chunk, out, metas in eval_batches(model, dataset, batch_size, times):
        t0 = time.perf_counter()
        batch_results = format_results(out, metas, len(classes), mask_thr)
        t0 = _add(times, 'paste', t0)
        if 'mask_probs' in out:
            batch_results = [(bbox, encode_mask_results(masks))
                             for bbox, masks in batch_results]
        _add(times, 'encode', t0)
        for i, res in zip(chunk, batch_results):
            results[i] = res
        done += len(chunk)
        if logger is not None:
            logger.info(f'test [{done}/{len(dataset)}] '
                        f'{done / (time.perf_counter() - start):.1f} img/s')
    return results
