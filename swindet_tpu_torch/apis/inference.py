"""Inference API (counterpart of ``swindet_tpu/apis/inference.py``:
``init_detector`` :47, ``preprocess_images`` :104, ``format_results``
:160, ``_load_raw`` :203, ``inference_detector`` :212; reference
mmdet/apis/inference.py).

The model is an ``nn.Module`` carrying its config (``model.cfg``) and
class names (``model.CLASSES``), as in mmdet. Images run through the
config's test pipeline on the host, are padded onto the fixed canvas of
the test scale, run on the model's device, and come back as per-class
box arrays and pasted masks.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..checkpoint import load_checkpoint
from ..core.bbox import bbox2result
from ..core.class_names import COCO_CLASSES
from ..core.masks import paste_masks
from ..datasets.pipelines import (Compose, LoadImageFromFile,
                                  LoadImageFromWebcam, MultiScaleFlipAug)
from ..models import build_detector
from ..utils import Config


def init_detector(config: Union[str, Config],
                  checkpoint: Optional[str] = None,
                  device: Union[str, torch.device] = 'cuda',
                  cfg_options: Optional[dict] = None,
                  seed: int = 0) -> torch.nn.Module:
    """Build a detector from a config on ``device``: seeded weights with
    the JAX package's init schemes, or an mmdet-keyed ``.pth`` loaded
    as it is. A config with ``bf16 = True`` computes in bfloat16."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    if cfg_options is not None:
        config.merge_from_dict(cfg_options)
    model_cfg = dict(config.model)
    model_cfg.pop('pretrained', None)
    if config.get('bf16'):
        model_cfg['dtype'] = 'bfloat16'
    model = build_detector(model_cfg)
    model.init_weights(seed)
    classes = None
    if checkpoint is not None:
        classes = load_checkpoint(model, checkpoint).get('CLASSES')
    model.cfg = config
    model.CLASSES = tuple(classes) if classes is not None else COCO_CLASSES
    return model.to(device).eval()


def _test_pipeline(cfg: Config) -> Tuple[Compose, Any]:
    """The test pipeline after its load step (its MultiScaleFlipAug
    included), and the test scale: the first of MultiScaleFlipAug's."""
    steps = [dict(p) for p in cfg.data.test.pipeline]
    if steps[0]['type'] not in ('LoadImageFromFile', 'LoadImageFromWebcam'):
        raise ValueError(f'test pipeline starts with {steps[0]["type"]}')
    pipeline = Compose(steps[1:])
    fan = [t for t in pipeline.transforms if isinstance(t, MultiScaleFlipAug)]
    return pipeline, fan[0].img_scale[0] if fan else None


def _canvas_for(scale: Tuple[int, int], divisor: int = 32
                ) -> Tuple[int, int]:
    """Fixed canvas that covers any keep-ratio resize to ``scale``."""
    rup = lambda v: (v + divisor - 1) // divisor * divisor  # noqa: E731
    return rup(min(scale)), rup(max(scale))


def _load_raw(img: Union[str, np.ndarray]) -> Dict[str, Any]:
    """A file path (read by ``image_io.imread``) or a BGR uint8 array as
    the load step leaves it."""
    if isinstance(img, str):
        return LoadImageFromFile()(dict(img_info=dict(filename=img),
                                        img_prefix=None))
    return LoadImageFromWebcam()(dict(img=img))


def preprocess_images(imgs: Sequence[Union[str, np.ndarray]],
                      cfg: Config) -> Dict[str, Any]:
    """Run the test pipeline on image files or BGR uint8 images and pad
    them onto the test scale's canvas: the first augmentation of
    MultiScaleFlipAug (its first scale, unflipped). Returns numpy img
    (B, H, W, 3), img_shapes (B, 2), scale_factors (B, 4) and per-image
    metas."""
    pipeline, scale = _test_pipeline(cfg)
    processed = []
    for img in imgs:
        r = pipeline(_load_raw(img))
        if isinstance(r['img'], list):
            r = {k: v[0] for k, v in r.items()}
        processed.append(r)
    if scale is not None:
        ch, cw = _canvas_for(scale)
    else:
        ch = max(r['img'].shape[0] for r in processed)
        cw = max(r['img'].shape[1] for r in processed)
        ch, cw = (ch + 31) // 32 * 32, (cw + 31) // 32 * 32
    # a portrait image needs the canvas of both orientations
    if any(r['img'].shape[0] > ch or r['img'].shape[1] > cw
           for r in processed):
        ch = cw = max(ch, cw)
    b = len(processed)
    batch = np.zeros((b, ch, cw, 3), np.float32)
    img_shapes = np.zeros((b, 2), np.int32)
    scale_factors = np.ones((b, 4), np.float32)
    metas = []
    for i, r in enumerate(processed):
        meta = r.get('img_metas', r)
        h, w = r['img'].shape[:2]
        batch[i, :h, :w] = r['img']
        img_shapes[i] = (h, w)
        scale_factors[i] = meta.get('scale_factor', np.ones(4, np.float32))
        metas.append(dict(ori_shape=meta['ori_shape'], img_shape=(h, w),
                          scale_factor=scale_factors[i]))
    return dict(img=batch, img_shapes=img_shapes,
                scale_factors=scale_factors, metas=metas)


def format_results(outputs: Dict[str, np.ndarray], metas: List[dict],
                   num_classes: int, mask_thr: float = 0.5):
    """Padded outputs -> per image a list of ``num_classes`` (k, 5)
    arrays, with a list of per-class pasted masks when there are masks."""
    dets = np.asarray(outputs['dets'])
    labels = np.asarray(outputs['labels'])
    valid = np.asarray(outputs['det_valid']).astype(bool)
    results = []
    for i, meta in enumerate(metas):
        bbox_res = bbox2result(dets[i], labels[i], num_classes, valid[i])
        if 'mask_probs' not in outputs:
            results.append(bbox_res)
            continue
        oh, ow = meta['ori_shape'][:2]
        v = valid[i]
        pm = paste_masks(np.asarray(outputs['mask_probs'][i])[v],
                         dets[i][v, :4], oh, ow, threshold=mask_thr)
        mask_res = [[] for _ in range(num_classes)]
        for m, lab in zip(pm, labels[i][v]):
            mask_res[int(lab)].append(m)
        results.append((bbox_res, mask_res))
    return results


def run_batch(model: torch.nn.Module, batch: Dict[str, Any]
              ) -> Dict[str, np.ndarray]:
    """``simple_test`` on a preprocessed batch; outputs as numpy."""
    dev = next(model.parameters()).device
    with torch.inference_mode():
        out = model.simple_test(
            torch.from_numpy(batch['img']).to(dev),
            torch.from_numpy(batch['img_shapes']).to(dev),
            torch.from_numpy(batch['scale_factors']).to(dev))
    return {k: v.cpu().numpy() for k, v in out.items()}


def inference_detector(model: torch.nn.Module,
                       imgs: Union[str, np.ndarray,
                                   Sequence[Union[str, np.ndarray]]]):
    """Detect on image file(s) or BGR uint8 image(s); returns
    reference-format results (one per image, or one for a single image)."""
    single = isinstance(imgs, (str, np.ndarray))
    if single:
        imgs = [imgs]
    rcnn = dict(model.cfg.model.test_cfg).get('rcnn') or {}
    batch = preprocess_images(imgs, model.cfg)
    out = run_batch(model, batch)
    results = format_results(out, batch['metas'], len(model.CLASSES),
                             dict(rcnn).get('mask_thr_binary', 0.5))
    return results[0] if single else results
