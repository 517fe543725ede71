"""The port's test tools against the JAX package's on the CPU, with the
tiny Mask R-CNN of tests/test_torch_slice.py in fp32 on the same numpy
weights (``rpn_cls`` and ``fc_cls`` spread) and the same PNG files of a
COCO-style dataset (2 landscape, 2 portrait): MultiScaleFlipAug's
output, ``single_gpu_test`` and its canvases, test-time augmentation
(flip and 2 scales), ``inference_detector`` on a file path, the eval
hook of ``train_detector`` with a resumed run, and the test and train
CLIs in-process. Detections at tests/test_torch_slice.py's tolerances
(boxes 1e-3 px, scores 1e-4, labels exact); masks are pasted from
probabilities within 1e-4 of the JAX package's and must be equal."""
import json
import os

import numpy as np
import pytest
import torch

from swindet_tpu import native as jax_native
from swindet_tpu.apis import aug_test as jax_aug_test
from swindet_tpu.apis import test as jax_test
from swindet_tpu.apis.inference import DetectorHandle
from swindet_tpu.datasets import build_dataset as jax_build_dataset
from swindet_tpu.datasets.pipelines.transforms import Compose as JaxCompose
from swindet_tpu.utils import Config as JaxConfig

from tests.test_models.test_forward import tiny_maskrcnn_cfg
from tests.test_torch_checkpoint import jax_detector_params
from tests.test_torch_loop import loop_cfg
from tests.torch_threads import cap_torch_threads, default_threads

from swindet_tpu_torch.apis import (inference_detector, init_detector,
                                    single_gpu_test, train_detector)
from swindet_tpu_torch.apis import test as port_test
from swindet_tpu_torch.checkpoint import save_checkpoint, state_dict_from_jax
from swindet_tpu_torch.core import rle
from swindet_tpu_torch.datasets import build_dataset
from swindet_tpu_torch.datasets.image_io import imread
from swindet_tpu_torch.datasets.pipelines import Compose
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.tools import test as test_cli
from swindet_tpu_torch.tools import train as train_cli
from swindet_tpu_torch.utils import Config

from chip_smoke import write_synthetic_coco

cap_torch_threads()

CLASSES = ('a', 'b', 'c', 'd')
# 2 landscape, 2 portrait images
SIZES = ((60, 90), (72, 100), (90, 60), (100, 72))
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


def eval_pipeline(scales=(128, 96), flip=False, collect=True):
    steps = [dict(type='Resize', keep_ratio=True), dict(type='RandomFlip'),
             dict(type='Normalize', **NORM),
             dict(type='Pad', size_divisor=32),
             dict(type='ImageToTensor', keys=['img'])]
    if collect:
        steps.append(dict(type='Collect', keys=['img']))
    return [dict(type='LoadImageFromFile'),
            dict(type='MultiScaleFlipAug', img_scale=scales, flip=flip,
                 transforms=steps)]


TTA = dict(scales=[(128, 96), (128, 64)], flip=True)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """The dataset on disk, the JAX handle and the port model on the same
    weights. The JAX package pastes with its numpy path here."""
    root = str(tmp_path_factory.mktemp('coco'))
    ann, prefix = write_synthetic_coco(root, SIZES, seed=0,
                                       class_names=CLASSES)
    cfg = tiny_maskrcnn_cfg()
    jm, params = jax_detector_params(cfg, seed=0)
    handle = DetectorHandle(JaxConfig(dict(model=cfg)), jm,
                            {'params': params}, CLASSES=CLASSES)
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    port.eval()
    return dict(root=root, ann=ann, prefix=prefix, cfg=cfg, handle=handle,
                port=port, sd=state_dict_from_jax(params))


def _data(setup, **kw):
    return dict(type='CocoDataset', ann_file=setup['ann'],
                img_prefix=setup['prefix'], classes=CLASSES,
                pipeline=eval_pipeline(**kw), test_mode=True)


def _assert_results_equal(got, want):
    assert len(got) == len(want) == len(SIZES)
    n = 0
    for (gb, gm), (wb, wm) in zip(got, want):
        assert len(gb) == len(wb) == len(gm) == len(CLASSES)
        for c in range(len(CLASSES)):
            assert gb[c].shape == wb[c].shape
            np.testing.assert_allclose(gb[c][:, :4], wb[c][:, :4], rtol=0,
                                       atol=1e-3)
            np.testing.assert_allclose(gb[c][:, 4], wb[c][:, 4], rtol=0,
                                       atol=1e-4)
            assert len(gm[c]) == len(wm[c]) == len(gb[c])
            for g, w in zip(gm[c], wm[c]):
                assert isinstance(g['counts'], bytes)
                assert np.array_equal(rle.decode(g).astype(bool), w)
            n += len(gb[c])
    assert n >= 16


def _record(monkeypatch, module, name, shapes_of):
    """Wrap module.name to append each call's canvases to a list."""
    seen = []
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        seen.append(shapes_of(*args))
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.mark.parametrize('flip', [False, True])
def test_multi_scale_flip_aug_matches_jax(setup, flip):
    """Every augmentation's image and metas from the JAX package's
    pipeline, bit for bit."""
    scales = TTA['scales'] if flip else (128, 96)
    steps = eval_pipeline(scales, flip, collect=False)
    name = os.path.join(setup['prefix'], '0002.png')
    results = [dict(img_info=dict(filename=name), img_prefix=None)
               for _ in range(2)]
    got = Compose(steps)(results[0])
    want = JaxCompose(steps)(results[1])
    n_aug = 4 if flip else 1
    assert len(got['img']) == len(want['img']) == n_aug
    for a in range(n_aug):
        assert got['img'][a].dtype == np.float32
        assert np.array_equal(got['img'][a], want['img'][a])
        for k in ('img_shape', 'ori_shape', 'pad_shape', 'flip',
                  'flip_direction', 'scale'):
            assert got[k][a] == want[k][a], k
        assert np.array_equal(got['scale_factor'][a], want['scale_factor'][a])
    assert got['flip'] == ([False, True] * 2 if flip else [False])


def test_single_gpu_test_matches_jax(setup, monkeypatch):
    """Results and canvases: portrait group (1 batch on 128x96), then
    landscape (96x128), each its largest padded image rounded to 32. The
    masks must be bit-equal, and a mask pixel on the 0.5 threshold flips
    with torch's summation order, which follows its thread count: the
    port runs at torch's default count here, as before the tests' cap
    (ROADMAP §3 item 4)."""
    with default_threads():
        _single_gpu_test_matches_jax(setup, monkeypatch)


def _single_gpu_test_matches_jax(setup, monkeypatch):
    monkeypatch.setattr(jax_native, 'available', lambda: False)
    handle = setup['handle']
    run = handle.jitted_simple_test()
    jax_canvases = []

    def jax_run(v, img, *a):
        jax_canvases.append(tuple(img.shape[1:3]))
        return run(v, img, *a)
    monkeypatch.setattr(handle, 'jitted_simple_test', lambda: jax_run)
    port = setup['port']
    canvases = _record(monkeypatch, port, 'simple_test',
                       lambda img, *a: tuple(img.shape[1:3]))
    want = jax_test.single_gpu_test(handle, jax_build_dataset(_data(setup)),
                                    batch_size=2)
    times = {}
    got = single_gpu_test(port, build_dataset(_data(setup)), 2, times=times)
    _assert_results_equal(got, want)
    assert canvases == jax_canvases == [(128, 96), (96, 128)]
    assert set(times) == {'pipeline', 'device', 'paste', 'encode'}


def test_tta_matches_jax(setup, monkeypatch):
    """Flip and 2 scales, 4 augmentations merged: results equal the JAX
    package's _tta_test, with its canvases (one per orientation and
    augmentation), and the pipeline with Collect gives the same."""
    monkeypatch.setattr(jax_native, 'available', lambda: False)
    shapes = lambda model, batches: [  # noqa: E731
        tuple(b['img'].shape[1:3]) for b in batches]
    jax_canvases = _record(monkeypatch, jax_aug_test, 'aug_test_two_stage',
                           shapes)
    canvases = _record(monkeypatch, port_test, 'aug_test_two_stage', shapes)
    want = jax_test.single_gpu_test(
        setup['handle'], jax_build_dataset(_data(setup, collect=False,
                                                 **TTA)), batch_size=2)
    got = single_gpu_test(setup['port'], build_dataset(
        _data(setup, collect=False, **TTA)), 2)
    _assert_results_equal(got, want)
    assert canvases == jax_canvases == [
        [(128, 96), (128, 96), (96, 64), (96, 64)],
        [(96, 128), (96, 128), (64, 96), (64, 96)]]
    collected = single_gpu_test(setup['port'], build_dataset(
        _data(setup, **TTA)), 2)
    for (gb, gm), (cb, cm) in zip(got, collected):
        assert all(np.array_equal(a, b) for a, b in zip(gb, cb))
        assert gm == cm


def test_inference_detector_takes_a_file_path(setup):
    """A path and the same image as an array give the same results."""
    cfg = Config(dict(model=setup['cfg'], data=dict(test=dict(
        pipeline=eval_pipeline()))))
    model = init_detector(cfg, device='cpu')
    model.load_state_dict(setup['sd'])
    path = os.path.join(setup['prefix'], '0001.png')
    by_path = inference_detector(model, path)
    by_array = inference_detector(model, imread(path))
    pair = inference_detector(model, [imread(path), path])
    assert sum(len(m) for m in by_path[1]) == sum(len(b) for b in by_path[0])
    for a, b in ((by_path, by_array), (pair[0], pair[1])):
        for x, y in zip(a[0], b[0]):
            assert np.array_equal(x, y)
        for x, y in zip(a[1], b[1]):
            assert all(np.array_equal(m, n) for m, n in zip(x, y))


def _val_cfg(setup, work_dir, max_epochs, resume_from=None):
    cfg = loop_cfg(setup['root'], work_dir, max_epochs, resume_from)
    cfg.data.val = _data(setup)
    cfg.evaluation = dict(interval=1, metric=['bbox', 'segm'],
                          save_best='auto')
    return cfg


def _train(cfg, timestamp):
    """A run whose logs are named by ``timestamp`` (the runner names them to
    the second; runs that share a work_dir must not share a log)."""
    return train_detector(build_detector(dict(cfg.model)),
                          build_dataset(cfg.data.train), cfg,
                          validate=True, timestamp=timestamp, device='cpu')


def test_train_detector_validates_and_resumes(setup):
    """validate=True: each epoch logs a 'val' line of finite metrics and
    keeps the best checkpoint (save_best 'auto': bbox_mAP) beside its
    link; one epoch and a resumed second train as two in one run, bit
    for bit, and evaluate alike."""
    root = setup['root']
    split = os.path.join(root, 'val_split')
    first = _train(_val_cfg(setup, split, 1), 'first')
    assert len(first.log_vars) == 2
    with open(first.json_log) as f:
        lines = [json.loads(line) for line in f]
    val = [r for r in lines if r['mode'] == 'val']
    assert len(val) == 1 and val[0]['epoch'] == 1
    assert 'bbox_mAP' in val[0] and 'segm_mAP' in val[0]
    assert all(np.isfinite(v) for k, v in val[0].items() if k != 'mode')
    assert first.save_best == 'bbox_mAP'
    assert os.path.isfile(os.path.join(split, 'best_bbox_mAP_epoch_1.pth'))
    assert os.readlink(os.path.join(split, 'best_bbox_mAP')) == \
        'best_bbox_mAP_epoch_1.pth'
    resumed = _train(_val_cfg(setup, split, 2,
                              os.path.join(split, 'epoch_1.pth')), 'resumed')
    whole = _train(_val_cfg(setup, os.path.join(root, 'val_whole'), 2),
                   'whole')
    assert resumed.log_vars == whole.log_vars[2:]
    assert resumed.eval_results == whole.eval_results[1:]
    a = torch.load(os.path.join(split, 'epoch_2.pth'), weights_only=True)
    b = torch.load(os.path.join(root, 'val_whole', 'epoch_2.pth'),
                   weights_only=True)
    for k, v in a['state_dict'].items():
        assert torch.equal(v, b['state_dict'][k]), k
    for sa, sb in zip(a['optimizer']['state'].values(),
                      b['optimizer']['state'].values()):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_test_cli_in_process(setup, tmp_path):
    """tools.test on the CPU: --eval bbox segm with --out; the pickle holds
    single_gpu_test's results, the metrics are the dataset's."""
    cfg = Config(dict(model=setup['cfg'], data=dict(test=_data(setup))))
    cfg_file = str(tmp_path / 'tiny_cfg.py')
    cfg.dump(cfg_file)
    model = build_detector(setup['cfg'])
    model.load_state_dict(setup['sd'])
    ckpt = str(tmp_path / 'tiny.pth')
    save_checkpoint(ckpt, model, meta=dict(CLASSES=list(CLASSES)))
    out = str(tmp_path / 'results.pkl')
    ran = test_cli.main([cfg_file, ckpt, '--device', 'cpu', '--eval',
                         'bbox', 'segm', '--out', out,
                         '--samples-per-gpu', '2', '--cfg-options',
                         'model.test_cfg.rcnn.score_thr=0.0'])
    import pickle
    with open(out, 'rb') as f:
        assert len(pickle.load(f)) == len(SIZES)
    assert set(ran['metrics']) >= {'bbox_mAP', 'segm_mAP'}
    # score_thr 0 keeps max_per_img (16) detections an image
    assert all(sum(len(b) for b in r[0]) == 16 for r in ran['results'])
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        test_cli.main([cfg_file, ckpt, '--device', 'cpu', '--eval', 'bbox',
                       '--launcher', 'pytorch'])


def test_train_cli_in_process(setup, tmp_path):
    """tools.train on the CPU: one epoch with validation; the dumped config
    reads back as the one trained."""
    cfg = _val_cfg(setup, str(tmp_path / 'work'), 1)
    cfg_file = str(tmp_path / 'loop_cfg.py')
    cfg.dump(cfg_file)
    runner = train_cli.main([cfg_file, '--device', 'cpu', '--cfg-options',
                             'log_config.interval=2'])
    assert runner.epoch == 1 and len(runner.eval_results) == 1
    dumped = Config.fromfile(str(tmp_path / 'work' / 'loop_cfg.py'))
    assert dumped.log_config.interval == 2
    assert dumped.evaluation == cfg.evaluation
