"""The port's inference slice as a whole: ``simple_test`` of the tiny
Mask R-CNN end to end against the JAX package on the same numpy weights
and images (fp32, CPU), ``inference_detector`` on a numpy image, and the
import guard that keeps jax, flax, cv2 and the JAX package out of the
port and of chip_smoke.py."""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_models.test_forward import tiny_maskrcnn_cfg
from tests.test_torch_checkpoint import jax_detector_params

from swindet_tpu_torch import inference_detector, init_detector
from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_simple_test_matches_jax():
    """dets at 1e-3 px, scores at 1e-4, labels and det_valid exact,
    mask_probs at 1e-4. The rpn_cls and fc_cls weights are spread (std 1,
    see jax_detector_params) so no top-k or NMS boundary sits within fp32
    noise."""
    cfg = tiny_maskrcnn_cfg()
    jm, params = jax_detector_params(cfg, seed=0)
    rs = np.random.RandomState(0)
    img = rs.randn(2, 64, 96, 3).astype(np.float32)
    shapes = np.array([[64, 96], [60, 80]], np.int32)
    sf = np.array([[1.5] * 4, [1.0] * 4], np.float32)
    want = jax.jit(lambda p, *a: jm.apply({'params': p}, *a,
                                          method='simple_test'))(
        params, jnp.asarray(img), jnp.asarray(shapes), jnp.asarray(sf))
    want = jax.tree.map(np.array, want)

    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port.simple_test(torch.from_numpy(img),
                               torch.from_numpy(shapes),
                               torch.from_numpy(sf))
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    assert np.array_equal(got['det_valid'], want['det_valid'])
    assert np.array_equal(got['labels'], want['labels'])
    assert want['det_valid'].sum() >= 8
    np.testing.assert_allclose(got['dets'][..., :4], want['dets'][..., :4],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got['dets'][..., 4], want['dets'][..., 4],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got['mask_probs'], want['mask_probs'],
                               rtol=0, atol=1e-4)


def _tiny_config():
    img_norm = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
    test_pipeline = [
        dict(type='LoadImageFromFile'),
        dict(type='MultiScaleFlipAug', img_scale=(96, 64), flip=False,
             transforms=[dict(type='Resize', keep_ratio=True),
                         dict(type='RandomFlip'),
                         dict(type='Normalize', **img_norm),
                         dict(type='Pad', size_divisor=32),
                         dict(type='ImageToTensor', keys=['img']),
                         dict(type='Collect', keys=['img'])])]
    return Config(dict(model=tiny_maskrcnn_cfg(),
                       data=dict(test=dict(pipeline=test_pipeline))))


def test_inference_detector_numpy_image():
    model = init_detector(_tiny_config(), device='cpu', seed=0)
    assert model.CLASSES[0] == 'person' and len(model.CLASSES) == 80
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (100, 150, 3)).astype(np.uint8)
    bbox_res, mask_res = inference_detector(model, img)
    assert len(bbox_res) == len(mask_res) == 80
    n = 0
    for dets, masks in zip(bbox_res, mask_res):
        assert dets.shape[1] == 5 and np.isfinite(dets).all()
        assert len(masks) == dets.shape[0]
        for m in masks:
            assert m.shape == (100, 150) and m.dtype == bool
        n += dets.shape[0]
    assert 0 < n <= 16
    # boxes come back in the original image's frame
    boxes = np.concatenate([d for d in bbox_res if len(d)])
    assert (boxes[:, :4] >= 0).all()
    assert (boxes[:, [0, 2]] <= 150 + 1e-3).all()
    assert (boxes[:, [1, 3]] <= 100 + 1e-3).all()


def test_port_imports_without_jax_flax_cv2():
    """Every module of the port (its tools included) and chip_smoke.py
    import with jax, flax, cv2, PIL, pycocotools and the JAX package made
    unimportable, as on the machine with the card."""
    code = (
        "import importlib, pkgutil, sys\n"
        "banned = ('jax', 'jaxlib', 'flax', 'cv2', 'PIL', 'pycocotools',\n"
        "          'swindet_tpu')\n"
        "for m in banned:\n"
        "    sys.modules[m] = None\n"
        "import swindet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    swindet_tpu_torch.__path__, 'swindet_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "for name in ('swindet_tpu_torch.tools.test',\n"
        "             'swindet_tpu_torch.tools.train',\n"
        "             'swindet_tpu_torch.datasets.api.cocoeval',\n"
        "             'swindet_tpu_torch.core.rle',\n"
        "             'swindet_tpu_torch.apis.aug_test',\n"
        "             'swindet_tpu_torch.models.roi_heads.cascade_roi_head',\n"
        "             'swindet_tpu_torch.models.losses.losses',\n"
        "             'swindet_tpu_torch.ops.deform_conv',\n"
        "             'swindet_tpu_torch.models.dense_heads.reppoints_head',\n"
        "             'swindet_tpu_torch.models.detectors.single_stage',\n"
        "             'swindet_tpu_torch.models.backbones.resnet',\n"
        "             'swindet_tpu_torch.models.dense_heads.anchor_head',\n"
        "             'swindet_tpu_torch.models.dense_heads.retina_head',\n"
        "             'swindet_tpu_torch.ops.deform_roi_pool',\n"
        "             'swindet_tpu_torch.models.roi_heads.shared_heads',\n"
        "             'swindet_tpu_torch.models.detectors.rpn',\n"
        "             'swindet_tpu_torch.models.dense_heads.fcos_head',\n"
        "             'swindet_tpu_torch.models.dense_heads.nasfcos_head',\n"
        "             'swindet_tpu_torch.models.necks.nasfcos_fpn'):\n"
        "    assert name in names, name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().split()[0] == 'ok'
    assert int(res.stdout.split()[-1]) > 60
