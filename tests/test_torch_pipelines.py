"""The port's test-time resize against cv2 and its test pipeline against
the JAX package's. The port resizes a uint8 image with cv2's fixed-point
INTER_LINEAR arithmetic, written in torch (the card's machine has no
cv2), so both comparisons are exact."""
import os

import numpy as np
import pytest

from swindet_tpu.apis.inference import preprocess_images as jax_preprocess
from swindet_tpu.utils import Config as JaxConfig

from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.apis.inference import preprocess_images
from swindet_tpu_torch.datasets.pipelines import (imresize_bilinear,
                                                  rescale_size)
from swindet_tpu_torch.utils import Config

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(
    REPO, 'configs/swin/'
    'mask_rcnn_swin_tiny_patch4_window7_mstrain_480-800_adamw_1x_coco.py')
# the flagship's test scale and its mstrain short sides
SCALES = [(1333, 800), (1333, 480), (1333, 640), (1333, 1024)]


@pytest.mark.parametrize('hw', [(480, 640), (333, 500), (1000, 1500),
                                (427, 640)])
@pytest.mark.parametrize('seed', [0, 1])
def test_uint8_resize_equals_cv2(hw, seed):
    """Upscales and downscales to every scale, and a few odd sizes
    (a one-pixel axis, a 3x upscale, a 7x downscale, the same size)."""
    cv2 = pytest.importorskip('cv2')
    h, w = hw
    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    sizes = [rescale_size((w, h), s) for s in SCALES]
    sizes += [(1, 5), (3 * w + 1, h // 7), (w, h)]
    for size in sizes:
        want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        got = imresize_bilinear(img, size)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), (size, (got != want).mean())


def test_preprocess_images_equals_the_jax_pipeline():
    """One 480x640 uint8 image through the flagship's test pipeline: the
    same 800x1344 canvas, shapes and scale factors, entry for entry."""
    pytest.importorskip('cv2')
    img = np.random.RandomState(3).randint(0, 256, (480, 640, 3)).astype(
        np.uint8)
    got = preprocess_images([img], Config.fromfile(CONFIG))
    want = jax_preprocess([img], JaxConfig.fromfile(CONFIG))
    assert got['img'].shape == (1, 800, 1344, 3)
    for key in ('img', 'img_shapes', 'scale_factors'):
        assert np.array_equal(got[key], np.asarray(want[key])), key
