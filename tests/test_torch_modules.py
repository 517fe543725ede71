"""The port's modules against the JAX package's on the same numpy weights
and inputs, in fp32 on the CPU (where both run their plain kernel
versions): the full-width Swin-T backbone, and the FPN, RPN proposals
and RoI head of the tiny Mask R-CNN of tests/test_models/test_forward.py.
The RoI head is fed the JAX package's proposals, so that its comparison
does not hang on top-k ties upstream."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_models.test_forward import tiny_maskrcnn_cfg
from tests.test_torch_checkpoint import (SWIN_T, jax_backbone_params,
                                         jax_detector_params)
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.builder import build_backbone

cap_torch_threads()

T = torch.from_numpy


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol,
                               atol=tol)


def test_full_width_swin_t_stages():
    jm, params = jax_backbone_params(SWIN_T, seed=1)
    img = np.random.RandomState(1).randn(1, 112, 160, 3).astype(np.float32)
    want = jax.jit(lambda p, x: jm.apply({'params': p}, x))(
        params, jnp.asarray(img))
    port = build_backbone(dict(SWIN_T))
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port(T(img))
    assert [tuple(g.shape) for g in got] == [
        (1, 28, 40, 96), (1, 14, 20, 192), (1, 7, 10, 384), (1, 4, 5, 768)]
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.fixture(scope='module')
def tiny_pair():
    """(JAX outputs, port model, inputs) of the tiny Mask R-CNN."""
    cfg = tiny_maskrcnn_cfg()
    jm, params = jax_detector_params(cfg, seed=2)
    rs = np.random.RandomState(2)
    img = rs.randn(2, 64, 96, 3).astype(np.float32)
    shapes = np.array([[64, 96], [56, 80]], np.int32)
    sf = np.array([[1.5] * 4, [1.0] * 4], np.float32)
    rpn_cfg = dict(cfg['test_cfg']['rpn'])

    def run(m, x, shapes, sf):
        feats = m.extract_feat(x)
        props, scores, valid = m._rpn_head.get_proposals(
            *m._rpn_head(feats), shapes, rpn_cfg)
        roi = m._roi_head.simple_test(feats, props, valid, shapes, sf)
        return feats, (props, scores, valid), roi

    want = jax.jit(lambda p, *a: jm.apply({'params': p}, *a, method=run))(
        params, jnp.asarray(img), jnp.asarray(shapes), jnp.asarray(sf))
    want = jax.tree.map(np.array, want)
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return want, port, (T(img), T(shapes), T(sf))


def test_fpn_levels(tiny_pair):
    want, port, (img, _, _) = tiny_pair
    with torch.inference_mode():
        got = port.extract_feat(img)
    assert len(got) == 5
    for g, w in zip(got, want[0]):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-4)


def test_rpn_proposals(tiny_pair):
    want, port, (img, shapes, _) = tiny_pair
    with torch.inference_mode():
        feats = port.extract_feat(img)
        props, scores, valid = port.rpn_head.get_proposals(
            *port.rpn_head(feats), shapes, dict(port.test_cfg['rpn']))
    w_props, w_scores, w_valid = want[1]
    assert np.array_equal(valid.numpy(), w_valid)
    assert valid.sum() > 0
    _close(props, w_props, 1e-3)
    _close(scores, w_scores, 1e-5)


def test_roi_head_on_jax_proposals(tiny_pair):
    want, port, (img, shapes, sf) = tiny_pair
    props, _, valid = (T(a) for a in want[1])
    with torch.inference_mode():
        feats = port.extract_feat(img)
        got = port.roi_head.simple_test(feats, props, valid, shapes, sf)
    w = want[2]
    assert np.array_equal(got['det_valid'].numpy(), w['det_valid'])
    assert np.array_equal(got['labels'].numpy(), w['labels'])
    assert w['det_valid'].sum() > 0
    _close(got['dets'][..., :4], w['dets'][..., :4], 1e-3)
    _close(got['dets'][..., 4], w['dets'][..., 4], 1e-4)
    _close(got['mask_probs'], w['mask_probs'], 1e-4)
