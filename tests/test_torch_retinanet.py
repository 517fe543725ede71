"""The port's anchor heads and RetinaNet against the JAX package on the
CPU, fp32, on the same numpy weights, batch statistics and inputs:

- ``RetinaHead`` (octave anchors, a stacked conv tower, the focal loss,
  ``PseudoSampler``, the avg factor over positives) and a plain
  ``AnchorHead`` with a softmax classifier (the avg factor over the kept
  anchors, per image at least 1): outputs, targets, losses and their
  gradients, and ``get_bboxes`` with and without NMS;
- a tiny RetinaNet (``tiny_retinanet_cfg``: a ResNet-18 of base width 16,
  running statistics away from 0 and 1) through ``simple_test`` and
  ``forward_train``, its weights through ``state_dict_from_jax``.

The class output's weights are drawn with std 1, so that no top-k, score
or NMS boundary sits within fp32 noise, and the gts lie at fractional
coordinates, so that no IoU ties between anchors.

Tolerances: head outputs at 1e-5 of their largest entry; targets exact
(box targets within 1e-6); head losses at rel 1e-6 and their gradients at
1e-5 of their largest entry; detections with counts and labels equal,
boxes within 1e-3 px and scores within 1e-4; the detector's losses at rel
1e-4 and its gradients at 1e-3 of each tensor's largest entry (the
test_torch_train.py limits).
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.models.builder import build_head as jax_build_head

from tests.test_models.test_single_stage import tiny_retinanet_cfg
from tests.test_torch_cascade import _draw_stats, numpy_params_from
from tests.test_torch_checkpoint import numpy_params

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.builder import build_head
from swindet_tpu_torch.models.dense_heads.retina_head import RetinaHead
from swindet_tpu_torch.models.detectors import RetinaNet

H, W = 128, 192
SIZES = [(H // s, -(-W // s)) for s in (8, 16, 32, 64, 128)]
TOL_MODULE = 1e-5
TOL_HEAD_LOSS = 1e-6
TOL_HEAD_GRAD = 1e-5
TOL_LOSS = 1e-4
TOL_GRAD = 1e-3


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _head_cfg(case):
    det = tiny_retinanet_cfg()
    cfg = dict(det['bbox_head'], train_cfg=det['train_cfg'],
               test_cfg=det['test_cfg'])
    if case == 'anchor-softmax':
        cfg.update(type='AnchorHead', feat_channels=16,
                   loss_cls=dict(type='CrossEntropyLoss', use_sigmoid=False,
                                 loss_weight=1.0))
        cfg.pop('stacked_convs')
    return cfg


def _gts(seed=5, b=2, g=4):
    """Gts at fractional coordinates; the second image has a padded
    slot."""
    rs = np.random.RandomState(seed)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        n = g - i
        cx, cy = rs.uniform(0.2, 0.8, n) * W, rs.uniform(0.2, 0.8, n) * H
        bw, bh = rs.uniform(14, 90, n), rs.uniform(12, 80, n)
        boxes[i, :n] = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                 cy + bh / 2], -1)
        valid[i, :n] = True
    labels = rs.randint(0, 4, (b, g)).astype(np.int32)
    shapes = np.array([[H, W], [H - 8, W - 32]], np.int32)
    return boxes, valid, labels, shapes


@pytest.fixture(scope='module', params=['retina', 'anchor-softmax'])
def head(request):
    """Both heads on the same weights (the class output's with std 1) and
    five levels of features."""
    cfg = _head_cfg(request.param)
    jm = jax_build_head(dict(cfg))
    rs = np.random.RandomState(1)
    feats = [rs.randn(2, h, w, 16).astype(np.float32) for h, w in SIZES]
    shapes = jax.eval_shape(lambda k: jm.init(k, feats),
                            jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 2)
    cls = 'retina_cls' if request.param == 'retina' else 'conv_cls'
    params[cls]['kernel'] = rs.randn(*params[cls]['kernel'].shape) \
        .astype(np.float32)
    port = build_head(dict(cfg))
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    outs = jax.jit(jm.apply)({'params': params}, feats)
    return dict(case=request.param, cfg=cfg, jm=jm, params=params,
                port=port, feats=feats,
                outs=jax.tree.map(np.asarray, outs))


def test_head_forward_matches_jax(head):
    port = head['port']
    if head['case'] == 'retina':
        assert isinstance(port, RetinaHead) and port.num_base_priors == 9
        assert len(port.cls_convs) == len(port.reg_convs) == 1
    cls, reg = port([T(f) for f in head['feats']])
    for got, want in zip(cls + reg, head['outs'][0] + head['outs'][1]):
        assert got.shape == want.shape
        assert _rel(got, want) <= TOL_MODULE


def test_head_targets_match_jax(head):
    gts, valid, labels, shapes = _gts()
    want = jax.jit(lambda p, *a: head['jm'].apply(
        {'params': p}, method=lambda m: m.get_targets(
            jax.random.PRNGKey(0), SIZES, m.get_anchors(SIZES), *a)))(
        head['params'], gts, valid, labels, shapes, shapes)
    got = head['port'].get_targets(SIZES, T(gts), T(valid), T(labels),
                                   T(shapes), T(shapes))
    names = ('labels', 'label_weights', 'bbox_targets', 'bbox_weights',
             'num_pos', 'num_neg')
    for name, a, b in zip(names, got, want):
        if name == 'bbox_targets':
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
        else:
            assert np.array_equal(a.numpy(), np.asarray(b)), name
    assert (got[4].numpy() > 0).all() and (got[5].numpy() > 0).all()
    assert set(np.unique(got[0].numpy())) > {4}


def test_head_loss_matches_jax(head):
    """loss_cls and loss_bbox, and their gradients with respect to the
    head's outputs; the focal loss averages over the positives, the
    softmax CE over the kept anchors."""
    gts, valid, labels, shapes = _gts()
    cls_w, reg_w = head['outs']

    def loss(c, r):
        return head['jm'].apply(
            {'params': head['params']}, jax.random.PRNGKey(0), c, r, gts,
            valid, labels, shapes, shapes, method='loss')
    (want, (g_cls, g_reg)) = jax.jit(lambda c, r: jax.value_and_grad(
        lambda c_, r_: sum(loss(c_, r_).values()), argnums=(0, 1))(c, r))(
        cls_w, reg_w)
    parts = jax.jit(loss)(cls_w, reg_w)
    cls = [T(c).requires_grad_() for c in cls_w]
    reg = [T(r).requires_grad_() for r in reg_w]
    got = head['port'].loss(cls, reg, T(gts), T(valid), T(labels),
                            T(shapes), T(shapes))
    assert set(got) == {'loss_cls', 'loss_bbox'}
    assert head['port'].sampling == (head['case'] != 'retina')
    for k, v in got.items():
        assert float(parts[k]) > 0
        np.testing.assert_allclose(float(v), float(parts[k]),
                                   rtol=TOL_HEAD_LOSS)
    sum(got.values()).backward()
    for ts, gs in ((cls, g_cls), (reg, g_reg)):
        for t, g in zip(ts, gs):
            assert _rel(t.grad, g) <= TOL_HEAD_GRAD
    assert float(want) > 0


@pytest.mark.parametrize('with_nms', [True, False])
def test_head_get_bboxes_matches_jax(head, with_nms):
    """Per-level nms_pre top-k on the best class score, decode, rescale,
    the background column, then multiclass_nms (or the candidates, for
    test-time augmentation)."""
    _, _, _, shapes = _gts()
    sf = np.array([[1.0] * 4, [0.75] * 4], np.float32)
    cls_w, reg_w = head['outs']
    want = jax.tree.map(np.asarray, jax.jit(lambda p, *a: head['jm'].apply(
        {'params': p}, *a, rescale=True, with_nms=with_nms,
        method='get_bboxes'))(head['params'], cls_w, reg_w, shapes, sf))
    with torch.no_grad():
        got = head['port'].get_bboxes([T(c) for c in cls_w],
                                      [T(r) for r in reg_w], T(shapes),
                                      T(sf), rescale=True, with_nms=with_nms)
    if not with_nms:
        # 100 a level where a level holds more anchors (nms_pre)
        assert got[1].shape == want[1].shape == (2, 100 + 100 + 100 + 54
                                                  + 18, 5)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
        return
    v = want.valid
    assert np.array_equal(got.valid.numpy(), v) and v.sum(1).min() >= 4
    assert np.array_equal(got.labels.numpy()[v], want.labels[v])
    np.testing.assert_allclose(got.dets.numpy()[v][:, :4],
                               want.dets[v][:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.dets.numpy()[v][:, 4], want.dets[v][:, 4],
                               rtol=0, atol=1e-4)


# --------------------------------------------------------- tiny RetinaNet
@pytest.fixture(scope='module')
def retinanet():
    """The JAX RetinaNet with numpy params (retina_cls with std 1) and
    batch statistics, and the port's on them (eval mode)."""
    cfg = tiny_retinanet_cfg()
    jm = jax_build_detector(copy.deepcopy(cfg))
    params = numpy_params(jm, 0, method='forward_dummy')
    rs = np.random.RandomState(100)
    leaf = params['_bbox_head']['retina_cls']
    leaf['kernel'] = rs.randn(*leaf['kernel'].shape).astype(np.float32)
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    stats = _draw_stats(shapes['batch_stats'], 200)
    sd = state_dict_from_jax(params, stats)
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(sd, strict=True)
    return dict(cfg=cfg, jm=jm, variables={'params': params,
                                           'batch_stats': stats},
                sd=sd, port=port.eval())


def test_retinanet_simple_test_matches_jax(retinanet):
    port = retinanet['port']
    assert isinstance(port, RetinaNet)
    assert set(retinanet['sd']) == set(port.state_dict())
    rs = np.random.RandomState(11)
    img = rs.randn(2, H, W, 3).astype(np.float32)
    _, _, _, shapes = _gts()
    sf = np.array([[1.0] * 4, [0.75] * 4], np.float32)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, *a: retinanet['jm'].apply(v, *a, method='simple_test'))(
        retinanet['variables'], img, shapes, sf))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in port.simple_test(
            T(img), T(shapes), T(sf)).items()}
    v = want['det_valid']
    assert np.array_equal(got['det_valid'], v) and v.sum() >= 8
    assert np.array_equal(got['labels'][v], want['labels'][v])
    np.testing.assert_allclose(got['dets'][v][:, :4], want['dets'][v][:, :4],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got['dets'][v][:, 4], want['dets'][v][:, 4],
                               rtol=0, atol=1e-4)


def test_retinanet_forward_train_matches_jax(retinanet):
    """Losses and the gradient of every parameter; the BN buffers stay as
    loaded (frozen BN in training mode)."""
    gts, valid, labels, shapes = _gts()
    rs = np.random.RandomState(12)
    img = rs.randn(2, H, W, 3).astype(np.float32)
    args = (img, shapes, shapes, gts, valid, labels)
    stats = retinanet['variables']['batch_stats']

    def total(p):
        losses = retinanet['jm'].apply(
            {'params': p, 'batch_stats': stats}, *args,
            method='forward_train', rngs={'sampling': jax.random.PRNGKey(1)})
        return jax_parse_losses(losses)
    (_, want), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        retinanet['variables']['params'])
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    port = build_detector(copy.deepcopy(retinanet['cfg']))
    port.load_state_dict(retinanet['sd'], strict=True)
    port.train()
    losses = port.forward_train(*map(T, args))
    assert set(losses) == {'loss_cls', 'loss_bbox'}
    for k, v in losses.items():
        assert abs(float(v) - float(want[k])) <= TOL_LOSS * abs(
            float(want[k])), (k, float(v), float(want[k]))
    sum(losses.values()).backward()
    bufs = dict(port.named_buffers())
    assert all(torch.equal(bufs[k], v) for k, v in retinanet['sd'].items()
               if k in bufs)
    checked = 0
    for name, p in port.named_parameters():
        w = want_grads[name]
        assert p.grad is not None, name
        assert _rel(p.grad, w) <= TOL_GRAD, (name, _rel(p.grad, w))
        checked += 1
    assert checked == len(want_grads)
