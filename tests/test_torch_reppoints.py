"""RepPoints-moment in the port against the JAX package on the CPU, fp32, on
the same numpy weights and inputs: ``PointGenerator``, ``PointAssigner``,
``FocalLoss``, ``MaxIoUAssigner`` at ``min_pos_iou=0``, the deformable
conv (forward and the gradients of x, offset and weight), the FPN's extra
convs, the head's box transforms, and a tiny RepPoints detector (Swin
depths [1, 1, 1, 1], narrow widths, a 128x192 canvas) through
``simple_test``, ``aug_bbox_test``, ``aug_test_single_stage``,
``forward_train`` and one ``make_train_step`` step, its weights through
``state_dict_from_jax``.

Tolerances: assignments and labels exact; module outputs at 1e-5 of their
largest entry and module gradients at 1e-4 of theirs; losses of the loss
functions at rel 1e-6; detections with labels equal, boxes within 1e-3 px
and scores within 1e-4; the detector's losses at rel 1e-4 and its
gradients at 1e-3 of each tensor's largest entry (the
test_torch_train.py limits). The class output's weights are drawn with
std 1 so that no top-k, score or NMS boundary sits within fp32 noise.
"""
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.apis import aug_test as jax_aug_test
from swindet_tpu.apis.inference import DetectorHandle
from swindet_tpu.checkpoint import _flatten, flax_path_to_torch_key
from swindet_tpu.core.anchors import PointGenerator as JaxPointGenerator
from swindet_tpu.core.bbox.assigners import MaxIoUAssigner as JaxMaxIoU
from swindet_tpu.core.bbox.assigners import PointAssigner as JaxPointAssigner
from swindet_tpu.engine.optimizer import build_multiplier_trees
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.models.builder import build_head as jax_build_head
from swindet_tpu.models.builder import build_loss as jax_build_loss
from swindet_tpu.models.necks.fpn import FPN as JaxFPN
from swindet_tpu.ops.deform_conv import DeformConv2d as JaxDeformConv2d
from swindet_tpu.utils import Config as JaxConfig

from tests.test_models.test_single_stage import tiny_reppoints_cfg
from tests.test_torch_cascade import numpy_params_from
from tests.test_torch_checkpoint import numpy_params
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.apis.aug_test import aug_test_single_stage
from swindet_tpu_torch.apis.test import eval_batches
from swindet_tpu_torch.checkpoint import (load_checkpoint, load_weights,
                                          state_dict_from_jax)
from swindet_tpu_torch.core.anchors import PointGenerator
from swindet_tpu_torch.core.bbox import MaxIoUAssigner, PointAssigner
from swindet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                      make_train_step, param_multipliers)
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.builder import build_head, build_loss
from swindet_tpu_torch.models.detectors import RepPointsDetector
from swindet_tpu_torch.models.necks.fpn import FPN
from swindet_tpu_torch.ops.deform_conv import DeformConv2d
from swindet_tpu_torch.utils import Config

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, 'configs/reppoints/'
                      'reppoints_moment_swin_tiny_fpn_mstrain_3x_coco.py')
H, W = 128, 192
TOL_MODULE = 1e-5
TOL_MODULE_GRAD = 1e-4
TOL_LOSS = 1e-4
TOL_GRAD = 1e-3
# the gradients chip_smoke.py's phase 13 holds too
GRAD_PARAMS = (
    'bbox_head.reppoints_cls_conv.weight',
    'bbox_head.reppoints_pts_refine_conv.weight',
    'bbox_head.reppoints_pts_init_out.weight',
    'bbox_head.moment_transfer',
    'bbox_head.cls_convs.0.conv.weight',
    'neck.fpn_convs.3.conv.weight',
    'backbone.layers.0.blocks.0.attn.qkv.weight',
)


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ----------------------------------------------------- points and assigners
@pytest.mark.parametrize('size,stride', [((7, 11), 128), ((13, 21), 64),
                                         ((16, 24), 8)])
def test_point_generator_matches_jax(size, stride):
    want = np.asarray(JaxPointGenerator().grid_points(size, stride))
    gen = PointGenerator()
    got = gen.grid_points(size, stride)
    assert got.dtype == torch.float32 and got.shape == (size[0] * size[1], 3)
    assert np.array_equal(got.numpy(), want)
    assert gen.grid_points(size, stride) is got  # cached
    valid = (size[0] - 2, size[1] - 3)
    assert np.array_equal(gen.valid_flags(size, valid).numpy(), np.asarray(
        JaxPointGenerator().valid_flags(size, valid)))


def _points(h=64, w=96, strides=(8, 16, 32, 64, 128)):
    gen = JaxPointGenerator()
    return np.concatenate([np.asarray(gen.grid_points(
        (-(-h // s), -(-w // s)), s)) for s in strides])


def _point_gts():
    """Gts whose level, trunc(mean log2(size / 4)), lies at least 0.05 from
    an integer: two with the same centre and size (an exact distance tie
    between gts, which the earlier wins), one centred between four grid
    points (exact ties between points, which the stable sort orders), one
    with a point of its own, a large one at the coarse levels and a
    padded slot."""
    gts = np.array([[20.5, 12.25, 47.5, 40.25],
                    [20.5, 12.25, 47.5, 40.25],
                    [32.0, 32.0, 56.0, 56.0],
                    [61.0, 9.0, 90.0, 30.0],
                    [3.0, 2.0, 93.0, 62.0],
                    [0.0, 0.0, 0.0, 0.0]], np.float32)
    size = np.log2((gts[:5, 2:] - gts[:5, :2]) / 4).mean(-1)
    assert (np.abs(size - np.round(size)) > 0.05).all()
    valid = np.array([True] * 5 + [False])
    labels = np.array([1, 2, 3, 0, 1, 2], np.int32)
    return gts, valid, labels


@pytest.mark.parametrize('pos_num', [1, 3])
def test_point_assigner_matches_jax(pos_num):
    points = _points()
    gts, valid, labels = _point_gts()
    bbox_valid = np.ones(len(points), bool)
    bbox_valid[5] = False
    for bv in (None, bbox_valid):
        want = jax.jit(JaxPointAssigner(scale=4, pos_num=pos_num).assign)(
            points, gts, valid, labels, bv)
        got = PointAssigner(scale=4, pos_num=pos_num).assign(
            T(points), T(gts), T(valid), T(labels),
            None if bv is None else T(bv))
        for k in ('gt_inds', 'labels', 'max_overlaps'):
            assert np.array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k))), k
        inds = got.gt_inds.numpy()
        # the tied pair: the earlier gt wins every point; every valid gt
        # but the tie's second claims pos_num points
        assert (inds == 2).sum() == 0 and (inds == 6).sum() == 0
        assert all((inds == g).sum() == pos_num for g in (1, 3, 4, 5))


def test_max_iou_assigner_min_pos_iou_zero_matches_jax():
    """The refine stage's MaxIoUAssigner (0.5, 0.4, min_pos_iou=0,
    match_low_quality): a gt that overlaps no box (the first) has a best
    IoU of 0, which min_pos_iou=0 lets claim every box it does not
    overlap; the later gts' own best boxes go to them."""
    rs = np.random.RandomState(3)
    xy = rs.uniform(0, 80, (60, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(4, 40, (60, 2))], 1)
    gts = np.array([[500.0, 500.0, 540.0, 530.0], [10.3, 12.1, 50.7, 44.9],
                    [40.2, 30.6, 70.9, 90.1], [0, 0, 0, 0]], np.float32)
    valid = np.array([True, True, True, False])
    labels = np.array([2, 3, 1, 0], np.int32)
    args = [boxes.astype(np.float32), gts, valid, labels]
    want = jax.jit(JaxMaxIoU(0.5, 0.4, min_pos_iou=0,
                             match_low_quality=True).assign)(*args)
    got = MaxIoUAssigner(0.5, 0.4, min_pos_iou=0,
                         match_low_quality=True).assign(*map(T, args))
    assert np.array_equal(got.gt_inds.numpy(), np.asarray(want.gt_inds))
    assert np.array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.max_overlaps, want.max_overlaps,
                               rtol=0, atol=1e-6)
    inds = got.gt_inds.numpy()
    assert (inds == 1).sum() > 10 and (inds == 2).sum() > 0 \
        and (inds == 3).sum() > 0


FOCAL_CASES = {
    'labels-weighted': dict(weight=True, avg_factor=7.0),
    'labels-mean': dict(),
    'onehot-sum': dict(onehot=True, reduction='sum'),
    'labels-weight2-alpha': dict(weight=True, avg_factor=3.0, gamma=1.5,
                                 alpha=0.4, loss_weight=2.0),
}


@pytest.mark.parametrize('case', list(FOCAL_CASES))
def test_focal_loss_matches_jax(case):
    """Sigmoid focal loss, its value and its gradient: labels with the
    background (num_classes) and ignore (-1) rows, an (N,) weight
    broadcast over the classes, avg_factor."""
    kw = dict(FOCAL_CASES[case])
    weighted, onehot = kw.pop('weight', False), kw.pop('onehot', False)
    avg = kw.pop('avg_factor', None)
    rs = np.random.RandomState(4)
    pred = (3 * rs.randn(40, 5)).astype(np.float32)
    label = rs.randint(-1, 6, 40).astype(np.int32)
    if onehot:
        label = (rs.rand(40, 5) > 0.7).astype(np.float32)
    weight = (rs.rand(40) > 0.3).astype(np.float32)
    cfg = dict(type='FocalLoss', use_sigmoid=True, **kw)
    extra = dict(weight=weight) if weighted else {}
    if avg is not None:
        extra['avg_factor'] = avg

    def jax_loss(p):
        return jax_build_loss(dict(cfg))(p, jnp.asarray(label), **{
            k: jnp.asarray(v) for k, v in extra.items()})
    want, want_grad = jax.jit(jax.value_and_grad(jax_loss))(pred)
    pred_t = T(pred).requires_grad_()
    got = build_loss(dict(cfg))(pred_t, T(label), **{
        k: torch.as_tensor(v) for k, v in extra.items()})
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert _rel(pred_t.grad, want_grad) <= 1e-6


# ---------------------------------------------------------- deform conv
def _deform_inputs(stride, groups, seed=5):
    """x on a non-square 6x9 map and offsets (dy, dx) whose samples lie
    inside, on the one-cell band around the map and outside it, never on
    a border or a cell edge exactly."""
    rs = np.random.RandomState(seed)
    b, h, w, c, f = 2, 6, 9, 8, 6
    x = rs.randn(b, h, w, c).astype(np.float32)
    ho, wo = -(-h // stride), -(-w // stride)
    off = rs.uniform(-2.7, 2.7, (b, ho, wo, groups * 2 * 9))
    off[:, :, :, ::2] += 0.3  # asymmetric in y
    off[0, 0, 0, :] = -1.93    # the corner's taps past the top-left band
    w_ = (0.2 * rs.randn(9, c, f)).astype(np.float32)
    g = rs.randn(b, ho, wo, f).astype(np.float32)
    return x, off.astype(np.float32), w_, g


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('groups', [1, 2])
def test_deform_conv_matches_jax(stride, groups):
    """DeformConv2d's output and the gradients of x, offset and weight
    against the JAX DeformConv2d, its tap-major (K, C, F) weight converted
    to mmcv's (F, C, 3, 3)."""
    x, off, w, g = _deform_inputs(stride, groups)
    jm = JaxDeformConv2d(w.shape[-1], (3, 3), stride=stride,
                         deform_groups=groups)

    @jax.jit
    def run(x_, off_, w_, g_):
        out, vjp = jax.vjp(lambda *a: jm.apply({'params': {'weight': a[2]}},
                                               a[0], a[1]), x_, off_, w_)
        return out, vjp(g_)
    want, (want_dx, want_doff, want_dw) = run(x, off, w, g)
    port = DeformConv2d(x.shape[-1], w.shape[-1], 3, stride=stride,
                        deform_groups=groups)
    sd = state_dict_from_jax({'conv': {'weight': w}})
    assert sd['conv.weight'].shape == (w.shape[-1], x.shape[-1], 3, 3)
    port.load_state_dict({'weight': sd['conv.weight']}, strict=True)
    xt, ot = T(x).requires_grad_(), T(off).requires_grad_()
    got = port(xt, ot)
    (got * T(g)).sum().backward()
    ho, wo = off.shape[1:3]
    taps = np.arange(off.shape[-1] // 2) % 9
    sy = np.arange(0, x.shape[1], stride)[:, None, None] + taps // 3 - 1 \
        + off[..., 0::2]
    hit = {'inside': ((sy > 0) & (sy < x.shape[1] - 1)).any(),
           'band': (((sy > -1) & (sy < 0))
                    | ((sy > x.shape[1] - 1) & (sy < x.shape[1]))).any(),
           'outside': ((sy < -1) | (sy > x.shape[1])).any()}
    assert all(hit.values()), hit
    assert got.shape == (2, ho, wo, w.shape[-1])
    assert _rel(got, want) <= TOL_MODULE
    assert _rel(xt.grad, want_dx) <= TOL_MODULE_GRAD
    assert _rel(ot.grad, want_doff) <= TOL_MODULE_GRAD
    want_dw = state_dict_from_jax({'c': {'weight': np.asarray(want_dw)}})
    assert _rel(port.weight.grad, want_dw['c.weight']) <= TOL_MODULE_GRAD


# ------------------------------------------------------------------ FPN
FPN_CASES = {
    'on_input': dict(add_extra_convs='on_input'),
    'true': dict(add_extra_convs=True),
    'on_lateral': dict(add_extra_convs='on_lateral'),
    'on_output-relu': dict(add_extra_convs='on_output',
                           relu_before_extra_convs=True),
    'no-extra': dict(add_extra_convs=False),
}


@pytest.mark.parametrize('case', list(FPN_CASES))
def test_fpn_extra_convs_match_jax(case):
    """FPN from start_level=1 with each extra-level mode against the JAX
    FPN: the stride-2 extra convs named fpn_convs.3 and .4 (mmdet's)."""
    kw = dict(in_channels=[8, 16, 32, 64], out_channels=16, num_outs=5,
              start_level=1, **FPN_CASES[case])
    rs = np.random.RandomState(6)
    inputs = [rs.randn(2, 40 // 2 ** i, 56 // 2 ** i, c).astype(np.float32)
              for i, c in enumerate(kw['in_channels'])]
    jm = JaxFPN(**kw)
    xs = [jnp.asarray(a) for a in inputs]
    shapes = jax.eval_shape(lambda k: jm.init(k, xs), jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 7)
    want = jm.apply({'params': params}, xs)
    port = FPN(**kw)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    got = port([T(a) for a in inputs])
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel(a.detach(), b) <= TOL_MODULE
    extra = [n for n in port.state_dict() if n.startswith('fpn_convs.3.')]
    assert bool(extra) == bool(kw['add_extra_convs'])


# ------------------------------------------------------ head transforms
def _heads(transform):
    cfg = dict(type='RepPointsHead', num_classes=4, in_channels=16,
               feat_channels=16, point_feat_channels=16, stacked_convs=1,
               transform_method=transform)
    return jax_build_head(dict(cfg)), build_head(dict(cfg))


@pytest.mark.parametrize('transform', ['moment', 'minmax', 'partial_minmax'])
@pytest.mark.parametrize('y_first', [True, False])
def test_points2bbox_matches_jax(transform, y_first):
    """Boxes of asymmetric point sets, and for the moment transform the
    gradients of the points and of moment_transfer (scaled by
    moment_mul)."""
    jm, port = _heads(transform)
    rs = np.random.RandomState(8)
    pts = (rs.randn(3, 5, 18) * np.tile([1.0, 3.0], 9)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(pts), y_first,
        method='points2bbox'))
    params = variables.get('params', {})
    if transform == 'moment':
        params = {'moment_transfer': np.array([0.3, -0.2], np.float32)}
        port.moment_transfer.data = T(params['moment_transfer'])

    g = rs.randn(*pts.shape[:-1], 4).astype(np.float32)

    @jax.jit
    def run(p, x, g_):
        out, vjp = jax.vjp(lambda p_, x_: jm.apply(
            {'params': p_}, x_, y_first, method='points2bbox'), p, x)
        return out, vjp(g_)
    want, (want_dp, want_dx) = run(params, pts, g)
    pt = T(pts).requires_grad_()
    got = port.points2bbox(pt, y_first=y_first)
    (got * T(g)).sum().backward()
    assert _rel(got, want) <= TOL_MODULE
    assert _rel(pt.grad, want_dx) <= TOL_MODULE_GRAD
    if transform == 'moment':
        assert _rel(port.moment_transfer.grad,
                    want_dp['moment_transfer']) <= TOL_MODULE_GRAD


def test_gen_grid_from_reg_matches_jax():
    jm, port = _heads('moment')
    rs = np.random.RandomState(9)
    reg = (0.3 * rs.randn(2, 3, 5, 4)).astype(np.float32)
    prev = np.concatenate([rs.uniform(-4, 0, (2, 3, 5, 2)),
                           rs.uniform(0.5, 4, (2, 3, 5, 2))], -1) \
        .astype(np.float32)
    grid_w, box_w = jm.apply({'params': {'moment_transfer': jnp.zeros(2)}},
                             jnp.asarray(reg),
                             jnp.asarray(prev), method='gen_grid_from_reg')
    grid, box = port.gen_grid_from_reg(T(reg), T(prev))
    assert grid.shape == (2, 3, 5, 18)
    assert _rel(grid, grid_w) <= TOL_MODULE
    assert _rel(box, box_w) <= TOL_MODULE


# ------------------------------------------------------- tiny detector
@pytest.fixture(scope='module')
def reppoints():
    """The JAX detector and numpy params (reppoints_cls_out's kernel drawn
    with std 1), and the port's RepPointsDetector on them (eval mode)."""
    cfg = tiny_reppoints_cfg()
    jm = jax_build_detector(cfg)
    params = numpy_params(jm, 0, method='forward_dummy')
    head = params['_bbox_head']
    rs = np.random.RandomState(100)
    head['reppoints_cls_out']['kernel'] = rs.randn(
        *head['reppoints_cls_out']['kernel'].shape).astype(np.float32)
    sd = state_dict_from_jax(params)
    port = build_detector(cfg)
    port.load_state_dict(sd, strict=True)
    return dict(cfg=cfg, jm=jm, params=params, sd=sd, port=port.eval())


def _test_inputs(seed=11):
    rs = np.random.RandomState(seed)
    img = rs.randn(2, H, W, 3).astype(np.float32)
    shapes = np.array([[H, W], [H - 8, W - 32]], np.int32)
    sf = np.array([[1.0] * 4, [0.75] * 4], np.float32)
    return img, shapes, sf


def _detection_errors(got, want):
    """None where validity or labels differ, else the box and score max
    |d| over the valid detections."""
    v = want['det_valid']
    if not (np.array_equal(got['det_valid'], v)
            and np.array_equal(got['labels'][v], want['labels'][v])):
        return None
    return (float(np.abs(got['dets'][v][:, :4] - want['dets'][v][:, :4])
                  .max()),
            float(np.abs(got['dets'][v][:, 4] - want['dets'][v][:, 4]).max()))


def _within(errs):
    return errs is not None and errs[0] <= 1e-3 and errs[1] <= 1e-4


def _port_simple_test(model, img, shapes, sf):
    with torch.no_grad():
        out = model.simple_test(T(img), T(shapes), T(sf))
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope='module')
def simple_test_run(reppoints):
    img, shapes, sf = _test_inputs()
    want = jax.tree.map(np.asarray, jax.jit(
        lambda p, *a: reppoints['jm'].apply({'params': p}, *a,
                                            method='simple_test'))(
        reppoints['params'], img, shapes, sf))
    return img, shapes, sf, want


def test_reppoints_weights_load_strictly(reppoints):
    """state_dict_from_jax(params) holds every key of the port's
    RepPointsDetector, mmdet-named, the deformable convs' weights as
    (F, C, 3, 3)."""
    port, sd = reppoints['port'], reppoints['sd']
    assert isinstance(port, RepPointsDetector)
    assert set(sd) == set(port.state_dict())
    c = reppoints['cfg']['bbox_head']['feat_channels']
    for key in ('bbox_head.cls_convs.0.conv.weight',
                'bbox_head.reg_convs.0.conv.bias',
                'bbox_head.moment_transfer', 'neck.fpn_convs.4.conv.weight',
                'bbox_head.reppoints_pts_init_conv.weight'):
        assert key in sd, key
    for name in ('reppoints_cls_conv', 'reppoints_pts_refine_conv'):
        assert sd[f'bbox_head.{name}.weight'].shape == (c, c, 3, 3)
    assert sd['bbox_head.moment_transfer'].shape == (2,)


def test_reppoints_checkpoint_loads_as_it_is(reppoints, tmp_path):
    """An mmdet-keyed RepPoints .pth (under 'state_dict', with a 'module.'
    prefix) loads strictly through load_checkpoint and fully through
    load_weights."""
    path = str(tmp_path / 'reppoints.pth')
    torch.save(dict(meta=dict(CLASSES=['a', 'b', 'c', 'd']), state_dict={
        f'module.{k}': v for k, v in reppoints['sd'].items()}), path)
    for load in (load_checkpoint, load_weights):
        port = build_detector(reppoints['cfg'])
        assert load(port, path)['CLASSES'] == ['a', 'b', 'c', 'd']
        assert all(torch.equal(v, reppoints['sd'][k])
                   for k, v in port.state_dict().items())


def test_reppoints_simple_test_matches_jax(reppoints, simple_test_run):
    img, shapes, sf, want = simple_test_run
    got = _port_simple_test(reppoints['port'], img, shapes, sf)
    errs = _detection_errors(got, want)
    assert int(want['det_valid'].sum()) >= 8
    assert _within(errs), errs


def test_untransposed_deform_weights_fail_the_check(reppoints,
                                                    simple_test_run):
    """Control: the deformable convs' (K, C, F) weights reshaped to
    (F, C, 3, 3) without the tap-major transpose: the check above must
    fail."""
    img, shapes, sf, want = simple_test_run
    sd = dict(reppoints['sd'])
    head = reppoints['params']['_bbox_head']
    for name in ('reppoints_cls_conv', 'reppoints_pts_refine_conv'):
        w = head[name]['weight']
        sd[f'bbox_head.{name}.weight'] = T(np.ascontiguousarray(w).reshape(
            w.shape[2], w.shape[1], 3, 3))
    port = build_detector(reppoints['cfg'])
    port.load_state_dict(sd, strict=True)
    errs = _detection_errors(_port_simple_test(port.eval(), img, shapes, sf),
                             want)
    assert not _within(errs), errs


@pytest.fixture(scope='module')
def jax_aug_run(reppoints):
    """The JAX package's aug_test_single_stage over the image and its
    flip, and its handle, which keeps the jitted per-augmentation half."""
    handle = DetectorHandle(JaxConfig(dict(model=reppoints['cfg'])),
                            reppoints['jm'], {'params': reppoints['params']})
    want = jax.tree.map(np.asarray, jax_aug_test.aug_test_single_stage(
        handle, _augs()))
    return handle, want


def _augs():
    img, shapes, sf = _test_inputs()
    return [dict(img=img, img_shapes=shapes, scale_factors=sf, flip=False),
            dict(img=img[:, :, ::-1].copy(), img_shapes=shapes,
                 scale_factors=sf, flip=True, flip_direction='horizontal')]


def _torch_aug(ab):
    return {k: T(v) if isinstance(v, np.ndarray) else v
            for k, v in ab.items()}


def test_reppoints_aug_bbox_test_matches_jax(reppoints, jax_aug_run):
    """One augmentation's pre-NMS candidates in its own frame, through the
    JAX package's jitted half of the test below: the per-level top
    nms_pre points' boxes and scores with the zero background column."""
    img, shapes, _ = _test_inputs()
    handle = jax_aug_run[0]
    want_b, want_s, want_f = handle._jitted['aug_ss_bbox'](
        handle.variables, img, shapes)
    with torch.no_grad():
        got_b, got_s, got_f = reppoints['port'].aug_bbox_test(T(img),
                                                              T(shapes))
    assert got_f is None and want_f is None
    assert got_s.shape == want_s.shape == (2, 100 + 96 + 24 + 6 + 2, 5)
    assert (got_s[..., -1] == 0).all()
    np.testing.assert_allclose(got_b, want_b, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)


def test_reppoints_aug_test_single_stage_matches_jax(reppoints, jax_aug_run):
    """aug_test_single_stage over the image and its flip: both
    augmentations' candidates mapped back, concatenated, one NMS."""
    want = jax_aug_run[1]
    with torch.no_grad():
        got = aug_test_single_stage(reppoints['port'],
                                    [_torch_aug(ab) for ab in _augs()])
    errs = _detection_errors({k: v.numpy() for k, v in got.items()}, want)
    assert int(want['det_valid'].sum()) >= 8
    assert _within(errs), errs


class _AugDataset:
    """Pipeline outputs of MultiScaleFlipAug with two augmentations (the
    image and its flip) for each of two landscape images."""

    def __init__(self):
        img, shapes, sf = _test_inputs()
        self.items = []
        for i in range(2):
            h, w = shapes[i]
            im = img[i, :h, :w]
            metas = [dict(ori_shape=(h, w, 3), scale_factor=sf[i],
                          flip=f, flip_direction='horizontal')
                     for f in (False, True)]
            self.items.append(dict(img=[im, im[:, ::-1].copy()],
                                   img_metas=metas))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_eval_batches_dispatch_single_stage_tta(reppoints):
    """The evaluation loop sends a detector with aug_bbox_test and no RPN
    half to aug_test_single_stage (swindet_tpu/apis/test.py:181-185)."""
    port = reppoints['port']
    ds = _AugDataset()
    [(chunk, out, metas)] = list(eval_batches(port, ds, batch_size=2))
    assert chunk == [0, 1] and set(out) == {'dets', 'labels', 'det_valid'}
    img, shapes, sf = _test_inputs()
    augs = [dict(img=np.zeros_like(img), img_shapes=shapes,
                 scale_factors=sf, flip=f, flip_direction='horizontal')
            for f in (False, True)]
    for i in range(2):
        h, w = shapes[i]
        augs[0]['img'][i, :h, :w] = img[i, :h, :w]
        augs[1]['img'][i, :h, :w] = img[i, :h, :w][:, ::-1]
    with torch.no_grad():
        want = aug_test_single_stage(port, [_torch_aug(ab) for ab in augs])
    for k, v in want.items():
        assert np.array_equal(out[k], v.numpy()), k
    assert all((m['scale_factor'] == 1).all() for m in metas)


def _train_batch(seed=12, b=2, g=4):
    """Gt boxes at fractional coordinates whose level lies off an integer
    of mean log2(size / 4); the second image has one padded slot."""
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
    size = np.log2((boxes[..., 2:] - boxes[..., :2]).clip(1e-6) / 4) \
        .mean(-1)[valid]
    assert (np.abs(size - np.round(size)) > 0.01).all()
    shapes = np.array([[H, W]] * b, np.int32)
    return dict(img=rs.randn(b, H, W, 3).astype(np.float32),
                img_shapes=shapes, pad_shapes=shapes.copy(), gt_bboxes=boxes,
                gt_valid=valid, gt_labels=rs.randint(0, 4, (b, g)))


@pytest.fixture(scope='module')
def train_run(reppoints):
    """forward_train on both sides, same weights and batch: losses and
    gradients."""
    batch = _train_batch()
    jm = reppoints['jm']
    args = [jnp.asarray(batch[k]) for k in (
        'img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
        'gt_labels')]

    def total(p):
        losses = jm.apply({'params': p}, *args, method='forward_train',
                          rngs={'sampling': jax.random.PRNGKey(1),
                                'dropout': jax.random.PRNGKey(2)})
        return jax_parse_losses(losses)
    (_, want), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        reppoints['params'])
    port = build_detector(reppoints['cfg'])
    port.load_state_dict(reppoints['sd'], strict=True)
    port.train()
    tb = {k: T(v) for k, v in batch.items()}
    losses = port.forward_train(tb['img'], tb['img_shapes'], tb['pad_shapes'],
                                tb['gt_bboxes'], tb['gt_valid'],
                                tb['gt_labels'])
    sum(losses.values()).backward()
    return dict(want={k: float(v) for k, v in want.items()},
                got={k: float(v.detach()) for k, v in losses.items()},
                want_grads=state_dict_from_jax(jax.tree.map(np.asarray,
                                                            grads)),
                got_grads={k: v.grad.clone() for k, v in
                           port.named_parameters() if v.grad is not None},
                port=port, batch=tb)


def test_reppoints_forward_train_losses_match_jax(train_run):
    want, got = train_run['want'], train_run['got']
    assert set(got) == {'loss_cls', 'loss_pts_init', 'loss_pts_refine'}
    assert set(want) - {'loss'} == set(got)
    for k, v in got.items():
        assert np.isfinite(v) and want[k] > 0, k
        assert abs(v - want[k]) <= TOL_LOSS * abs(want[k]), (k, v, want[k])


@pytest.mark.parametrize('name', GRAD_PARAMS)
def test_reppoints_forward_train_grads_match_jax(train_run, name):
    want = train_run['want_grads'][name].numpy()
    got = train_run['got_grads'][name]
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= TOL_GRAD, _rel(got, want)


def test_reppoints_train_step_moves_the_parameters(train_run):
    """One make_train_step step with the RepPoints Swin config's optimizer
    moves every parameter but the first stage's output norm, whose
    features the FPN does not read from start_level=1 (zero gradient, no
    weight decay on a norm); a batch without gt_masks is what the
    bbox-only loader gives."""
    cfg = Config.fromfile(CONFIG)
    port = train_run['port']
    opt = build_optimizer(port, dict(cfg.optimizer))
    step = make_train_step(port, opt, build_lr_schedule(
        dict(cfg.lr_config), cfg.optimizer['lr'], 100))
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    batch = dict(train_run['batch'])
    assert 'gt_masks' not in batch
    log = step(batch, torch.Generator().manual_seed(0))
    assert {'loss', 'grad_norm', 'loss_cls', 'loss_pts_init',
            'loss_pts_refine'} <= set(log)
    assert all(np.isfinite(v) for v in log.values()) and log['grad_norm'] > 0
    moved = [k for k, v in port.named_parameters()
             if not torch.equal(v.detach(), before[k])]
    assert set(before) - set(moved) == {'backbone.norm0.weight',
                                        'backbone.norm0.bias'}


def test_reppoints_config_and_decay_partition_match_jax():
    """The Swin config over the r50 base: the _delete_ backbone and
    optimizer replace the base's; the port's RepPointsDetector at the
    config's full widths, and its decay partition (the custom keys
    absolute_pos_embed, relative_position_bias_table, norm) equal to the
    JAX package's over its parameter tree."""
    cfg = Config.fromfile(CONFIG)
    assert dict(cfg.model.backbone) == dict(
        type='SwinTransformer', embed_dim=96, depths=[2, 2, 6, 2],
        num_heads=[3, 6, 12, 24], window_size=7, drop_path_rate=0.2,
        out_indices=(0, 1, 2, 3))
    assert cfg.optimizer['type'] == 'AdamW' and 'momentum' not in \
        cfg.optimizer
    assert cfg.model.neck['start_level'] == 1 \
        and cfg.model.neck['add_extra_convs'] == 'on_input'
    model_cfg = dict(cfg.model)
    model_cfg.pop('pretrained', None)
    port = build_detector(copy.deepcopy(model_cfg))
    assert isinstance(port, RepPointsDetector)
    assert len(port.neck.fpn_convs) == 5 and not any(
        c.use_kernel for c in port.neck.fpn_convs[3:])
    head = port.bbox_head
    assert all(c.use_kernel for c in (*head.cls_convs, *head.reg_convs))
    assert len(head.cls_convs) == 3 and head.num_classes == 80
    paramwise = dict(custom_keys={k: dict(v) for k, v in
                                  cfg.optimizer['paramwise_cfg']
                                  ['custom_keys'].items()})
    ours = param_multipliers(port, paramwise)
    module = jax_build_detector(copy.deepcopy(model_cfg))
    shapes = jax.eval_shape(
        lambda d: module.init({'params': jax.random.PRNGKey(0)}, d,
                              method='forward_dummy'),
        jnp.zeros((1, 64, 64, 3), jnp.float32))['params']
    decay, lr = build_multiplier_trees(shapes, paramwise)
    theirs = {flax_path_to_torch_key(p): (float(d), float(lr_))
              for (p, d), lr_ in zip(_flatten(decay).items(),
                                     _flatten(lr).values())}
    assert ours == theirs
    assert 'bbox_head.moment_transfer' in ours
    assert sum(dm == 0.0 for dm, _ in ours.values()) > 50
