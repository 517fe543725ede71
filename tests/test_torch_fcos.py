"""The port's FCOS and NAS-FCOS against the JAX package on the CPU, fp32,
on the same numpy weights, batch statistics and inputs:

- ``IoULoss`` in its three modes (log, linear, square) with a per-box
  and a 4-wide weight: value and gradient;
- ``distance2bbox`` with and without clipping to each image's shape;
- the FCOS targets (labels, box targets, positives) plain and with centre
  sampling and ``norm_on_bbox``, gts tied in area included (the first
  wins, as ``jnp.argmin``);
- the FCOS head's outputs, losses and their gradients with respect to
  its outputs, plain and as the 'center-normbbox-centeronreg-giou ...
  gn-head' config sets it (GN towers with a bias, centre sampling,
  ``norm_on_bbox`` in both branches, centerness on the regression branch,
  GIoU), and ``get_bboxes`` (the centerness as NMS score factor) with and
  without NMS; the 'gn-head_dcn' config's DCNv2 last tower conv is the
  ConvModule that NAS-FCOS's searched towers run (its names at full
  width below);
- NAS-FCOS's resizes: the nearest one at the level sizes of an 800x1344
  canvas and at odd sizes (half-pixel centres, which torch's 'nearest'
  does not take), the bilinear one up and down (antialiased down); the
  ``NASFCOS_FPN`` neck at odd level sizes, its outputs and every
  gradient;
- detectors shrunk to three levels and a ResNet-18 (``tiny_cfg``): the
  JAX tests' tiny FCOS, the FCOS 'center-normbbox-centeronreg-giou ...
  gn-head' config (GN towers with a bias, centre sampling,
  ``norm_on_bbox``, GIoU) and NAS-FCOS: ``simple_test`` and the weights'
  round trip through the JAX converter bit for bit of the 'nashead'
  config (the searched neck and head, DCNv2 in both), ``forward_train``'s
  losses and every gradient of the 'fcoshead' one (the searched neck);
- the configs at full width: the port's names and shapes equal
  ``state_dict_from_jax`` of the JAX init's, mmdet's among them.

Tolerances are test_torch_retinanet.py's and test_torch_backbones.py's:
losses and head outputs at rel 1e-6 and 1e-5, head gradients at 1e-5 of
their largest entry, module outputs at 1e-5 and gradients at 1e-4;
detections with labels equal, boxes within 1e-3 px and scores within
1e-4, each or within twice the JAX package's own movement under fp32 noise
of 1e-7 where that is more (check_simple_test); detector losses at rel
1e-4 and gradients at 1e-3 of each tensor's largest entry.
"""
import copy
import functools
import re

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as flax_nn
import pytest
import torch

from swindet_tpu.checkpoint import (convert_torch_state_dict,
                                    default_flatten_hints)
from swindet_tpu.core.bbox.coders import distance2bbox as jax_distance2bbox
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.models.builder import build_head as jax_build_head
from swindet_tpu.models.losses.losses import IoULoss as JaxIoULoss
from swindet_tpu.models.necks.nasfcos_fpn import NASFCOS_FPN as JaxNASFPN

from tests.test_models.test_single_stage import tiny_fcos_cfg
from tests.test_torch_backbones import (_plain, check_full_width_names,
                                        check_module, check_simple_test,
                                        jax_readable, jit_o0)
from tests.test_torch_cascade import _draw_stats, numpy_params_from
from tests.test_torch_train import make_batch

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.core.bbox import distance2bbox
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.builder import build_head
from swindet_tpu_torch.models.losses import IoULoss
from swindet_tpu_torch.models.necks.nasfcos_fpn import (
    NASFCOS_FPN, resize_bilinear_aa, resize_nearest_half_pixel)
from swindet_tpu_torch.utils.config import Config

TOL_HEAD_LOSS = 1e-6
TOL_HEAD_OUT = 1e-5
TOL_HEAD_GRAD = 1e-5
TOL_LOSS = 1e-4
TOL_GRAD = 1e-3
H, W = 128, 192
SIZES = [(H // s, W // s) for s in (8, 16, 32, 64)] + [(1, 2)]


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _boxes(rs, n, span=100.0):
    xy = rs.uniform(0, span, (n, 2))
    wh = rs.uniform(2, 60, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ------------------------------------------------------------- IoULoss
@pytest.mark.parametrize('mode', ['log', 'linear', 'square'])
@pytest.mark.parametrize('wide', [False, True])
def test_iou_loss_matches_jax(mode, wide):
    """Value and gradient on aligned boxes, a quarter of them disjoint
    (their IoU clipped at eps), with an (N,) or (N, 4) weight (averaged to
    one) and an avg_factor: rel 1e-6 and 1e-5."""
    rs = np.random.RandomState(0)
    pred, target = _boxes(rs, 64), _boxes(rs, 64)
    target[:16] = pred[:16] + 200.0
    weight = rs.rand(64, 4) if wide else rs.rand(64)
    weight = weight.astype(np.float32)
    weight[::7] = 0
    kw = dict(mode=mode, loss_weight=2.0)
    want, g_want = jax.value_and_grad(lambda p: JaxIoULoss(**kw)(
        p, jnp.asarray(target), weight=jnp.asarray(weight),
        avg_factor=7.5))(jnp.asarray(pred))
    p = T(pred).requires_grad_()
    got = IoULoss(**kw)(p, T(target), weight=T(weight), avg_factor=7.5)
    got.backward()
    assert abs(float(got) - float(want)) <= TOL_HEAD_LOSS * abs(float(want))
    assert _rel(p.grad, g_want) <= TOL_HEAD_GRAD
    # the linear flag is mode 'linear'
    lin = IoULoss(linear=True)(T(pred), T(target))
    assert float(lin) == float(IoULoss(mode='linear')(T(pred), T(target)))


def test_distance2bbox_matches_jax():
    """Boxes from points and distances (some negative), unclipped and
    clipped to each image's (H, W): equal bit for bit."""
    rs = np.random.RandomState(1)
    pts = rs.uniform(0, 160, (2, 50, 2)).astype(np.float32)
    dist = rs.uniform(-5, 90, (2, 50, 4)).astype(np.float32)
    shapes = np.array([[96, 160], [80, 120]], np.int32)
    assert np.array_equal(distance2bbox(T(pts), T(dist)).numpy(),
                          np.asarray(jax_distance2bbox(pts, dist)))
    want = np.stack([np.asarray(jax_distance2bbox(pts[i], dist[i],
                                                  max_shape=shapes[i]))
                     for i in range(2)])
    got = distance2bbox(T(pts), T(dist), max_shape=T(shapes)[:, None])
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------- FCOS head
HEAD_CASES = {
    'plain': dict(),
    'normbbox': dict(center_sampling=True, norm_on_bbox=True,
                     centerness_on_reg=True, conv_bias=True,
                     norm_cfg=dict(type='GN', num_groups=4),
                     loss_bbox=dict(type='GIoULoss', loss_weight=1.0)),
}


def _head_cfg(case):
    det = tiny_fcos_cfg()
    return dict(det['bbox_head'], **HEAD_CASES[case],
                train_cfg=det['train_cfg'], test_cfg=det['test_cfg'])


def _gts(seed=5):
    """Two images' gts: sizes across the regress ranges, the second
    image's gt 2 a copy of its gt 1 under another label (a tie in area)
    and its last slot padding."""
    rs = np.random.RandomState(seed)
    boxes = np.zeros((2, 5, 4), np.float32)
    valid = np.zeros((2, 5), bool)
    for i in range(2):
        n = 5 - i
        cx, cy = rs.uniform(0.3, 0.7, n) * W, rs.uniform(0.3, 0.7, n) * H
        bw = rs.uniform(10, 150, n)
        bh = rs.uniform(10, 120, n)
        boxes[i, :n] = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                 cy + bh / 2], -1)
        valid[i, :n] = True
    boxes[1, 2] = boxes[1, 1]
    labels = rs.randint(0, 4, (2, 5)).astype(np.int32)
    labels[1, 2] = (labels[1, 1] + 1) % 4
    return boxes, valid, labels


@pytest.fixture(scope='module', params=list(HEAD_CASES))
def head(request):
    """The JAX and the port's FCOS head on the same weights (the class
    output's with std 1, the scales 1 + N(0, 0.1^2)) and five levels of
    features; the JAX head's training-branch and test-branch outputs."""
    cfg = _head_cfg(request.param)
    jm = jax_build_head(dict(cfg))
    rs = np.random.RandomState(1)
    feats = [rs.randn(2, h, w, 16).astype(np.float32) for h, w in SIZES]
    shapes = jax.eval_shape(lambda k: jm.init(k, feats),
                            jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 2)
    params['conv_cls']['kernel'] = rs.randn(
        *params['conv_cls']['kernel'].shape).astype(np.float32)
    params['scales'] = (1 + 0.1 * rs.randn(5)).astype(np.float32)
    port = build_head(dict(cfg))
    port.load_state_dict({k[len('bbox_head.'):]: v for k, v in
                          state_dict_from_jax({'_bbox_head': params})
                          .items()}, strict=True)
    run = jax.jit(lambda p, f, train: jm.apply({'params': p}, f,
                                               train=train),
                  static_argnums=2)
    return dict(case=request.param, cfg=cfg, jm=jm, params=params,
                port=port, feats=feats,
                train=jax.tree.map(np.asarray, run(params, feats, True)),
                test=jax.tree.map(np.asarray, run(params, feats, False)))


def test_fcos_head_forward_matches_jax(head):
    """Both branches: with norm_on_bbox the distances are ReLU'd strides in
    training and pixels at test time, else exp'd in both."""
    port = head['port']
    assert len(port.scales) == 5 and port.scales[0].scale.shape == ()
    feats = [T(f) for f in head['feats']]
    for train in (True, False):
        got = port(feats, train=train)
        want = head['train' if train else 'test']
        for gs, ws in zip(got, want):
            for g, w in zip(gs, ws):
                assert g.shape == w.shape and _rel(g, w) <= TOL_HEAD_OUT
    if head['case'] == 'normbbox':
        tr, te = head['train'][1][1], head['test'][1][1]
        np.testing.assert_allclose(te, tr * 16, rtol=1e-6)


def _jax_targets(m, sizes, gts, valid, labels):
    """The FCOS loss's targets as the JAX head computes them
    (fcos_head.py:191-214)."""
    pts = m._get_points(sizes)
    all_pts = jnp.concatenate(pts, 0)
    ranges = jnp.concatenate([jnp.broadcast_to(
        jnp.asarray(r, jnp.float32)[None], (p.shape[0], 2))
        for p, r in zip(pts, m.regress_ranges)], 0)
    strides = jnp.concatenate([jnp.full((p.shape[0],), s, jnp.float32)
                               for p, s in zip(pts, m.strides)], 0)
    lab, t, pos = jax.vmap(lambda gb, gv, gl: m._target_single(
        all_pts, strides, ranges, gb, gv, gl))(gts, valid, labels)
    if m.norm_on_bbox:
        t = t / strides[None, :, None]
    return lab, t, pos


def test_fcos_targets_match_jax(head):
    """Labels and positives equal, box targets within 1e-6 px (in strides
    with norm_on_bbox); the tied gts: the first one's label."""
    gts, valid, labels = _gts()
    want = jax.tree.map(np.asarray, jax.jit(lambda p, *a: head['jm'].apply(
        {'params': p}, method=lambda m: _jax_targets(m, SIZES, *a)))(
        head['params'], gts, valid, labels))
    got = head['port'].get_targets(SIZES, T(gts), T(valid), T(labels))
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=1e-6)
    pos = want[2]
    assert pos[0].sum() >= 10 and pos[1].sum() >= 10
    # the points of image 1 whose box targets are its gt 1's (and so its
    # gt 2's, the same box) take gt 1's label
    tied = pos[1] & (want[0][1] == labels[1, 1])
    assert tied.any() and not (pos[1] & (want[0][1] == labels[1, 2])
                               & ~tied).any()


def test_fcos_head_loss_matches_jax(head):
    """loss_cls, loss_bbox and loss_centerness at rel 1e-6, their
    gradients with respect to the head's training outputs at 1e-5."""
    gts, valid, labels = _gts()
    shapes = np.array([[H, W]] * 2, np.int32)
    outs = head['train']

    def loss(o):
        return head['jm'].apply({'params': head['params']},
                                jax.random.PRNGKey(0), *o, gts, valid,
                                labels, shapes, shapes, method='loss')
    parts, grads = jax.jit(lambda o: (loss(o), jax.grad(
        lambda o_: sum(loss(o_).values()))(o)))(outs)
    ts = [[T(a).requires_grad_() for a in lvl] for lvl in outs]
    got = head['port'].loss(*ts, T(gts), T(valid), T(labels))
    assert set(got) == {'loss_cls', 'loss_bbox', 'loss_centerness'}
    for k, v in got.items():
        assert float(parts[k]) > 0
        assert abs(float(v) - float(parts[k])) <= TOL_HEAD_LOSS * float(
            parts[k]), (k, float(v), float(parts[k]))
    sum(got.values()).backward()
    for t_lvl, g_lvl in zip(ts, grads):
        for t, g in zip(t_lvl, g_lvl):
            assert _rel(t.grad, g) <= TOL_HEAD_GRAD


@pytest.mark.parametrize('with_nms', [True, False])
def test_fcos_head_get_bboxes_matches_jax(head, with_nms):
    """The top nms_pre points a level by best score times centerness
    (tie-free: the class logits drawn with std 1), decode, rescale, then
    the multiclass NMS with the centerness as score factor."""
    shapes = np.array([[H, W], [H - 16, W - 32]], np.int32)
    sf = np.array([[1.0] * 4, [0.75] * 4], np.float32)
    outs = head['test']
    want = jax.tree.map(np.asarray, jax.jit(lambda p, *a: head['jm'].apply(
        {'params': p}, *a, rescale=True, with_nms=with_nms,
        method='get_bboxes'))(head['params'], *outs, shapes, sf))
    with torch.no_grad():
        got = head['port'].get_bboxes(*[[T(a) for a in lvl] for lvl in outs],
                                      T(shapes), T(sf), rescale=True,
                                      with_nms=with_nms)
    if not with_nms:
        # 100 a level where a level holds more points (nms_pre)
        assert got[1].shape == want[1].shape == (2, 100 + 96 + 24 + 6 + 2,
                                                 5)
        for g, w, tol in zip(got, want, (1e-3, 1e-6, 1e-6)):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)
        return
    v = want.valid
    assert np.array_equal(got.valid.numpy(), v) and v.sum(1).min() >= 4
    assert np.array_equal(got.labels.numpy()[v], want.labels[v])
    np.testing.assert_allclose(got.dets.numpy()[v][:, :4],
                               want.dets[v][:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.dets.numpy()[v][:, 4], want.dets[v][:, 4],
                               rtol=0, atol=1e-4)


# ------------------------------------------------------- NAS-FCOS neck
# the levels of an 800x1344 canvas (C3-C5 and P6) and of a 100x164 one
FULL_LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21))
ODD_LEVELS = ((13, 21), (7, 11), (4, 6))


@pytest.mark.parametrize('src,dst', [
    (a, b) for levels in (FULL_LEVELS, ODD_LEVELS)
    for a in levels for b in levels if a != b] + [((13, 21), (25, 42))])
def test_nasfcos_resizes_match_jax_image_resize(src, dst):
    """resize_nearest_half_pixel equals jax.image.resize 'nearest' bit for
    bit (which torch's 'nearest' does not, at 13 -> 25 rows), and
    resize_bilinear_aa its 'bilinear', antialiased where it shrinks, to
    fp32 rounding."""
    x = np.random.RandomState(2).randn(2, *src, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, *dst, 3), 'nearest'))
    assert np.array_equal(resize_nearest_half_pixel(T(x), dst).numpy(),
                          want)
    if src == (13, 21) and dst == (25, 42):
        plain = torch.nn.functional.interpolate(
            T(x).permute(0, 3, 1, 2), size=dst, mode='nearest')
        assert not np.array_equal(plain.permute(0, 2, 3, 1).numpy(), want)
    want = jax.image.resize(x, (2, *dst, 3), 'bilinear')
    assert _rel(resize_bilinear_aa(T(x), dst), want) <= 1e-6


class _JaxNeck(flax_nn.Module):
    """NASFCOS_FPN on C3-C5, C2 (which it reads for no output) zeros."""
    kw: dict

    @flax_nn.compact
    def __call__(self, xs):
        c2 = jnp.zeros((xs[0].shape[0], 25, 41, 8), jnp.float32)
        return JaxNASFPN(**self.kw, name='_neck')([c2] + list(xs))


class _PortNeck(torch.nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.neck = NASFCOS_FPN(**kw)

    def forward(self, xs):
        return self.neck([xs[0].new_zeros(xs[0].shape[0], 25, 41, 8)]
                         + list(xs))


def test_nasfcos_fpn_matches_jax_at_odd_sizes():
    """The neck (plain cell convs: the detectors below run the DCNv2
    ones; frozen BNs) on
    C3-C5 of a 100x164 canvas (C3 13x21: the cells upsample C5's 4x6 to
    it, the readout shrinks 13x21 to 7x11): outputs at 1e-5, every
    gradient at 1e-4 (check_module), the BN buffers unmoved in training
    mode, no conv on the conv3x3 kernel."""
    kw = dict(in_channels=(8, 16, 32, 64), out_channels=16, start_level=1,
              num_outs=5, norm_cfg=dict(type='BN'))
    rs = np.random.RandomState(3)
    xs = [rs.randn(2, h, w, c).astype(np.float32) for (h, w), c in zip(
        ((13, 21), (7, 11), (4, 6)), kw['in_channels'][1:])]
    port = _PortNeck(**kw)
    check_module(_JaxNeck(kw), port, xs)
    bufs = {k: v.clone() for k, v in port.named_buffers()}
    outs = port([T(x) for x in xs])
    assert [tuple(o.shape[1:3]) for o in outs] == [
        (13, 21), (7, 11), (4, 6), (2, 3), (1, 2)]
    assert all(torch.equal(v, bufs[k]) for k, v in port.named_buffers())
    assert not any(getattr(m, 'use_kernel', False) for m in port.modules())


# ------------------------------------------------------------ detectors
CONFIGS = {
    'fcos_gn': 'configs/fcos/fcos_center-normbbox-centeronreg-giou_'
               'r50_caffe_fpn_gn-head_1x_coco.py',
    'nasfcos': 'configs/nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_'
               '4x4_1x_coco.py',
    'nasfcos_fcoshead': 'configs/nas_fcos/nas_fcos_fcoshead_r50_caffe_fpn_'
                        'gn-head_4x4_1x_coco.py',
}
FULL_WIDTH = {
    'fcos': 'configs/fcos/fcos_r50_fpn_1x_coco.py',
    **CONFIGS,
    'fcos_gn_dcn': 'configs/fcos/fcos_center-normbbox-centeronreg-giou_'
                   'r50_caffe_fpn_gn-head_dcn_1x_coco.py',
}


def _config(path):
    cfg = _plain(Config.fromfile(path).model)
    cfg.pop('pretrained', None)
    return cfg


def tiny_cfg(name):
    """'fcos': the JAX tests' tiny FCOS; the others their config with the
    JAX tests' ResNet-18 (its configs' ResNet-50 is no module of this
    slice), of base width 8, the neck and head at 32 channels, GN in groups
    of 4, two tower convs (FCOS's), 4 classes, 100 candidates a level and
    16 detections; every module type and option as configured."""
    if name == 'fcos':
        return tiny_fcos_cfg()
    cfg = _config(CONFIGS[name])
    cfg['backbone'].update(depth=18, base_channels=8)
    cfg['neck'].update(in_channels=[8, 16, 32, 64], out_channels=32)
    head = cfg['bbox_head']
    head.update(num_classes=4, in_channels=32, feat_channels=32,
                norm_cfg=dict(head['norm_cfg'], num_groups=4))
    if head['type'] == 'FCOSHead':
        head['stacked_convs'] = 2
    # three levels: the deformable convs' gathers set the JAX package's
    # compile time, which grows with each level's 4 (NAS-FCOS) or 2 of
    # them; test_nasfcos_fpn_matches_jax_at_odd_sizes runs the neck's
    # extra levels
    cfg['neck']['num_outs'] = 3
    head.update(strides=[8, 16, 32],
                regress_ranges=((-1, 64), (64, 128), (128, 1e8)))
    cfg['test_cfg'].update(nms_pre=100, max_per_img=16)
    return cfg


def jax_readable_names(sd, params):
    """jax_readable (test_torch_backbones.py), then the names of this
    slice that the JAX converter does not read as mmdet writes them
    (swindet_tpu/checkpoint.py:45-80): a list of necks' ``neck.{i}.``
    (the JAX package's ``_neck{i}``), NASFCOS_FPN's ``adapt_convs.{i}``
    and ``extra_downsamples.{i}.conv``, and a ConcatCell's input-conv
    norms ``input{1,2}_conv.bn`` and ``out_conv.bn`` / ``out_conv.conv``
    (its BN keys lose '.bn.' there, and its output norm and conv are
    ``out_norm`` and ``out_conv``)."""
    out = {}
    for k, v in jax_readable(sd, params).items():
        k = re.sub(r'^neck\.(\d+)\.', r'neck\1.', k)
        k = re.sub(r'^neck\.adapt_convs\.(\d+)\.conv\.',
                   r'neck.adapt_convs\1.conv.', k)
        k = re.sub(r'^neck\.adapt_convs\.(\d+)\.bn\.', r'neck.adapt_convs\1.',
                   k)
        k = re.sub(r'^neck\.extra_downsamples\.(\d+)\.conv\.',
                   r'neck.extra_downsamples\1.', k)
        k = re.sub(r'\.(input[12]_conv)\.bn\.', r'.\1.', k)
        k = k.replace('.out_conv.bn.', '.out_norm.')
        k = k.replace('.out_conv.conv.', '.out_conv.')
        out[k] = v
    return out


def single_stage_case(cfg):
    """A shrunk config's JAX detector, numpy params (conv_cls drawn with
    std 1, so that no top-k or NMS boundary sits within fp32 noise; the
    scales 1 + N(0, 0.1^2)) and batch statistics, and the port's detector
    on them (eval mode)."""
    jm = jax_build_detector(copy.deepcopy(cfg))
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 0)
    rs = np.random.RandomState(100)
    head = params['_bbox_head']
    head['conv_cls']['kernel'] = rs.randn(
        *head['conv_cls']['kernel'].shape).astype(np.float32)
    head['scales'] = (1 + 0.1 * rs.randn(*head['scales'].shape)).astype(
        np.float32)
    stats = _draw_stats(shapes.get('batch_stats', {}), 200)
    sd = state_dict_from_jax(params, stats)
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(sd, strict=True)
    return dict(cfg=cfg, jm=jm, params=params, stats=stats, sd=sd,
                port=port.eval())


@functools.lru_cache(maxsize=None)
def detector_case(name):
    case = single_stage_case(tiny_cfg(name))
    case['name'] = name
    return case


# the detectors held serving and their weights' round trip, and those held
# training: NAS-FCOS's searched neck trains under the 'fcoshead' config,
# its searched head serves under 'nashead' (the towers' ConvModules, DCNv2
# with GN included, train in test_torch_dcn.py): each of the JAX package's
# deformable convs takes ~1.5 s of XLA compile in a gradient
SERVED = ('fcos', 'fcos_gn', 'nasfcos')
TRAINED = ('fcos', 'fcos_gn', 'nasfcos_fcoshead')


@pytest.fixture(scope='module', params=SERVED)
def detector(request):
    return detector_case(request.param)


@pytest.fixture(scope='module', params=TRAINED)
def trained(request):
    return detector_case(request.param)


def test_detector_simple_test_matches_jax(detector):
    check_simple_test(detector)
    kinds = {type(m).__name__ for m in detector['port'].modules()}
    assert {'fcos': 'FCOSHead', 'fcos_gn': 'Norm',
            'nasfcos': 'ConcatCell'}[detector['name']] in kinds


def test_detector_forward_train_matches_jax(trained):
    """forward_train on both sides with the same batch: the three losses
    at rel 1e-4, every gradient at 1e-3 of its largest entry, none in the
    frozen stem and layer1; the BN buffers unmoved."""
    detector = trained
    cfg, jm = detector['cfg'], detector['jm']
    batch = make_batch()
    names = ['img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
             'gt_labels']
    args = [jnp.asarray(batch[k]) for k in names]

    def total(p):
        losses = jm.apply({'params': p, 'batch_stats': detector['stats']},
                          *args, method='forward_train',
                          rngs={'sampling': jax.random.PRNGKey(1)})
        return jax_parse_losses(losses)
    (_, want), grads = jit_o0(jax.value_and_grad(total, has_aux=True))(
        detector['params'])
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(detector['sd'], strict=True)
    port.train()
    losses = port.forward_train(*[T(batch[k]) for k in names])
    assert set(losses) == {'loss_cls', 'loss_bbox', 'loss_centerness'}
    for k, v in losses.items():
        assert abs(float(v) - float(want[k])) <= TOL_LOSS * abs(
            float(want[k])), (k, float(v), float(want[k]))
    sum(losses.values()).backward()
    bufs = dict(port.named_buffers())
    assert all(torch.equal(bufs[k], v) for k, v in detector['sd'].items()
               if k in bufs)
    frozen = cfg['backbone'].get('frozen_stages', -1) >= 1
    checked = 0
    for name, p in port.named_parameters():
        w = want_grads[name]
        if frozen and name.startswith(('backbone.conv1.', 'backbone.bn1.',
                                       'backbone.layer1.')):
            assert p.grad is None and not w.abs().max(), name
            continue
        assert p.grad is not None, name
        if not w.abs().max():
            # a level's scale with no positive point on it
            assert not p.grad.abs().max(), name
            continue
        assert _rel(p.grad, w) <= TOL_GRAD, (name, _rel(p.grad, w))
        checked += 1
    assert checked > 30


def check_round_trip_names(case):
    """check_round_trip (test_torch_backbones.py) through
    jax_readable_names: state_dict_from_jax, then the JAX package's
    convert_torch_state_dict gives the parameters and batch statistics back
    bit for bit, no key missing or left over."""
    new_params, new_stats, report = convert_torch_state_dict(
        jax_readable_names(case['sd'], case['params']), case['params'],
        batch_stats=case['stats'],
        flatten_hints=default_flatten_hints(case['cfg']))
    assert not report['missing'] and not report['unexpected'], report
    for a, b in ((new_params, case['params']), (new_stats, case['stats'])):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb)
        assert all(np.array_equal(np.asarray(u), v) for u, v in zip(la, lb))


def test_detector_weights_round_trip_bit_exact(detector):
    check_round_trip_names(detector)


@pytest.mark.parametrize('name', list(FULL_WIDTH))
def test_config_full_width_names_and_shapes(name):
    """Each config at full width (built on the meta device): the names and
    shapes of state_dict_from_jax of the JAX init's, mmdet's among
    them."""
    port = check_full_width_names(_config(FULL_WIDTH[name]))
    keys = set(port.state_dict())
    want = {'bbox_head.scales.4.scale', 'bbox_head.conv_centerness.weight'}
    if name.startswith('nasfcos'):
        want |= {'neck.adapt_convs.2.conv.weight',
                 'neck.adapt_convs.0.bn.running_var',
                 'neck.fpn.c22_1.input1_conv.conv.conv_offset.weight',
                 'neck.fpn.c61.input2_conv.bn.weight',
                 'neck.fpn.c02.out_conv.bn.running_mean',
                 'neck.fpn.c36.out_conv.conv.weight',
                 'neck.extra_downsamples.1.conv.bias'}
    if name == 'nasfcos':
        want |= {'bbox_head.cls_convs.0.conv.conv_offset.weight',
                 'bbox_head.reg_convs.3.gn.weight'}
    if name == 'fcos_gn_dcn':
        want |= {'bbox_head.cls_convs.3.conv.conv_offset.weight',
                 'bbox_head.reg_convs.3.gn.bias',
                 'bbox_head.reg_convs.3.conv.bias'}
    assert want <= keys, want - keys
