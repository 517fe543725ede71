"""The port's ATSS line (ATSS, GFL and VFNet) against the JAX package on
the CPU, fp32, on the same numpy weights and inputs:

- ``bbox2distance`` with and without its ``max_dis`` clip;
- ``ATSSAssigner``: gts centred between anchors of a grid, so that
  candidates tie in distance at each level's top-k cut (the lower index
  first, as ``jax.lax.top_k``; ``torch.topk``'s order picks other
  candidates and another assignment), a level with fewer valid anchors
  than k, an ignore region and a padded gt;
- ``QualityFocalLoss``, ``DistributionFocalLoss`` and ``VarifocalLoss``:
  values and gradients, a logit whose sigmoid underflows to its target
  among them (the modulators' gradients at 0);
- each head on five levels: its outputs, ATSS targets, losses and their
  gradients with respect to its outputs, and ``get_bboxes`` with and
  without NMS;
- the JAX tests' tiny ATSS and GFL detectors and the config of their
  ``test_vfnet_forward``: ``simple_test``, ``forward_train``'s losses and
  every gradient, and the weights' round trip through the JAX converter;
- the three configs at full width: the port's names and shapes equal
  ``state_dict_from_jax`` of the JAX init's, mmdet's among them;
- every config of configs/atss, configs/gfl and configs/vfnet builds in
  the port (on the meta device) wherever it builds in the JAX package.

Tolerances are test_torch_fcos.py's: losses at rel 1e-6, head outputs at
rel 1e-5, head gradients at 1e-5 of their largest entry; detections with
labels equal, boxes within 1e-3 px and scores within 1e-4 (or twice the JAX
package's own movement under fp32 noise of 1e-7); detector losses at rel
1e-4 and gradients at 1e-3 of each tensor's largest entry.
"""
import copy
import functools
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as flax_nn
import pytest
import torch

from swindet_tpu.core.bbox.assigners import ATSSAssigner as JaxATSSAssigner
from swindet_tpu.core.bbox.coders import bbox2distance as jax_bbox2distance
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.models.builder import build_head as jax_build_head
from swindet_tpu.models.losses import losses as jax_losses

from tests.test_models.test_single_stage import tiny_atss_cfg, tiny_gfl_cfg
from tests.test_torch_backbones import (check_full_width_names,
                                        check_simple_test, jit_o0)
from tests.test_torch_cascade import _draw_stats, numpy_params_from
from tests.test_torch_fcos import (SIZES, H, W, T, _config, _gts, _rel,
                                   check_round_trip_names)
from tests.test_torch_train import make_batch
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.core.bbox import assigners, bbox2distance
from swindet_tpu_torch.core.bbox.assigners import ATSSAssigner
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models import losses as port_losses
from swindet_tpu_torch.models.builder import build_head

cap_torch_threads()

TOL_HEAD_LOSS = 1e-6
TOL_HEAD_OUT = 1e-5
TOL_HEAD_GRAD = 1e-5
TOL_LOSS = 1e-4
TOL_GRAD = 1e-3


def tiny_vfnet_cfg():
    """The config of test_single_stage.py's test_vfnet_forward."""
    return dict(
        type='VFNet',
        backbone=dict(type='ResNet', depth=18, base_channels=16,
                      out_indices=(1, 2, 3)),
        neck=dict(type='FPN', in_channels=[32, 64, 128], out_channels=16,
                  start_level=0, add_extra_convs='on_output', num_outs=5,
                  relu_before_extra_convs=True),
        bbox_head=dict(type='VFNetHead', num_classes=4, in_channels=16,
                       feat_channels=16, stacked_convs=1,
                       norm_cfg=dict(type='GN', num_groups=4),
                       strides=[8, 16, 32, 64, 128]),
        train_cfg=dict(assigner=dict(type='ATSSAssigner', topk=9),
                       allowed_border=-1, pos_weight=-1, debug=False),
        test_cfg=dict(nms_pre=100, score_thr=0.05,
                      nms=dict(type='nms', iou_threshold=0.6),
                      max_per_img=16))


TINY = {'atss': tiny_atss_cfg, 'gfl': tiny_gfl_cfg, 'vfnet': tiny_vfnet_cfg}
# each head's class output, drawn with std 1 so that no top-k or NMS
# boundary sits within fp32 noise
CLS_CONV = {'atss': 'atss_cls', 'gfl': 'gfl_cls', 'vfnet': 'vfnet_cls'}
LOSSES = {'atss': {'loss_cls', 'loss_bbox', 'loss_centerness'},
          'gfl': {'loss_cls', 'loss_bbox', 'loss_dfl'},
          'vfnet': {'loss_cls', 'loss_bbox', 'loss_bbox_rf'}}


def test_bbox2distance_matches_jax():
    """Distances from points to boxes (some points outside their box),
    plain and clipped to [0, max_dis - eps]: equal bit for bit."""
    rs = np.random.RandomState(1)
    pts = rs.uniform(0, 20, (3, 40, 2)).astype(np.float32)
    boxes = np.concatenate([rs.uniform(-4, 12, (3, 40, 2)),
                            rs.uniform(8, 30, (3, 40, 2))], -1) \
        .astype(np.float32)
    for kw in ({}, dict(max_dis=16)):
        assert np.array_equal(
            bbox2distance(T(pts), T(boxes), **kw).numpy(),
            np.asarray(jax_bbox2distance(pts, boxes, **kw)))
    clipped = bbox2distance(T(pts), T(boxes), max_dis=16)
    assert clipped.min() == 0 and clipped.max() == np.float32(16 - 0.1)


# ---------------------------------------------------------- ATSSAssigner
def _grid_anchors(levels):
    """Square anchors (4 strides wide) centred on each level's grid cells,
    concatenated, and each level's count."""
    out = []
    for (h, w), s in levels:
        cy, cx = np.meshgrid((np.arange(h) + 0.5) * s, (np.arange(w) + 0.5)
                             * s, indexing='ij')
        c = np.stack([cx.ravel(), cy.ravel()], -1)
        out.append(np.concatenate([c - 2 * s, c + 2 * s], -1))
    return np.concatenate(out).astype(np.float32), [len(a) for a in out]


def _assign_both(assigner_kw, anchors, counts, gts, gt_valid, labels,
                 bbox_valid, ignore=None):
    want = jax.jit(lambda *a: JaxATSSAssigner(**assigner_kw).assign(
        a[0], counts, *a[1:4], bbox_valid=a[4],
        **({} if ignore is None else dict(gt_bboxes_ignore=a[5],
                                          gt_ignore_valid=a[6]))))(
        anchors, gts, gt_valid, labels, bbox_valid,
        *(() if ignore is None else ignore))
    got = ATSSAssigner(**assigner_kw).assign(
        T(anchors), counts, T(gts), T(gt_valid), T(labels),
        bbox_valid=T(bbox_valid),
        **({} if ignore is None else dict(gt_bboxes_ignore=T(ignore[0]),
                                          gt_ignore_valid=T(ignore[1]))))
    return want, got


def _same(want, got):
    return (np.array_equal(got.gt_inds.numpy(), np.asarray(want.gt_inds))
            and np.array_equal(got.labels.numpy(), np.asarray(want.labels))
            and np.allclose(got.max_overlaps.numpy(),
                            np.asarray(want.max_overlaps), rtol=0,
                            atol=1e-6))


# three levels of a 96x96 canvas (the last 3x3: fewer anchors than k); gts
# centred on cell corners (ties at each level's cut), one a copy of
# another under another label, one padding
ASSIGN_LEVELS = (((12, 12), 8), ((6, 6), 16), ((3, 3), 32))
ASSIGN_GTS = np.array([[4, 28, 60, 52], [40, 48, 88, 72], [40, 48, 88, 72],
                       [8, 60, 30, 90], [0, 0, 0, 0]], np.float32)


def _assign_case(ignore=False):
    anchors, counts = _grid_anchors(ASSIGN_LEVELS)
    valid = np.array([1, 1, 1, 1, 0], bool)
    labels = np.array([0, 1, 2, 3, 0], np.int32)
    bbox_valid = np.ones(len(anchors), bool)
    # the second level's left half outside the image: 18 valid anchors,
    # and a gt's candidates there lie at +INF distance past them
    bbox_valid[counts[0]:counts[0] + counts[1]] = \
        np.tile(np.arange(6) >= 3, 6)
    ign = (np.array([[56, 0, 96, 40], [0, 0, 0, 0]], np.float32),
           np.array([True, False])) if ignore else None
    return anchors, counts, valid, labels, bbox_valid, ign


@pytest.mark.parametrize('ignore', [False, True])
def test_atss_assigner_matches_jax(ignore):
    """gt_inds, labels and max_overlaps equal the JAX assigner's, on the
    ties at the top-k cuts, the partly invalid level, the 3x3 level (k
    clipped to its 9 anchors), the padded gt (which claims nothing), the
    copied gt (its first copy wins every tie in IoU) and, with an
    ignore region (ignore_iof_thr 0.5), the anchors inside it (-1)."""
    anchors, counts, valid, labels, bbox_valid, ign = _assign_case(ignore)
    kw = dict(topk=9, ignore_iof_thr=0.5 if ignore else -1)
    want, got = _assign_both(kw, anchors, counts, ASSIGN_GTS, valid, labels,
                             bbox_valid, ign)
    assert _same(want, got)
    gi = got.gt_inds.numpy()
    assert set(np.unique(gi)) >= {-1, 0, 1, 2, 4} and 3 not in gi \
        and 5 not in gi
    assert (gi[~bbox_valid] == -1).all()
    if ignore:
        n_ignored = int(((gi == -1) & bbox_valid).sum())
        assert n_ignored > 0


def test_atss_assigner_ties_fail_under_torch_topk(monkeypatch):
    """The same case with torch.topk's order at each level's cut picks
    other candidates among the tied anchors, and its assignment departs
    from the JAX assigner's."""
    anchors, counts, valid, labels, bbox_valid, _ = _assign_case()
    monkeypatch.setattr(assigners, 'smallest_k',
                        lambda d, k: torch.topk(-d, k, dim=1).indices)
    want, got = _assign_both(dict(topk=9), anchors, counts, ASSIGN_GTS,
                             valid, labels, bbox_valid)
    assert not _same(want, got)


# --------------------------------------------------------------- losses
def _loss_pair(name, kw, pred, target, weight, avg_factor=7.5):
    """Value and gradient with respect to ``pred`` of the JAX and the port's
    loss ``name`` on the same inputs."""
    def jax_loss(p):
        return getattr(jax_losses, name)(**kw)(
            p, jax.tree.map(jnp.asarray, target), weight=jnp.asarray(weight),
            avg_factor=avg_factor)
    want, g_want = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(pred))
    p = T(pred).requires_grad_()
    got = getattr(port_losses, name)(**kw)(
        p, jax.tree.map(T, target), weight=T(weight), avg_factor=avg_factor)
    got.backward()
    return float(got), float(want), p.grad, np.asarray(g_want)


def _logits(rs, n, c):
    x = (3 * rs.randn(n, c)).astype(np.float32)
    # a sigmoid that underflows to 0: a zero target's modulator sits at 0
    x[0, 0] = -200.0
    return x


@pytest.mark.parametrize('beta', [2.0, 1.5])
def test_quality_focal_loss_matches_jax(beta):
    """Labels over the classes, the background and an ignored -1; quality
    scores in [0, 1], 0 included: rel 1e-6, gradient 1e-5."""
    rs = np.random.RandomState(2)
    pred = _logits(rs, 60, 5)
    label = rs.randint(-1, 6, 60).astype(np.int32)
    label[0] = 0
    score = rs.rand(60).astype(np.float32)
    score[:4] = 0.0
    weight = rs.rand(60).astype(np.float32)
    got, want, g, gw = _loss_pair('QualityFocalLoss',
                                  dict(beta=beta, loss_weight=1.5), pred,
                                  (label, score), weight)
    assert abs(got - want) <= TOL_HEAD_LOSS * abs(want)
    assert _rel(g, gw) <= TOL_HEAD_GRAD


def test_distribution_focal_loss_matches_jax():
    """Continuous labels over 17 bins, integers, 0 and past the last bin
    (clipped to 16 - 1e-6) among them: rel 1e-6, gradient 1e-5."""
    rs = np.random.RandomState(3)
    pred = (2 * rs.randn(80, 17)).astype(np.float32)
    label = rs.uniform(0, 16, 80).astype(np.float32)
    label[:6] = [0.0, 3.0, 15.9, 16.0, 17.5, 15.99999]
    weight = rs.rand(80).astype(np.float32)
    got, want, g, gw = _loss_pair('DistributionFocalLoss',
                                  dict(loss_weight=0.25), pred, label,
                                  weight)
    assert abs(got - want) <= TOL_HEAD_LOSS * abs(want)
    assert _rel(g, gw) <= TOL_HEAD_GRAD


@pytest.mark.parametrize('iou_weighted', [True, False])
def test_varifocal_loss_matches_jax(iou_weighted):
    """IoU targets on a fifth of the entries, 0 elsewhere, a per-row
    weight: rel 1e-6, gradient 1e-5."""
    rs = np.random.RandomState(4)
    pred = _logits(rs, 50, 4)
    target = np.where(rs.rand(50, 4) < 0.2, rs.rand(50, 4), 0.0) \
        .astype(np.float32)
    target[0, 0] = 0.0
    weight = rs.rand(50).astype(np.float32)
    got, want, g, gw = _loss_pair(
        'VarifocalLoss', dict(alpha=0.75, gamma=2.0,
                              iou_weighted=iou_weighted), pred, target,
        weight)
    assert abs(got - want) <= TOL_HEAD_LOSS * abs(want)
    assert _rel(g, gw) <= TOL_HEAD_GRAD


# ----------------------------------------------------------------- heads
def _jax_targets(name, m, gts, valid, labels, shapes):
    """The head's ATSS targets as the JAX head computes them: labels,
    label weights (VFNet: none), box targets and positives."""
    if name == 'vfnet':
        pts = jnp.concatenate(m._get_points(SIZES), 0)
        anchors = m.atss_prior_generator.grid_anchors(SIZES)
    else:
        anchors = m.get_anchors(SIZES)
    flat, counts = jnp.concatenate(anchors, 0), [a.shape[0] for a in anchors]
    if name == 'vfnet':
        lab, t, pos = jax.vmap(lambda gb, gv, gl, sh:
                               m._atss_vfnet_target_single(
                                   SIZES, pts, flat, counts, gb, gv, gl, sh,
                                   sh))(gts, valid, labels, shapes)
        return lab, None, t, pos
    fn = m._atss_target_single if name == 'atss' else m._gfl_target_single
    return jax.vmap(lambda gb, gv, gl, sh: fn(
        SIZES, flat, counts, gb, gv, gl, sh, sh))(gts, valid, labels, shapes)


@pytest.fixture(scope='module', params=list(TINY))
def head(request):
    """The JAX and the port's head of a tiny config on the same weights
    (the class output's with std 1, the scales 1 + N(0, 0.1^2)) and five
    levels of features, and every JAX reference of the head tests from
    one compiled function: the outputs, the ATSS targets of _gts(), the
    losses and their gradients with respect to the outputs, and
    get_bboxes with and without NMS."""
    name = request.param
    det = TINY[name]()
    cfg = dict(det['bbox_head'], train_cfg=det['train_cfg'],
               test_cfg=det['test_cfg'])
    jm = jax_build_head(dict(cfg))
    rs = np.random.RandomState(1)
    feats = [rs.randn(2, h, w, 16).astype(np.float32) for h, w in SIZES]
    shapes = jax.eval_shape(lambda k: jm.init(k, feats),
                            jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 2)
    cls = params[CLS_CONV[name]]
    cls['kernel'] = rs.randn(*cls['kernel'].shape).astype(np.float32)
    for k in ('scales', 'scales_refine'):
        if k in params:
            params[k] = (1 + 0.1 * rs.randn(5)).astype(np.float32)
    port = build_head(dict(cfg))
    port.load_state_dict({k[len('bbox_head.'):]: v for k, v in
                          state_dict_from_jax({'_bbox_head': params})
                          .items()}, strict=True)
    gts, valid, labels = _gts()
    img_shapes = np.array([[H, W]] * 2, np.int32)
    test_shapes = np.array([[H, W], [H - 16, W - 32]], np.int32)
    sf = np.array([[1.0] * 4, [0.75] * 4], np.float32)

    def references(p):
        def apply(*a, **kw):
            return jm.apply({'params': p}, *a, **kw)
        outs = apply(feats)

        def loss(o):
            parts = apply(jax.random.PRNGKey(0), *o, gts, valid, labels,
                          img_shapes, img_shapes, method='loss')
            return sum(parts.values()), parts
        targets = apply(method=lambda m: _jax_targets(
            name, m, gts, valid, labels, img_shapes))
        boxes = [apply(*outs, test_shapes, sf, rescale=True,
                       with_nms=with_nms, method='get_bboxes')
                 for with_nms in (True, False)]
        (_, losses), grads = jax.value_and_grad(loss, has_aux=True)(outs)
        return dict(outs=outs, targets=targets, losses=losses, grads=grads,
                    nms=boxes[0], candidates=boxes[1])
    ref = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                       jit_o0(references)(params),
                       is_leaf=lambda a: a is None)
    return dict(name=name, port=port, feats=feats, ref=ref, gts=(gts, valid,
                                                                   labels),
                img_shapes=img_shapes, test_shapes=test_shapes, sf=sf)


def test_head_forward_matches_jax(head):
    got = head['port']([T(f) for f in head['feats']])
    want = head['ref']['outs']
    assert len(got) == len(want) == (2 if head['name'] == 'gfl' else 3)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert g.shape == w.shape and _rel(g, w) <= TOL_HEAD_OUT


def test_head_targets_match_jax(head):
    """Labels, label weights and positives equal; box targets (ATSS:
    encoded deltas, GFL: the gt boxes, VFNet: the points' distances)
    within 1e-5 (deltas) or 1e-4 px; positives on several levels, and
    the copied gt's anchors (a tie in IoU) under its first copy's label."""
    port, name = head['port'], head['name']
    lab_w, lw_w, t_w, pos_w = head['ref']['targets']
    args = [T(a) for a in head['gts']] + [T(head['img_shapes'])] * 2
    if name == 'vfnet':
        lab, t, pos, _ = port.vfnet_targets(SIZES, *args)
    else:
        flat, lab, lw, pos, pos_gt = port.atss_targets(SIZES, *args)
        assert np.array_equal(lw.numpy(), lw_w)
        t = pos_gt if name == 'gfl' else torch.where(
            pos[..., None], port.bbox_coder.encode(flat[None], pos_gt), 0.0)
    assert np.array_equal(lab.numpy(), lab_w)
    assert np.array_equal(pos.numpy(), pos_w)
    np.testing.assert_allclose(t.numpy(), t_w, rtol=0,
                               atol=1e-5 if name == 'atss' else 1e-4)
    assert pos_w[0].sum() >= 10 and pos_w[1].sum() >= 10
    labels = head['gts'][2]
    assert (lab_w[1][pos_w[1]] == labels[1, 1]).any() \
        and not (lab_w[1][pos_w[1]] == labels[1, 2]).any()


def test_head_loss_matches_jax(head):
    """Each loss at rel 1e-6, the gradients of their sum with respect to
    the head's outputs at 1e-5 of the largest entry."""
    outs = head['ref']['outs']
    ts = [[T(a).requires_grad_() for a in lvl] for lvl in outs]
    args = [T(a) for a in head['gts']] + [T(head['img_shapes'])] * 2
    got = head['port'].loss(*ts, *args)
    want = head['ref']['losses']
    assert set(got) == set(want) == LOSSES[head['name']]
    for k, v in got.items():
        assert float(want[k]) > 0
        assert abs(float(v) - float(want[k])) <= TOL_HEAD_LOSS * float(
            want[k]), (k, float(v), float(want[k]))
    sum(got.values()).backward()
    for t_lvl, g_lvl in zip(ts, head['ref']['grads']):
        for t, g in zip(t_lvl, g_lvl):
            assert _rel(t.grad, g) <= TOL_HEAD_GRAD


@pytest.mark.parametrize('with_nms', [True, False])
def test_head_get_bboxes_matches_jax(head, with_nms):
    """nms_pre candidates a level (ATSS: by score times centerness), their
    boxes decoded, clipped and rescaled, then the multiclass NMS (ATSS:
    the centerness as score factor)."""
    outs = head['ref']['outs']
    with torch.no_grad():
        got = head['port'].get_bboxes(
            *[[T(a) for a in lvl] for lvl in outs], T(head['test_shapes']),
            T(head['sf']), rescale=True, with_nms=with_nms)
    if not with_nms:
        want = head['ref']['candidates']
        assert len(got) == len(want) == (3 if head['name'] == 'atss' else 2)
        assert got[1].shape == want[1].shape == (2, 100 + 96 + 24 + 6 + 2, 5)
        for g, w, tol in zip(got, want, (1e-3, 1e-6, 1e-6)):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)
        return
    want = head['ref']['nms']
    v = want.valid
    assert np.array_equal(got.valid.numpy(), v) and v.sum(1).min() >= 4
    assert np.array_equal(got.labels.numpy()[v], want.labels[v])
    np.testing.assert_allclose(got.dets.numpy()[v][:, :4],
                               want.dets[v][:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.dets.numpy()[v][:, 4], want.dets[v][:, 4],
                               rtol=0, atol=1e-4)


# ------------------------------------------------------------ detectors
@functools.lru_cache(maxsize=None)
def detector_case(name):
    """A tiny config's JAX detector, numpy params (the class output drawn
    with std 1, the scales 1 + N(0, 0.1^2)) and batch statistics, and the
    port's detector on them (eval mode)."""
    cfg = TINY[name]()
    jm = jax_build_detector(copy.deepcopy(cfg))
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 0)
    rs = np.random.RandomState(100)
    head = params['_bbox_head']
    cls = head[CLS_CONV[name]]
    cls['kernel'] = rs.randn(*cls['kernel'].shape).astype(np.float32)
    for k in ('scales', 'scales_refine'):
        if k in head:
            head[k] = (1 + 0.1 * rs.randn(*head[k].shape)).astype(np.float32)
    stats = _draw_stats(shapes.get('batch_stats', {}), 200)
    sd = state_dict_from_jax(params, stats)
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(sd, strict=True)
    return dict(name=name, cfg=cfg, jm=jm, params=params, stats=stats,
                sd=sd, port=port.eval())


@pytest.fixture(scope='module', params=list(TINY))
def detector(request):
    return detector_case(request.param)


def test_detector_simple_test_matches_jax(detector):
    check_simple_test(detector)


def test_detector_weights_round_trip_bit_exact(detector):
    """state_dict_from_jax, then the JAX converter: the parameters and
    batch statistics back bit for bit (the per-level scales folded back
    into one vector, VFNet's scales_refine too; GFL's integral.project
    buffer read and skipped)."""
    check_round_trip_names(detector)
    if detector['name'] == 'gfl':
        np.testing.assert_array_equal(
            detector['sd']['bbox_head.integral.project'].numpy(),
            np.arange(9, dtype=np.float32))


def test_detector_forward_train_matches_jax(detector):
    """forward_train on both sides with the same batch: the three losses
    at rel 1e-4, every gradient at 1e-3 of its largest entry; the BN
    buffers unmoved."""
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
    assert set(losses) == LOSSES[detector['name']]
    for k, v in losses.items():
        assert abs(float(v) - float(want[k])) <= TOL_LOSS * abs(
            float(want[k])), (k, float(v), float(want[k]))
    sum(losses.values()).backward()
    bufs = dict(port.named_buffers())
    assert all(torch.equal(bufs[k], v) for k, v in detector['sd'].items()
               if k in bufs)
    checked = 0
    for name, p in port.named_parameters():
        w = want_grads[name]
        assert p.grad is not None, name
        if not w.abs().max():
            # a level's scale with no positive anchor on it
            assert not p.grad.abs().max(), name
            continue
        assert _rel(p.grad, w) <= TOL_GRAD, (name, _rel(p.grad, w))
        checked += 1
    assert checked > 30


# ----------------------------------------------------- full-width configs
FULL_WIDTH = {
    'atss': 'configs/atss/atss_r50_fpn_1x_coco.py',
    'gfl': 'configs/gfl/gfl_r50_fpn_1x_coco.py',
    'vfnet': 'configs/vfnet/vfnet_r50_fpn_1x_coco.py',
}


@pytest.mark.parametrize('name', list(FULL_WIDTH))
def test_config_full_width_names_and_shapes(name):
    """Each config at full width (built on the meta device): the names and
    shapes of state_dict_from_jax of the JAX init's, mmdet's among
    them."""
    keys = set(check_full_width_names(_config(FULL_WIDTH[name]))
               .state_dict())
    want = {'bbox_head.scales.4.scale', 'bbox_head.cls_convs.3.gn.weight',
            'neck.fpn_convs.4.conv.weight'}
    want |= {'atss': {'bbox_head.atss_centerness.weight',
                      'bbox_head.atss_reg.bias'},
             'gfl': {'bbox_head.gfl_reg.weight',
                     'bbox_head.integral.project'},
             'vfnet': {'bbox_head.scales_refine.4.scale',
                       'bbox_head.vfnet_reg_refine_dconv.weight',
                       'bbox_head.vfnet_cls_dconv.weight',
                       'bbox_head.vfnet_reg_conv.gn.bias'}}[name]
    if name == 'vfnet':
        want -= {'bbox_head.cls_convs.3.gn.weight'}
        want |= {'bbox_head.cls_convs.2.gn.weight'}
    assert want <= keys, want - keys


# ------------------------------------------------------- the config sweep
SWEEP = sorted(sum((glob.glob(f'configs/{d}/*.py')
                    for d in ('atss', 'gfl', 'vfnet')), []))
# the configs that fail in the JAX package too, with its reason
FAILS_IN_BOTH = {
    'vfnet_r2_101_fpn_mdconv_c3-c5_mstrain_2x_coco.py':
        "Res2Net takes no 'dcn' (swindet_tpu/models/backbones/"
        "res2net.py:102-115)",
}


def jax_setup(cfg):
    """Build the JAX package's detector: construct it and run every
    module's setup, without tracing a forward (its init under
    jax.eval_shape, the setups alone)."""
    def setup_all(m, seen):
        if id(m) in seen:
            return
        seen.add(id(m))
        m._try_setup()
        for v in list(vars(m).values()):
            for c in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(c, flax_nn.Module):
                    setup_all(c, seen)
    jm = jax_build_detector(cfg)
    jax.eval_shape(lambda k: jm.init(k, method=lambda m: setup_all(
        m, set())), jax.random.PRNGKey(0))


def test_sweep_lists_the_slice_configs():
    assert len(SWEEP) == 2 + 7 + 13
    assert set(FAILS_IN_BOTH) <= {os.path.basename(p) for p in SWEEP}


@pytest.mark.parametrize('path', SWEEP)
def test_config_builds_where_jax_builds(path):
    """Each config's detector builds with the port's build_detector on the
    meta device, and in the JAX package (jax_setup); the one that fails in
    the JAX package fails in the port with the same TypeError."""
    cfg = _config(path)
    if os.path.basename(path) in FAILS_IN_BOTH:
        for build in (jax_setup, build_detector):
            with torch.device('meta'), pytest.raises(TypeError,
                                                     match="'dcn'"):
                build(copy.deepcopy(cfg))
        return
    jax_setup(copy.deepcopy(cfg))
    with torch.device('meta'):
        model = build_detector(cfg)
    assert type(model).__name__ == cfg['type']
