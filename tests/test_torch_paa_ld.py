"""The port's PAA and LD against the JAX package on the CPU, fp32 (the EM
in float64), on the same numpy weights and inputs:

- the EM (``gmm_em_1d``) against the JAX package's host fit
  ``_np_em_single``, row by row, dense and padded, two loss modes and
  near-uniform losses, all rows in one batched call: the assignments equal
  and the log-likelihoods within one float32 ulp; the result the same
  whenever the loop reads whether it is done; and against sklearn's
  GaussianMixture as the reference fits it;
- the keep mask: an OR over the candidate slots, as the JAX package's
  ``.at[ci].max``, where invalid slots point at a kept anchor;
- ``KnowledgeDistillationKLDivLoss``: value and gradient, with soft labels
  whose softmax underflows to 0;
- each head on five levels: its outputs, losses (LD's with the teacher's
  soft targets and without) and their gradients with respect to its
  outputs; PAA's positives after the EM; PAA's ``get_bboxes`` with and
  without NMS and score voting;
- the JAX tests' tiny PAA and LD detectors: ``simple_test``,
  ``forward_train``'s losses and every gradient, the weights' round trip
  through the JAX converter (LD's teacher under ``teacher_model.``), and
  two SGD steps of LD, which leave the teacher bit-equal;
- every config of configs/paa and configs/ld builds in the port (on the
  meta device) wherever it builds in the JAX package.

Tolerances are test_torch_atss.py's: losses at rel 1e-6, head outputs at
rel 1e-5, head gradients at 1e-5 of their largest entry; detections with
labels equal, boxes within 1e-3 px and scores within 1e-4 (or twice the JAX
package's own movement under fp32 noise of 1e-7); detector losses at rel
1e-4 and gradients at 1e-3 of each tensor's largest entry; parameters after
the SGD steps within lr times 3e-3 of their gradients' largest entry (two
steps, the second with momentum 0.9 on the first) plus 1e-6 of their own.
"""
import copy
import functools
import glob

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from swindet_tpu.checkpoint import (convert_torch_state_dict,
                                  default_flatten_hints)
from swindet_tpu.engine.optimizer import build_optimizer as jax_build_opt
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.models.builder import build_head as jax_build_head
from swindet_tpu.models.dense_heads.paa_head import _np_em_single
from swindet_tpu.models.losses import losses as jax_losses

from tests.test_models.test_single_stage import tiny_ld_cfg, tiny_paa_cfg
from tests.test_torch_atss import _loss_pair, jax_setup
from tests.test_torch_backbones import check_simple_test, jit_o0
from tests.test_torch_cascade import _draw_stats, numpy_params_from
from tests.test_torch_fcos import (SIZES, H, W, T, _config, _gts, _rel,
                                   jax_readable_names)
from tests.test_torch_train import make_batch
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.engine import build_optimizer, make_train_step
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.builder import build_head
from swindet_tpu_torch.models.dense_heads.paa_head import (gmm_em_1d,
                                                           paa_keep)

cap_torch_threads()

TOL_HEAD_LOSS = 1e-6
TOL_HEAD_OUT = 1e-5
TOL_HEAD_GRAD = 1e-5
TOL_LOSS = 1e-4
TOL_GRAD = 1e-3
TOL_STEP = 1e-6

TINY = {'paa': tiny_paa_cfg, 'ld': tiny_ld_cfg}
CLS_CONV = {'paa': 'atss_cls', 'ld': 'gfl_cls'}
LOSSES = {'paa': {'loss_cls', 'loss_bbox', 'loss_iou'},
          'ld': {'loss_cls', 'loss_bbox', 'loss_dfl', 'loss_ld'}}


# -------------------------------------------------------------------- EM
EM_N = (4, 9, 23, 45)
EM_PAD = 13


def _em_losses(seed, n, kind):
    """n sorted candidate losses: two modes (a confident and a noisy one)
    or, the chaotic case of the JAX package's note, almost uniformly
    spaced."""
    rs = np.random.RandomState(seed)
    if kind == 'modes':
        lo = rs.gamma(2.0, 0.15, n // 2 + 1)
        hi = 1.5 + rs.gamma(2.0, 0.4, n - len(lo) + 1)
        x = np.concatenate([lo, hi])[:n]
    else:
        x = np.linspace(0.2, 2.0, n) + 1e-3 * rs.randn(n)
    return np.sort(x.astype(np.float32))


def _em_rows(seeds, ns=EM_N):
    """Each case dense (n valid of n + EM_PAD) and padded (EM_PAD zero
    slots after them, as the sorted candidates' invalid ones): rows (R,
    45 + EM_PAD) and their validity."""
    m = max(ns) + EM_PAD
    rows, valid = [], []
    for seed in seeds:
        for n in ns:
            for kind in ('modes', 'uniform'):
                x = np.zeros(m, np.float32)
                x[:n] = _em_losses(seed, n, kind)
                v = np.arange(m) < n
                rows.append(x)
                valid.append(v)
    return np.stack(rows), np.stack(valid)


def _check_em_rows(rows, valid, got):
    resp0, loglik = (t.numpy() for t in got[:2])
    for x, v, r, ll in zip(rows, valid, resp0, loglik):
        want_r, want_ll = _np_em_single(x, v)
        assert np.array_equal(r, want_r)
        np.testing.assert_array_max_ulp(ll[v], want_ll[v], maxulp=1)


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('n', EM_N)
def test_em_matches_numpy_fit(seed, n):
    """The two-mode and the near-uniform case of n losses, each in a row of
    n and in one padded with EM_PAD invalid zeros: resp0 equal to
    _np_em_single's on every slot, loglik within one float32 ulp."""
    for kind in ('modes', 'uniform'):
        x = _em_losses(seed, n, kind)
        padded = np.concatenate([x, np.zeros(EM_PAD, np.float32)])
        for row, v in ((x, np.ones(n, bool)),
                       (padded, np.arange(n + EM_PAD) < n)):
            _check_em_rows(row[None], v[None],
                           gmm_em_1d(T(row[None]), T(v[None])))


@pytest.mark.parametrize('check_every', [1, 8, 100])
def test_em_batched_rows_stop_apart(check_every):
    """All the cases of the test above, seeds 0-7, in one call: every row
    equal to its own numpy fit though rows converge at different
    iterations; the result bit-equal whether the loop reads its done flags
    every iteration, every 8th or never; at most one read in 8
    iterations."""
    rows, valid = _em_rows(range(8))
    got = gmm_em_1d(T(rows), T(valid), check_every=check_every)
    _check_em_rows(rows, valid, got)
    every = gmm_em_1d(T(rows), T(valid), check_every=1)
    assert torch.equal(got[0], every[0]) and torch.equal(got[1], every[1])
    assert got[2] <= 100 // check_every
    assert every[2] >= 4


def _sklearn_fit(x):
    mixture = pytest.importorskip('sklearn.mixture')
    gmm = mixture.GaussianMixture(
        2, weights_init=np.array([0.5, 0.5]),
        means_init=np.array([x.min(), x.max()]).reshape(2, 1),
        precisions_init=np.ones((2, 1)), covariance_type='diag')
    gmm.fit(x.reshape(-1, 1).astype(np.float64))
    return (gmm.predict(x.reshape(-1, 1)) == 0,
            gmm.score_samples(x.reshape(-1, 1)))


@pytest.mark.parametrize('n', EM_N)
def test_em_matches_sklearn(n):
    """The reference's fit (sklearn's GaussianMixture(2, 'diag'), means at
    the min and max, weights 1/2, precisions 1) on the two-mode losses of
    seeds 0-3, padded: the assignments equal, the log-likelihoods of the
    component-0 samples (those the selection reads) within 1e-5. sklearn's
    variance is E[x^2] - 2 mu E[x] + mu^2, and a component collapsed on a
    sample or two sits at the reg_covar floor, where that cancellation
    moves its density by up to 1e-2."""
    for seed in range(4):
        x = _em_losses(seed, n, 'modes')
        want_r, want_ll = _sklearn_fit(x)
        padded = np.concatenate([x, np.zeros(EM_PAD, np.float32)])
        v = np.arange(n + EM_PAD) < n
        r, ll, _ = gmm_em_1d(T(padded[None]), T(v[None]))
        assert np.array_equal(r[0, :n].numpy(), want_r)
        np.testing.assert_allclose(ll[0, :n].numpy()[want_r],
                                   want_ll[want_r], rtol=1e-5, atol=1e-5)


def test_keep_is_an_or_over_the_slots():
    """Two gts' sorted candidate slots over 12 anchors: gt 0 selects
    anchors 3 and 5; gt 1's invalid slots point at them after that (their
    selection False). The keep mask equals the JAX package's
    ``.at[ci].max``; a plain index assignment lets the later False slots
    clear both."""
    ci = np.array([[[3, 5, 7, 8], [9, 10, 5, 3]]])
    sel = np.array([[[True, True, False, False],
                     [True, False, False, False]]])
    want = np.asarray(jnp.zeros((12,), bool).at[ci.reshape(-1)].max(
        sel.reshape(-1), mode='drop'))
    got = paa_keep(T(ci), T(sel), 12)
    assert np.array_equal(got[0].numpy(), want)
    assert want[[3, 5, 9]].all() and want.sum() == 3
    plain = torch.zeros(12, dtype=torch.bool)
    plain[T(ci).reshape(-1)] = T(sel).reshape(-1)
    assert not plain[3] and not plain[5]


# ------------------------------------------------------------- the KD loss
@pytest.mark.parametrize('temperature', [10.0, 1.0])
def test_kd_kl_div_loss_matches_jax(temperature):
    """17 bins a side, soft labels of which some softmax to exactly 0 (q =
    0 entries, 0 log 0 = 0), a per-row weight: rel 1e-6, gradient 1e-5."""
    rs = np.random.RandomState(6)
    pred = (3 * rs.randn(64, 17)).astype(np.float32)
    soft = (3 * rs.randn(64, 17)).astype(np.float32)
    soft[:8, :5] = -1e5
    weight = rs.rand(64).astype(np.float32)
    got, want, g, gw = _loss_pair(
        'KnowledgeDistillationKLDivLoss',
        dict(loss_weight=0.25, T=temperature), pred, soft, weight)
    assert abs(got - want) <= TOL_HEAD_LOSS * abs(want)
    assert _rel(g, gw) <= TOL_HEAD_GRAD


# ----------------------------------------------------------------- heads
def _head_cfg(name):
    det = TINY[name]()
    head = det['bbox_head']
    return dict(head, train_cfg=det['train_cfg'], test_cfg=det['test_cfg'])


@functools.lru_cache(maxsize=None)
def head_case(name):
    """The JAX and the port's head of a tiny config on the same weights
    (the class output's with std 1, the scales 1 + N(0, 0.1^2)), five
    levels of features, LD's soft targets (N(0, 3^2) bin logits), and
    every JAX reference from one compiled function: the outputs, the
    losses and their gradients with respect to the outputs (LD's with and
    without soft targets), PAA's positives after the EM, and PAA's
    get_bboxes with NMS (score voting on and off) and without."""
    cfg = _head_cfg(name)
    jm = jax_build_head(dict(cfg))
    jm_plain = jax_build_head(dict(cfg, score_voting=False)) \
        if name == 'paa' else None
    rs = np.random.RandomState(1)
    feats = [rs.randn(2, h, w, 16).astype(np.float32) for h, w in SIZES]
    shapes = jax.eval_shape(lambda k: jm.init(k, feats),
                            jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 2)
    cls = params[CLS_CONV[name]]
    cls['kernel'] = rs.randn(*cls['kernel'].shape).astype(np.float32)
    params['scales'] = (1 + 0.1 * rs.randn(5)).astype(np.float32)
    port = build_head(dict(cfg))
    port.load_state_dict({k[len('bbox_head.'):]: v for k, v in
                          state_dict_from_jax({'_bbox_head': params})
                          .items()}, strict=True)
    soft = [3 * rs.randn(2, h, w, 4 * 9).astype(np.float32)
            for h, w in SIZES]
    gts, valid, labels = _gts()
    img_shapes = np.array([[H, W]] * 2, np.int32)
    test_shapes = np.array([[H, W], [H - 16, W - 32]], np.int32)
    sf = np.array([[1.0] * 4, [0.75] * 4], np.float32)
    final_labels = []

    def record(target, weight=None, reduction_override=None):
        # the focal loss's last call takes PAA's final labels
        if reduction_override is None and weight is not None:
            jax.debug.callback(lambda t: final_labels.append(np.asarray(t)),
                               target)

    def references(p):
        def apply(*a, module=jm, **kw):
            return module.apply({'params': p}, *a, **kw)
        outs = apply(feats)

        def loss(o, soft_targets=None):
            kw = {} if soft_targets is None else dict(
                soft_targets=soft_targets)
            parts = apply(jax.random.PRNGKey(0), *o, gts, valid, labels,
                          img_shapes, img_shapes, method='loss', **kw)
            return sum(parts.values()), parts
        out = dict(outs=outs)
        (_, out['losses']), out['grads'] = jax.value_and_grad(
            loss, has_aux=True)(outs, *([soft] if name == 'ld' else []))
        if name == 'ld':
            out['gfl_losses'] = loss(outs)[1]
            return out
        out['nms'] = apply(*outs, test_shapes, sf, method='get_bboxes')
        out['nms_plain'] = apply(*outs, test_shapes, sf, module=jm_plain,
                                 method='get_bboxes')
        out['candidates'] = apply(*outs, test_shapes, sf, with_nms=False,
                                  method='get_bboxes')
        return out
    focal = jax_losses.FocalLoss.__call__

    def recording(self, pred, target, weight=None, avg_factor=None,
                  reduction_override=None, **kw):
        record(target, weight, reduction_override)
        return focal(self, pred, target, weight, avg_factor,
                     reduction_override, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_losses.FocalLoss, '__call__', recording)
        ref = jax.tree.map(np.asarray, jit_o0(references)(params))
    if name == 'paa':
        assert len(final_labels) == 1
        ref['final_labels'] = final_labels[0].reshape(2, -1)
    return dict(name=name, port=port, feats=feats, ref=ref, soft=soft,
                gts=(gts, valid, labels), img_shapes=img_shapes,
                test_shapes=test_shapes, sf=sf)


@pytest.fixture(scope='module', params=list(TINY))
def head(request):
    return head_case(request.param)


@pytest.fixture(scope='module')
def paa_head():
    return head_case('paa')


def _head_args(head):
    return [T(a) for a in head['gts']] + [T(head['img_shapes'])] * 2


def test_head_forward_matches_jax(head):
    got = head['port']([T(f) for f in head['feats']])
    want = head['ref']['outs']
    assert len(got) == len(want) == (3 if head['name'] == 'paa' else 2)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert g.shape == w.shape and _rel(g, w) <= TOL_HEAD_OUT


def test_head_loss_matches_jax(head):
    """Each loss at rel 1e-6 (LD's loss_ld among them), the gradients of
    their sum with respect to the head's outputs at 1e-5 of the largest
    entry; LD without soft targets gives GFL's three losses."""
    outs = head['ref']['outs']
    ts = [[T(a).requires_grad_() for a in lvl] for lvl in outs]
    kw = {} if head['name'] == 'paa' else dict(
        soft_targets=[T(s) for s in head['soft']])
    got = head['port'].loss(*ts, *_head_args(head), **kw)
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
    if head['name'] == 'ld':
        with torch.no_grad():
            plain = head['port'].loss(*[[T(a) for a in lvl] for lvl in outs],
                                      *_head_args(head))
        want = head['ref']['gfl_losses']
        assert set(plain) == set(want) == LOSSES['ld'] - {'loss_ld'}
        for k, v in plain.items():
            assert abs(float(v) - float(want[k])) <= TOL_HEAD_LOSS * float(
                want[k])


def test_paa_positives_match_jax(paa_head):
    """PAA's labels after the EM equal the JAX head's (the focal loss's
    targets), on candidate losses with no tie; the EM drops some of the
    candidates of every image and keeps some."""
    head = paa_head
    port = head['port']
    outs = [[T(a) for a in lvl] for lvl in head['ref']['outs']]
    b, c = 2, port.cls_out_channels
    cls_flat = torch.cat([s.reshape(b, -1, c) for s in outs[0]], 1)
    box_flat = torch.cat([p.reshape(b, -1, 4) for p in outs[1]], 1)
    with torch.no_grad():
        labels, _, pos, _, _, reads = port.paa_targets(
            SIZES, cls_flat, box_flat, *_head_args(head))
        # every candidate in component 0, the likelihood peak at the last
        candidates = port.paa_targets(
            SIZES, cls_flat, box_flat, *_head_args(head),
            em=lambda x, v: (torch.ones_like(v), torch.arange(
                x.shape[-1], dtype=torch.float32).expand(x.shape), 0))[2]
    want = head['ref']['final_labels']
    assert np.array_equal(labels.numpy(), want)
    assert np.array_equal(pos.numpy(), want < port.num_classes)
    kept, before = pos.sum(1), candidates.sum(1)
    assert (kept > 0).all() and (kept < before).all(), (kept, before)
    assert reads >= 1


@pytest.mark.parametrize('case', ['voting', 'no_voting', 'no_nms'])
def test_paa_get_bboxes_matches_jax(paa_head, case):
    """sqrt(class score x IoU) candidates (nms_pre a level), decoded,
    clipped and rescaled; then the multiclass NMS, with score voting (the
    config's) or without."""
    head = paa_head
    port = head['port']
    outs = [[T(a) for a in lvl] for lvl in head['ref']['outs']]
    args = (T(head['test_shapes']), T(head['sf']))
    voting = port.score_voting
    try:
        port.score_voting = case == 'voting'
        with torch.no_grad():
            got = port.get_bboxes(*outs, *args, with_nms=case != 'no_nms')
    finally:
        port.score_voting = voting
    if case == 'no_nms':
        want = head['ref']['candidates']
        assert len(got) == len(want) == 2
        assert got[1].shape == want[1].shape == (2, 100 + 96 + 24 + 6 + 2, 5)
        for g, w, tol in zip(got, want, (1e-3, 1e-6)):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)
        return
    want = head['ref']['nms' if case == 'voting' else 'nms_plain']
    v = want.valid
    assert np.array_equal(got.valid.numpy(), v) and v.sum(1).min() >= 4
    assert np.array_equal(got.labels.numpy()[v], want.labels[v])
    np.testing.assert_allclose(got.dets.numpy()[v][:, :4],
                               want.dets[v][:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.dets.numpy()[v][:, 4], want.dets[v][:, 4],
                               rtol=0, atol=1e-4)
    if case == 'voting':
        moved = np.abs(want.dets[v][:, :4]
                       - head['ref']['nms_plain'].dets[v][:, :4]).max()
        assert moved > 1e-2


# ------------------------------------------------------------ detectors
@functools.lru_cache(maxsize=None)
def detector_case(name):
    """A tiny config's JAX detector, numpy params (the class outputs drawn
    with std 1, the scales 1 + N(0, 0.1^2); LD's teacher's too) and batch
    statistics, and the port's detector on them (eval mode)."""
    cfg = TINY[name]()
    jm = jax_build_detector(copy.deepcopy(cfg))
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 0)
    rs = np.random.RandomState(100)
    heads = [params['_bbox_head']]
    if name == 'ld':
        heads.append(params['_teacher']['_bbox_head'])
    for head in heads:
        cls = head[CLS_CONV[name]]
        cls['kernel'] = rs.randn(*cls['kernel'].shape).astype(np.float32)
        head['scales'] = (1 + 0.1 * rs.randn(*head['scales'].shape)).astype(
            np.float32)
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
    """simple_test (LD: the student alone): check_simple_test's limits."""
    check_simple_test(detector)


def test_detector_weights_round_trip_bit_exact(detector):
    """state_dict_from_jax, then the JAX converter (its names for the
    teacher, ``teacher.``): the parameters and batch statistics back bit
    for bit, no key missing or left over; LD's teacher under mmdet's
    ``teacher_model.``, its GFL integral buffer among them."""
    sd = detector['sd']
    readable = {k.replace('teacher_model.', 'teacher.', 1): v
                for k, v in jax_readable_names(sd, detector['params'])
                .items()}
    new_params, new_stats, report = convert_torch_state_dict(
        readable, detector['params'], batch_stats=detector['stats'],
        flatten_hints=default_flatten_hints(detector['cfg']))
    assert not report['missing'] and not report['unexpected'], report
    for a, b in ((new_params, detector['params']),
                 (new_stats, detector['stats'])):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb)
        assert all(np.array_equal(np.asarray(u), v) for u, v in zip(la, lb))
    if detector['name'] == 'ld':
        assert {'teacher_model.bbox_head.integral.project',
                'teacher_model.backbone.layer1.0.bn1.running_mean',
                'teacher_model.bbox_head.gfl_reg.weight'} <= set(sd)


TRAIN_NAMES = ['img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
               'gt_labels']


def _jax_losses_and_grads(case, params=None):
    """The JAX detector's forward_train losses and gradients on
    make_batch() at ``params`` (the case's own by default, computed once)."""
    if params is None and 'train_ref' in case:
        return case['train_ref']
    if 'train_fn' not in case:
        batch = make_batch()
        args = [jnp.asarray(batch[k]) for k in TRAIN_NAMES]

        def total(p):
            losses = case['jm'].apply(
                {'params': p, 'batch_stats': case['stats']}, *args,
                method='forward_train',
                rngs={'sampling': jax.random.PRNGKey(1)})
            return jax_parse_losses(losses)
        case['train_fn'] = jit_o0(jax.value_and_grad(total, has_aux=True))
    (_, want), grads = case['train_fn'](
        case['params'] if params is None else params)
    out = ({k: float(v) for k, v in want.items()},
           jax.tree.map(np.asarray, grads))
    if params is None:
        case['train_ref'] = out
    return out


def test_detector_forward_train_matches_jax(detector):
    """forward_train on both sides with the same batch: the losses at rel
    1e-4 (LD's loss_ld among them), every student gradient at 1e-3 of its
    largest entry; the BN buffers unmoved; LD's teacher takes no gradient
    (zero in the JAX package, none in the port)."""
    batch = make_batch()
    want, grads = _jax_losses_and_grads(detector)
    want_grads = state_dict_from_jax(grads)
    port = build_detector(copy.deepcopy(detector['cfg']))
    port.load_state_dict(detector['sd'], strict=True)
    port.train()
    losses = port.forward_train(*[T(batch[k]) for k in TRAIN_NAMES])
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
        if name.startswith('teacher_model.'):
            assert p.grad is None and not p.requires_grad and \
                not w.abs().max(), name
            continue
        assert p.grad is not None, name
        if not w.abs().max():
            # a level's scale with no positive anchor on it
            assert not p.grad.abs().max(), name
            continue
        assert _rel(p.grad, w) <= TOL_GRAD, (name, _rel(p.grad, w))
        checked += 1
    assert checked > 30


def test_ld_two_sgd_steps_match_jax():
    """Two make_train_step steps of LD with its config's SGD (lr 0.01,
    momentum 0.9, weight decay 1e-4, the teacher's custom key) at a
    constant lr: the teacher's parameters and buffers bit-equal to the
    start (the JAX package's teacher moves by its weight decay alone: its
    '_teacher' key matches no name there), the student's within the step
    limit of the JAX package's optax chain on its own gradients."""
    case = detector_case('ld')
    opt_cfg = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4,
                   paramwise_cfg=dict(custom_keys={
                       '_teacher': dict(lr_mult=0.0, decay_mult=0.0)}))
    lr = opt_cfg['lr']
    batch = make_batch()
    port = build_detector(copy.deepcopy(case['cfg']))
    port.load_state_dict(case['sd'], strict=True)
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    opt = build_optimizer(port, opt_cfg)
    assert not any(n.startswith('teacher_model.') for g in opt.param_groups
                   for n in g['names'])
    step = make_train_step(port, opt, lambda it: lr)
    tb = {k: T(batch[k]) for k in TRAIN_NAMES}
    for _ in range(2):
        log = step(tb, torch.Generator().manual_seed(0))
        assert np.isfinite(log['loss']) and log['grad_norm'] > 0
        assert not port.teacher_model.training
    params = case['params']
    tx = jax_build_opt(params, dict(opt_cfg), lambda s: lr)

    @jax.jit
    def apply(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state
    state, gmax = tx.init(params), {}
    for i in range(2):
        _, grads = _jax_losses_and_grads(case, None if i == 0 else params)
        for k, g in state_dict_from_jax(grads).items():
            gmax[k] = max(gmax.get(k, 0.0), float(g.abs().max()))
        params, state = apply(grads, state, params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, params))
    for k, v in port.state_dict().items():
        if k.startswith('teacher_model.'):
            assert torch.equal(v, before[k]), k
            if k in want and v.is_floating_point():
                # the JAX optimizer matches its custom keys against mmdet
                # names (teacher.*), which '_teacher' is not in: its
                # teacher takes the weight decay, nothing else (lr wd w,
                # then lr wd (1.9 w) with the momentum, each step rounded)
                top = np.abs(before[k].numpy()).max()
                decay = np.abs(want[k].numpy() - before[k].numpy()).max()
                assert decay <= 2.9 * lr * 1e-4 * top + 2 * np.spacing(top), k
    moved = 0
    for name, p in port.named_parameters():
        if name.startswith('teacher_model.'):
            continue
        got, w = p.detach().numpy(), want[name].numpy()
        limit = 3 * lr * TOL_GRAD * gmax[name] + TOL_STEP * np.abs(w).max()
        assert np.abs(got - w).max() <= limit, name
        moved += not torch.equal(p.detach(), before[name])
    assert moved > 30


# ------------------------------------------------------- the config sweep
SWEEP = sorted(sum((glob.glob(f'configs/{d}/*.py') for d in ('paa', 'ld')),
                   []))


def test_sweep_lists_the_slice_configs():
    assert len(SWEEP) == 7 + 4


@pytest.mark.parametrize('path', SWEEP)
def test_config_builds_where_jax_builds(path):
    """Each config's detector builds with the port's build_detector on the
    meta device, and in the JAX package (jax_setup); LD's teacher from its
    config file, read from the working directory."""
    cfg = _config(path)
    jax_setup(copy.deepcopy(cfg))
    with torch.device('meta'):
        model = build_detector(cfg)
    assert type(model).__name__ == cfg['type']
    if cfg['type'] == 'KnowledgeDistillationSingleStageDetector':
        assert type(model.teacher_model).__name__ == 'GFL'
        assert not any(p.requires_grad
                       for p in model.teacher_model.parameters())
