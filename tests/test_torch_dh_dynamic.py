"""Double-Head R-CNN and Dynamic R-CNN in the port against the JAX package
on the CPU, fp32, on the same numpy weights, batch statistics, inputs and
sampler keys:

- ``DoubleConvFCBBoxHead``: in training (BN on the batch's statistics)
  its outputs, every gradient and the running statistics it leaves; in
  eval mode its outputs on drawn running statistics;
- the per-call arguments: ``MaxIoUAssigner.assign``'s thresholds and
  ``SmoothL1Loss``'s beta as 0-d tensors; Dynamic R-CNN's median, which
  averages the two middle values of an even history as ``jnp.median``
  does where ``torch.median`` takes the lower;
- a tiny Double-Head Faster R-CNN (the JAX tests' Swin detector at 32
  channels, the configs' head: 4 bottlenecks, 2 fcs, rois enlarged by
  1.3; its RCNN sampler of 128 slots, more than the candidates, so the
  BNs' batch statistics take filler slots too): ``simple_test``,
  ``forward_train``'s losses and every gradient, the weights' round trip
  through the JAX converter under the names it reads, and a strict load;
- a tiny Dynamic R-CNN at ``update_iter_interval=4``: eight
  ``forward_train`` steps on eight batches, each step's losses (and
  ``dynamic_iou_thr`` / ``dynamic_beta``) and the five dynamic values
  after it against the JAX package's ``dynamic`` collection (two updates,
  histories of four distinct values), every gradient at the first step
  and at the sixth (after the first update, its threshold and beta
  moved); ``simple_test``; ``make_train_step`` advancing the values once a
  step, and the values kept out of the ``state_dict``;
- the 3 files of configs/dynamic_rcnn and configs/double_heads build in
  both packages.

Tolerances: module outputs and running statistics at 1e-5 of their
largest entry, module gradients at 1e-4; losses at rel 1e-4; detections
with labels equal, boxes within 1e-3 px, scores within 1e-4; detector
gradients at 1e-3 of each tensor's largest entry (or twice the JAX
package's own move under 1e-7 noise where that is more,
``check_forward_train``); the dynamic values within 1e-6.
"""
import copy
import functools
import glob
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.checkpoint import (convert_torch_state_dict,
                                    default_flatten_hints)
from swindet_tpu.core.bbox import samplers as jax_samplers
from swindet_tpu.core.bbox.assigners import \
    MaxIoUAssigner as JaxMaxIoUAssigner
from swindet_tpu.core.bbox.samplers import RandomSampler as JaxSampler
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.models.builder import build_head as jax_build_head
from swindet_tpu.models.losses.losses import SmoothL1Loss as JaxSmoothL1

from tests.test_models.test_forward import tiny_maskrcnn_cfg
from tests.test_torch_atss import jax_setup
from tests.test_torch_backbones import (_ClampedTake, check_forward_train,
                                        detector_case)
from tests.test_torch_cascade import _draw_stats, numpy_params_from
from tests.test_torch_checkpoint import numpy_params
from tests.test_torch_fcos import _config
from tests.test_torch_ms_rcnn import (_fast_references,  # noqa: F401
                                      check_simple_test_exact, jit_fast)
from tests.test_torch_train import make_batch, sampler_keys
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.checkpoint import (load_checkpoint, save_checkpoint,
                                          state_dict_from_jax)
from swindet_tpu_torch.core.bbox.assigners import MaxIoUAssigner
from swindet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                      make_train_step)
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.builder import build_head
from swindet_tpu_torch.models.losses import SmoothL1Loss
from swindet_tpu_torch.models.roi_heads.dynamic_roi_head import median

cap_torch_threads()

TOL_MODULE = 1e-5
TOL_MODULE_GRAD = 1e-4
TOL_LOSS = 1e-4
TOL_GRAD = 1e-3
TOL_DYNAMIC = 1e-6


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------- bbox head
DH_HEAD = dict(type='DoubleConvFCBBoxHead', num_convs=2, num_fcs=2,
               in_channels=16, conv_out_channels=32, fc_out_channels=32,
               roi_feat_size=7, num_classes=4)
HEAD_PREFIX = 'roi_head.bbox_head.'


def _head_sd(params, stats=None):
    sd = state_dict_from_jax({'_roi_head': {'_bbox_head': params}},
                             None if stats is None
                             else {'_roi_head': {'_bbox_head': stats}})
    return {k[len(HEAD_PREFIX):]: v for k, v in sd.items()}


@pytest.fixture(scope='module')
def dh_head():
    rs = np.random.RandomState(0)
    x_cls = rs.randn(12, 7, 7, 16).astype(np.float32)
    x_reg = rs.randn(12, 7, 7, 16).astype(np.float32)
    jm = jax_build_head(dict(DH_HEAD))
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x_cls),
                                              jnp.asarray(x_reg)),
                            jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 1)
    stats = _draw_stats(shapes['batch_stats'], 2)
    return dict(jm=jm, params=params, stats=stats, x_cls=x_cls, x_reg=x_reg)


def test_double_head_names_follow_mmdet(dh_head):
    sd = _head_sd(dh_head['params'], dh_head['stats'])
    for key in ('res_block.conv1.conv.weight', 'res_block.conv1.bn.weight',
                'res_block.conv2.bn.running_var',
                'res_block.conv_identity.conv.weight',
                'conv_branch.1.conv1.weight', 'conv_branch.1.bn2.bias',
                'conv_branch.0.bn3.running_mean',
                'conv_branch.0.bn3.num_batches_tracked',
                'fc_branch.0.weight', 'fc_branch.1.bias', 'fc_cls.weight',
                'fc_reg.weight'):
        assert key in sd, key
    port = build_head(dict(DH_HEAD))
    port.load_state_dict(sd, strict=True)
    assert tuple(port.fc_reg.weight.shape) == (16, 32)
    assert tuple(port.fc_branch[0].weight.shape) == (32, 16 * 49)


def test_double_head_training_matches_jax(dh_head):
    """Training mode: outputs on the batch's statistics, every parameter's
    and both inputs' gradients, and the running statistics updated as
    flax's BatchNorm updates them (momentum 0.1 on the biased
    variance)."""
    jm, params, stats = dh_head['jm'], dh_head['params'], dh_head['stats']
    xc, xr = jnp.asarray(dh_head['x_cls']), jnp.asarray(dh_head['x_reg'])
    rs = np.random.RandomState(3)
    gc, gr = rs.randn(12, 5).astype(np.float32), \
        rs.randn(12, 16).astype(np.float32)

    def run(p, xc, xr):
        def fwd(p, xc, xr):
            return jm.apply({'params': p, 'batch_stats': stats}, xc, xr,
                            train=True, mutable=['batch_stats'])
        (cls, reg), vjp, new = jax.vjp(fwd, p, xc, xr, has_aux=True)
        return cls, reg, new, vjp((jnp.asarray(gc), jnp.asarray(gr)))
    cls, reg, new, (gp, gxc, gxr) = jit_fast(run)(params, xc, xr)
    port = build_head(dict(DH_HEAD))
    port.load_state_dict(_head_sd(params, stats), strict=True)
    port.train()
    txc = T(dh_head['x_cls']).requires_grad_(True)
    txr = T(dh_head['x_reg']).requires_grad_(True)
    got_cls, got_reg = port(txc, txr)
    assert _rel(got_cls, cls) <= TOL_MODULE and _rel(got_reg, reg) \
        <= TOL_MODULE
    ((got_cls * T(gc)).sum() + (got_reg * T(gr)).sum()).backward()
    assert _rel(txc.grad, gxc) <= TOL_MODULE_GRAD
    assert _rel(txr.grad, gxr) <= TOL_MODULE_GRAD
    want_grads = _head_sd(jax.tree.map(np.asarray, gp))
    for name, p in port.named_parameters():
        assert _rel(p.grad, want_grads[name]) <= TOL_MODULE_GRAD, name
    want_stats = _head_sd({}, jax.tree.map(np.asarray,
                                           new['batch_stats']))
    moved = 0
    for name, buf in port.state_dict().items():
        if name.endswith(('running_mean', 'running_var')):
            assert _rel(buf, want_stats[name]) <= TOL_MODULE, name
            moved += 1
    assert moved == 2 * (3 + 3 * 2)


def test_double_head_eval_matches_jax(dh_head):
    """Eval mode: the running statistics, x_reg defaulting to x_cls."""
    jm, params, stats = dh_head['jm'], dh_head['params'], dh_head['stats']
    cls, reg = jax.jit(lambda p, x: jm.apply(
        {'params': p, 'batch_stats': stats}, x))(
        params, jnp.asarray(dh_head['x_cls']))
    port = build_head(dict(DH_HEAD))
    port.load_state_dict(_head_sd(params, stats), strict=True)
    with torch.no_grad():
        got_cls, got_reg = port.eval()(T(dh_head['x_cls']))
    assert _rel(got_cls, cls) <= TOL_MODULE and _rel(got_reg, reg) \
        <= TOL_MODULE


# ------------------------------------------------------ per-call options
def test_assigner_thresholds_per_call_match_jax():
    rs = np.random.RandomState(4)
    xy = rs.uniform(0, 60, (50, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(4, 30, (50, 2))], 1) \
        .astype(np.float32)
    gts = np.concatenate([boxes[[3, 17, 30]] + rs.uniform(-3, 3, (3, 4)),
                          np.zeros((1, 4))]).astype(np.float32)
    gv = np.array([True, True, True, False])
    labels = np.array([1, 0, 2, 0], np.int32)
    bv = rs.rand(50) > 0.1
    cfg = dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
               match_low_quality=False)
    for thr in (0.4, 0.63):
        kw = dict(pos_iou_thr=thr, neg_iou_thr=thr, min_pos_iou=thr)
        want = JaxMaxIoUAssigner(**cfg).assign(
            jnp.asarray(boxes), jnp.asarray(gts), jnp.asarray(gv),
            jnp.asarray(labels), bbox_valid=jnp.asarray(bv),
            **{k: jnp.float32(v) for k, v in kw.items()})
        got = MaxIoUAssigner(**cfg).assign(
            T(boxes), T(gts), T(gv), T(labels), bbox_valid=T(bv),
            **{k: torch.tensor(v) for k, v in kw.items()})
        assert np.array_equal(got.gt_inds.numpy(), np.asarray(want.gt_inds))
        assert np.array_equal(got.labels.numpy(), np.asarray(want.labels))
    default = MaxIoUAssigner(**cfg).assign(T(boxes), T(gts), T(gv), T(labels),
                                           bbox_valid=T(bv))
    same = MaxIoUAssigner(**cfg).assign(
        T(boxes), T(gts), T(gv), T(labels), bbox_valid=T(bv),
        pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5)
    assert torch.equal(default.gt_inds, same.gt_inds)


def test_smooth_l1_beta_per_call_matches_jax():
    rs = np.random.RandomState(5)
    pred, target = rs.randn(2, 30, 4).astype(np.float32)
    weight = (rs.rand(30, 4) > 0.4).astype(np.float32)
    for beta in (1.0, 0.137):
        want = JaxSmoothL1(beta=1.0)(jnp.asarray(pred), jnp.asarray(target),
                                     weight=jnp.asarray(weight),
                                     avg_factor=11.0,
                                     beta=jnp.float32(beta))
        got = SmoothL1Loss(beta=1.0)(T(pred), T(target), weight=T(weight),
                                     avg_factor=11.0,
                                     beta=torch.tensor(beta))
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert float(SmoothL1Loss(beta=0.5)(T(pred), T(target))) == float(
        SmoothL1Loss(beta=1.0)(T(pred), T(target), beta=0.5))


@pytest.mark.parametrize('n', [4, 5, 100])
def test_median_is_jnp_median(n):
    """Dynamic R-CNN's beta update: the average of the two middle values
    for an even count (``jnp.median``), not torch.median's lower one."""
    x = np.random.RandomState(n).rand(n).astype(np.float32)
    want = float(jnp.median(jnp.asarray(x)))
    assert float(median(T(x))) == want
    if n % 2 == 0:
        assert float(torch.median(T(x))) != want


# -------------------------------------------------------- tiny detectors
def dh_cfg():
    """The JAX tests' Double-Head detector (test_forward.py:255) with the
    config's head (4 bottlenecks, 2 fcs) at 32 channels; the RCNN sampler
    holds 128 slots a picture for 3 gts and 64 proposals, so the BNs'
    training statistics take its filler slots on both sides (the JAX
    side's filler boxes clamped to the last candidate, as
    check_forward_train takes them; unclamped the JAX RoIAlign pools
    their NaN boxes to zeros)."""
    cfg = tiny_maskrcnn_cfg(with_mask=False)
    cfg['type'] = 'FasterRCNN'
    roi = cfg['roi_head']
    roi.pop('mask_head', None)
    roi.pop('mask_roi_extractor', None)
    roi.update(type='DoubleHeadRoIHead', reg_roi_scale_factor=1.3)
    roi['bbox_head'] = dict(
        roi['bbox_head'], type='DoubleConvFCBBoxHead', num_convs=4,
        num_fcs=2, conv_out_channels=32, fc_out_channels=32,
        loss_cls=dict(type='CrossEntropyLoss', use_sigmoid=False,
                      loss_weight=2.0),
        loss_bbox=dict(type='SmoothL1Loss', beta=1.0, loss_weight=2.0))
    cfg['train_cfg']['rcnn']['sampler']['num'] = 128
    return cfg


@functools.lru_cache(maxsize=None)
def _dh_case():
    return detector_case(dh_cfg())


def test_dh_simple_test_matches_jax():
    """Eval mode: the conv branch's BNs on their running statistics."""
    case = _dh_case()
    check_simple_test_exact(case['jm'], {'params': case['params'],
                                         'batch_stats': case['stats']},
                            case['port'])


def test_dh_forward_train_matches_jax():
    port = check_forward_train(_dh_case(), frozen=())
    g = port.roi_head.bbox_head.conv_branch[3].conv3.weight.grad
    assert float(g.abs().max()) > 0


def jax_readable_dh(sd):
    """The port's Double-Head names under those the JAX converter reads:
    its flax module names ``conv_branch{i}.conv{k}.conv`` / ``.bn`` and
    ``fc_branch{i}``, where mmdet's are ``conv_branch.{i}.conv{k}`` /
    ``bn{k}`` and ``fc_branch.{i}``."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r'\.conv_branch\.(\d+)\.conv(\d)\.',
                   r'.conv_branch\1.conv\2.conv.', k)
        k = re.sub(r'\.conv_branch\.(\d+)\.bn(\d)\.',
                   r'.conv_branch\1.conv\2.bn.', k)
        k = re.sub(r'\.fc_branch\.(\d+)\.', r'.fc_branch\1.', k)
        out[k] = v
    return out


def test_dh_weights_round_trip_and_load_strictly(tmp_path):
    """Through jax_readable_dh and with fc_branch0's flatten hint, which
    default_flatten_hints does not give, the JAX converter reads the
    port's weights and running statistics back bit for bit; a checkpoint
    of them loads strictly."""
    case = _dh_case()
    hints = dict(default_flatten_hints(case['cfg']))
    hints['_roi_head/_bbox_head/fc_branch0'] = (7, 7, 32)
    new_params, new_stats, report = convert_torch_state_dict(
        jax_readable_dh(case['sd']), case['params'],
        batch_stats=case['stats'], flatten_hints=hints)
    assert not report['missing'] and not report['unexpected'], report
    for a, b in ((new_params, case['params']), (new_stats, case['stats'])):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb)
        assert all(np.array_equal(np.asarray(u), v) for u, v in zip(la, lb))
    path = str(tmp_path / 'released.pth')
    save_checkpoint(path, case['port'])
    load_checkpoint(build_detector(copy.deepcopy(case['cfg'])), path)


# a low initial threshold and a high initial beta, so that the seeded
# RPN's proposals give the sampler positives beyond the gts (whose box
# targets are 0) and the median of the recorded betas sets beta
DYNAMIC = dict(iou_topk=3, beta_topk=4, update_iter_interval=4,
               initial_iou=0.2, initial_beta=4.0)
STEPS = 8
GRAD_STEPS = (0, 5)


def dynamic_cfg():
    """The JAX tests' Dynamic R-CNN (test_forward.py:288) at an update
    every 4 steps."""
    cfg = tiny_maskrcnn_cfg(with_mask=False)
    cfg['type'] = 'FasterRCNN'
    roi = cfg['roi_head']
    roi.pop('mask_head', None)
    roi.pop('mask_roi_extractor', None)
    roi['type'] = 'DynamicRoIHead'
    roi['bbox_head']['loss_bbox'] = dict(type='SmoothL1Loss', beta=1.0,
                                         loss_weight=1.0)
    cfg['train_cfg']['rcnn']['dynamic_rcnn'] = dict(DYNAMIC)
    return cfg


DYN_NAMES = ('iou_thr', 'beta', 'iou_hist', 'beta_hist', 'count')


@pytest.fixture(scope='module')
def dynamic_run():
    """STEPS forward_train steps on each side, batch i from seed i and its
    own sampler keys, the JAX run's proposals pinned on the port's side:
    per step the losses, the dynamic values after it, and at GRAD_STEPS
    the gradients."""
    cfg = dynamic_cfg()
    jm = jax_build_detector(copy.deepcopy(cfg))
    params = numpy_params(jm, 0, method='forward_dummy')
    rs = np.random.RandomState(100)
    for leaf in (params['_rpn_head']['rpn_cls'],
                 params['_roi_head']['_bbox_head']['fc_cls']):
        leaf['kernel'] = rs.randn(*leaf['kernel'].shape).astype(np.float32)
    dyn = jax.eval_shape(lambda k: jm.init(
        {'params': k}, jnp.zeros((1, 64, 64, 3)), method='forward_dummy'),
        jax.random.PRNGKey(0))['dynamic']
    dyn = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dyn)
    dyn['_roi_head']['iou_thr'] = np.float32(DYNAMIC['initial_iou'])
    dyn['_roi_head']['beta'] = np.float32(DYNAMIC['initial_beta'])
    sd = state_dict_from_jax(params)
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(sd, strict=True)
    port.train()
    names = ['img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
             'gt_labels']
    gen = cfg['rpn_head']['anchor_generator']
    with torch.no_grad():
        feats = port.extract_feat(T(make_batch()['img']))
    n_rpn = len(gen['scales']) * len(gen['ratios']) * sum(
        f.shape[1] * f.shape[2] for f in feats)
    n_rcnn = 3 + cfg['train_cfg']['rpn_proposal']['max_per_img']
    current = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxSampler, '_pos_keys',
               lambda self, rng, a, m, n: jnp.asarray(current['keys'][n][0]))
    mp.setattr(JaxSampler, '_neg_keys',
               lambda self, rng, a, m, n: jnp.asarray(current['keys'][n][1]))
    mp.setattr(jax_samplers, 'jnp', _ClampedTake())

    def total(p, dyn, args, keys):
        current['keys'] = keys
        losses, state = jm.apply(
            {'params': p, 'dynamic': dyn}, *args, method='forward_train',
            rngs={'sampling': jax.random.PRNGKey(1)},
            mutable=['dynamic', 'intermediates'],
            capture_intermediates=lambda mdl, name: name == 'get_proposals')
        loss, log_vars = jax_parse_losses(losses)
        props = state['intermediates']['_rpn_head']['get_proposals'][0]
        return loss, (log_vars, props, state['dynamic'])
    steps = []
    try:
        value_and_grad = jit_fast(jax.value_and_grad(total, has_aux=True))
        for i in range(STEPS):
            batch = make_batch(seed=i)
            del batch['gt_masks']
            keys = {n: tuple(jnp.asarray(k) for k in v) for n, v in
                    sampler_keys(n_rpn, n_rcnn, seed=10 + i).items()}
            (_, (want, props, dyn)), grads = value_and_grad(
                params, dyn, [jnp.asarray(batch[k]) for k in names], keys)
            dyn = jax.tree.map(np.asarray, dyn)
            pinned = tuple(T(np.asarray(a)) for a in props)
            port.rpn_head.get_proposals = lambda *a, _p=pinned, **kw: _p
            port.zero_grad(set_to_none=True)
            tb = {k: T(v) for k, v in batch.items()}
            tkeys = {part: [tuple(T(np.asarray(k)) for k in keys[n])] * 2
                     for part, n in (('rpn', n_rpn), ('rcnn', n_rcnn))}
            grad = i in GRAD_STEPS
            with torch.set_grad_enabled(grad):
                losses = port.forward_train(*[tb[k] for k in names],
                                            sampler_keys=tkeys)
                if grad:
                    sum(v for k, v in losses.items()
                        if 'loss' in k).backward()
            steps.append(dict(
                want={k: float(v) for k, v in want.items() if k != 'loss'},
                got={k: float(v.detach()) for k, v in losses.items()},
                want_dyn=dict(dyn['_roi_head']),
                got_dyn={n: getattr(port.roi_head, n).clone()
                         for n in DYN_NAMES},
                want_grads=state_dict_from_jax(jax.tree.map(
                    np.asarray, grads)) if grad else None,
                got_grads={n: None if p.grad is None else p.grad.clone()
                           for n, p in port.named_parameters()}
                if grad else None))
    finally:
        mp.undo()
    return dict(cfg=cfg, jm=jm, params=params, sd=sd, steps=steps)


def test_dynamic_losses_match_jax_each_step(dynamic_run):
    for i, step in enumerate(dynamic_run['steps']):
        want, got = step['want'], step['got']
        assert set(got) == set(want) == {
            'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox', 'acc',
            'dynamic_iou_thr', 'dynamic_beta'}
        for k, v in got.items():
            assert abs(v - want[k]) <= TOL_LOSS * max(abs(want[k]), 1e-6), \
                (i, k, v, want[k])


def test_dynamic_values_match_jax_each_step(dynamic_run):
    """iou_thr, beta, the two histories and count after every step; the
    values move at the two updates (steps 4 and 8) and only there, the
    histories hold four distinct values, and the beta update takes the
    average of the two middle ones."""
    prev = None
    for i, step in enumerate(dynamic_run['steps']):
        want, got = step['want_dyn'], step['got_dyn']
        assert int(got['count']) == int(want['count']) == i + 1
        for n in DYN_NAMES[:4]:
            assert np.abs(got[n].numpy() - np.asarray(want[n])).max() \
                <= TOL_DYNAMIC, (i, n, got[n], want[n])
        hist = got['beta_hist']
        if (i + 1) % DYNAMIC['update_iter_interval'] == 0:
            assert len(set(hist.tolist())) == 4
            assert len(set(got['iou_hist'].tolist())) == 4
            assert float(got['beta']) == float(median(hist)) \
                != float(torch.median(hist))
            assert float(got['iou_thr']) == max(
                DYNAMIC['initial_iou'], float(got['iou_hist'].mean()))
            assert prev is None or float(got['iou_thr']) != prev
            prev = float(got['iou_thr'])
        elif i:
            before = dynamic_run['steps'][i - 1]['got_dyn']
            assert torch.equal(got['iou_thr'], before['iou_thr'])
            assert torch.equal(got['beta'], before['beta'])
    assert float(dynamic_run['steps'][-1]['got_dyn']['iou_thr']) > 0.2


@pytest.mark.parametrize('step', GRAD_STEPS)
def test_dynamic_grads_match_jax(dynamic_run, step):
    run = dynamic_run['steps'][step]
    want, got = run['want_grads'], run['got_grads']
    checked = 0
    for name, g in got.items():
        w = want[name]
        assert g is not None, name
        if w.abs().max() > 0:
            assert _rel(g, w) <= TOL_GRAD, (name, _rel(g, w))
            checked += 1
    assert checked > 40


def test_dynamic_simple_test_matches_jax(dynamic_run):
    port = build_detector(copy.deepcopy(dynamic_run['cfg']))
    port.load_state_dict(dynamic_run['sd'], strict=True)
    check_simple_test_exact(dynamic_run['jm'], {
        'params': dynamic_run['params'],
        'dynamic': {'_roi_head': dict(dynamic_run['steps'][0]['want_dyn'])}},
        port)


def test_dynamic_values_advance_once_a_train_step(dynamic_run, tmp_path):
    """make_train_step moves the dynamic values once a step (an update at
    the fourth); they stay out of the state_dict, so weights without them
    (mmdet's) load strictly."""
    port = build_detector(copy.deepcopy(dynamic_run['cfg']))
    port.load_state_dict(dynamic_run['sd'], strict=True)
    assert not any(n.split('.')[-1] in DYN_NAMES for n in port.state_dict())
    opt = build_optimizer(port, dict(type='SGD', lr=0.01, momentum=0.9,
                                     weight_decay=1e-4))
    step = make_train_step(port, opt, build_lr_schedule(
        dict(policy='step', step=[8, 11]), 0.01, 10))
    batch = make_batch()
    del batch['gt_masks']
    batch = {k: T(v) for k, v in batch.items()}
    for i in range(4):
        log = step(batch, torch.Generator().manual_seed(i))
        assert int(port.roi_head.count) == i + 1
        assert {'dynamic_iou_thr', 'dynamic_beta'} <= set(log)
    assert float(port.roi_head.iou_thr) > 0.2
    assert log['dynamic_iou_thr'] == pytest.approx(
        float(port.roi_head.iou_thr))
    path = str(tmp_path / 'released.pth')
    save_checkpoint(path, port)
    fresh = build_detector(copy.deepcopy(dynamic_run['cfg']))
    load_checkpoint(fresh, path)
    assert int(fresh.roi_head.count) == 0


# ---------------------------------------------------------------- configs
SWEEP = sorted(glob.glob('configs/dynamic_rcnn/*.py')
               + glob.glob('configs/double_heads/*.py'))


def test_sweep_lists_the_slice_configs():
    assert len(SWEEP) == 2 + 1


@pytest.mark.parametrize('path', SWEEP)
def test_config_builds_where_jax_builds(path):
    cfg = _config(path)
    jax_setup(copy.deepcopy(cfg))
    with torch.device('meta'):
        model = build_detector(cfg)
    assert type(model).__name__ == cfg['type']
    assert type(model.roi_head).__name__ == (
        'DoubleHeadRoIHead' if 'double_heads' in path else 'DynamicRoIHead')
