"""The port's ResNet backbone and Faster R-CNN R-50 against the JAX package
on the CPU, fp32, on the same numpy weights, batch statistics and inputs:

- ``ResNet`` / ``ResNeXt`` (depths 18 and 50, pytorch and caffe style,
  groups 4, a dilated last stage, narrow widths, odd input sizes) with
  running statistics away from 0 and 1, their outputs, their gradients
  under ``frozen_stages=1`` (zero in the stem and ``layer1``) and their
  BN buffers, which a training forward leaves as they were;
- the weights through ``state_dict_from_jax`` and back through the JAX
  package's ``convert_torch_state_dict``, bit for bit;
- ``AnchorGenerator``'s octave scales and ``center_offset``, and
  ``PseudoSampler``;
- SGD: a 10-step trajectory on a toy parameter set (fp64) with and without
  Nesterov, and one ``make_train_step`` step of a tiny Faster R-CNN R-50
  (``frozen_stages=1``, weight decay) after which every parameter, the
  frozen stem and ``layer1`` included, equals the JAX package's;
- the tiny Faster R-CNN R-50 end to end: ``simple_test`` and
  ``forward_train`` with the same sampler keys on both sides.

Tolerances: module outputs at 1e-5 of their largest entry and module
gradients at 1e-4 of theirs; anchors and sampler fields exact; detections
with labels equal, boxes within 1e-3 px and scores within 1e-4; the
detector's losses at rel 1e-4 and its gradients at 1e-3 of each tensor's
largest entry (the test_torch_train.py limits); parameters after an SGD
step within lr times 1e-3 of their gradient's largest entry (the step
moves each by lr times a gradient whose error is within that limit) plus
1e-6 of their own; the toy trajectories at rel 1e-6
(test_torch_engine.py's).
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from swindet_tpu.checkpoint import convert_torch_state_dict
from swindet_tpu.core.anchors import AnchorGenerator as JaxAnchorGenerator
from swindet_tpu.core.bbox.assigners import MaxIoUAssigner as JaxMaxIoU
from swindet_tpu.core.bbox.samplers import PseudoSampler as JaxPseudoSampler
from swindet_tpu.core.bbox.samplers import RandomSampler as JaxSampler
from swindet_tpu.engine.optimizer import build_optimizer as jax_build_opt
from swindet_tpu.engine.schedules import build_lr_schedule as jax_schedule
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models.backbones.resnet import ResNet as JaxResNet
from swindet_tpu.models.backbones.resnet import ResNeXt as JaxResNeXt

from tests.test_models.test_forward import tiny_maskrcnn_cfg
from tests.test_torch_cascade import _draw_stats, numpy_params_from
from tests.test_torch_checkpoint import jax_detector_params
from tests.test_torch_engine import (CUSTOM_KEYS, LR_CONFIG, NAMES,
                                     _by_name, _flax_tree)
from tests.test_torch_train import make_batch, sampler_keys

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.core.anchors import AnchorGenerator
from swindet_tpu_torch.core.bbox import MaxIoUAssigner, PseudoSampler
from swindet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                      make_train_step)
from swindet_tpu_torch.engine.optimizer import set_lr
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.backbones.resnet import ResNet, ResNeXt
from swindet_tpu_torch.models.detectors import FasterRCNN

TOL_MODULE = 1e-5
TOL_MODULE_GRAD = 1e-4
TOL_LOSS = 1e-4
TOL_GRAD = 1e-3
TOL_STEP = 1e-6
H, W = 64, 96


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------- ResNet
RESNET_CASES = {
    'r18': dict(depth=18, base_channels=8),
    'r50-pytorch': dict(depth=50, base_channels=8, out_indices=(1, 2, 3)),
    'r50-caffe': dict(depth=50, base_channels=8, style='caffe',
                      num_stages=2, out_indices=(0, 1)),
    'r50-dilated': dict(depth=50, base_channels=8, num_stages=3,
                        strides=(1, 2, 1), dilations=(1, 1, 2),
                        out_indices=(1, 2)),
    'x50-g4': dict(depth=50, base_channels=16, groups=4, base_width=16,
                   num_stages=2, out_indices=(0, 1), next=True),
}


def _resnet(case, frozen_stages=-1, seed=0):
    """The JAX backbone with numpy params and running statistics, the
    port's on the same weights, and an odd-sized input."""
    kw = dict(RESNET_CASES[case], frozen_stages=frozen_stages)
    jax_cls, port_cls = (JaxResNeXt, ResNeXt) if kw.pop('next', False) \
        else (JaxResNet, ResNet)
    jm = jax_cls(**kw)
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 45, 61, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, x), jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], seed + 1)
    stats = _draw_stats(shapes['batch_stats'], seed + 2)
    port = port_cls(**kw)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return jm, params, stats, port, x


@pytest.mark.parametrize('case', list(RESNET_CASES))
def test_resnet_matches_jax(case):
    jm, params, stats, port, x = _resnet(case)
    want = jax.jit(jm.apply)({'params': params, 'batch_stats': stats}, x)
    got = port.eval()(T(x))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a, b) <= TOL_MODULE
    if case == 'x50-g4':
        assert port.layer1[0].conv2.groups == 4


@pytest.mark.parametrize('case', ['r18', 'r50-pytorch'])
def test_resnet_frozen_stage_gradients_match_jax(case):
    """frozen_stages=1 in training mode: the gradients of every parameter
    against the JAX package's, zero (no gradient) in the stem and layer1
    and not elsewhere; the running statistics stay as they were (no batch
    statistic is read)."""
    jm, params, stats, port, x = _resnet(case, frozen_stages=1)
    rs = np.random.RandomState(3)
    out_shapes = jax.eval_shape(lambda: jm.apply(
        {'params': params, 'batch_stats': stats}, x, train=True))
    gs = [rs.randn(*o.shape).astype(np.float32) for o in out_shapes]

    def total(p):
        outs = jm.apply({'params': p, 'batch_stats': stats}, x, train=True)
        return sum(jnp.sum(o * g) for o, g in zip(outs, gs))
    want = state_dict_from_jax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(total))(params)))
    before = {k: v.clone() for k, v in port.named_buffers()}
    port.train()
    outs = port(T(x))
    sum((o * T(g)).sum() for o, g in zip(outs, gs)).backward()
    for k, v in port.named_buffers():
        assert torch.equal(v, before[k]), k
    frozen = ('conv1.', 'bn1.', 'layer1.')
    for name, p in port.named_parameters():
        if name.startswith(frozen):
            assert p.grad is None and not want[name].abs().max(), name
        else:
            assert p.grad is not None and want[name].abs().max() > 0, name
            assert _rel(p.grad, want[name]) <= TOL_MODULE_GRAD, name
    assert any(n.startswith('layer1.') for n, _ in port.named_parameters())


@pytest.mark.parametrize('case', ['r50-pytorch', 'x50-g4'])
def test_resnet_weights_round_trip_bit_exact(case):
    """state_dict_from_jax(params, batch_stats) then the JAX package's
    convert_torch_state_dict gives the same trees bit for bit: mmdet's
    dotted names (layer1.0, downsample.0 / .1), grouped kernels (HWIO with
    I = in / groups) and the running statistics."""
    _, params, stats, port, _ = _resnet(case)
    sd = state_dict_from_jax(params, stats)
    assert set(sd) == set(port.state_dict())
    assert 'layer1.0.downsample.0.weight' in sd \
        and 'layer2.0.downsample.1.running_var' in sd
    new_params, new_stats, report = convert_torch_state_dict(
        sd, params, batch_stats=stats)
    assert not report['missing'] and not report['unexpected']
    for a, b in ((new_params, params), (new_stats, stats)):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb)
        assert all(np.array_equal(np.asarray(u), v) for u, v in zip(la, lb))


def test_resnet_options_not_ported_raise():
    """plugins (ContextBlock, GeneralizedAttention) build on a Bottleneck
    ResNet (test_torch_plugins.py) and raise ValueError on a BasicBlock one
    (depth 18 here), as mmdet's BasicBlock asserts: the JAX ResNet drops
    them there (resnet.py:252-259), and no config puts them on one."""
    for kw in (dict(plugins=[dict(cfg=dict(type='ContextBlock'))]),
               dict(plugins=[dict(cfg=dict(type='GeneralizedAttention'),
                                  position='after_conv2')])):
        with pytest.raises(ValueError, match='Bottleneck'):
            ResNet(depth=18, **kw)


# ------------------------------------------------------ anchors, sampler
ANCHOR_CASES = {
    'octave': dict(octave_base_scale=4, scales_per_octave=3,
                   ratios=[0.5, 1.0, 2.0], strides=[8, 16, 32, 64, 128]),
    'octave-centred': dict(octave_base_scale=8, scales_per_octave=2,
                           ratios=[1.0, 2.0], strides=[8, 16, 32],
                           center_offset=0.5),
    'scales': dict(scales=[8], ratios=[0.5, 1.0, 2.0],
                   strides=[4, 8, 16, 32, 64]),
}


@pytest.mark.parametrize('case', list(ANCHOR_CASES))
def test_anchor_generator_matches_jax(case):
    """Octave anchors (RetinaNet's nine a location), a centre offset and
    plain scales: base anchors, grid anchors and valid flags equal."""
    kw = ANCHOR_CASES[case]
    want, got = JaxAnchorGenerator(**kw), AnchorGenerator(**kw)
    assert got.num_base_anchors == want.num_base_anchors
    sizes = [(-(-100 // s), -(-136 // s)) for s in kw['strides']]
    for a, b in zip(got.grid_anchors(sizes),
                    want.grid_anchors(sizes)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    pad = np.array([90, 120])
    for a, b in zip(got.valid_flags(sizes, T(pad)),
                    want.valid_flags(sizes, pad)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if case == 'octave':
        assert got.num_base_anchors == [9] * 5
        np.testing.assert_allclose(got.scales, 4 * 2 ** (np.arange(3) / 3))


def test_pseudo_sampler_matches_jax():
    """Every positive and negative kept in place: full-set masks, the
    positives' gts, boxes and labels, the counts; candidates outside
    bbox_valid (ignored by neither) dropped."""
    rs = np.random.RandomState(4)
    xy = rs.uniform(0, 80, (50, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(4, 40, (50, 2))], 1) \
        .astype(np.float32)
    gts = np.array([[10.3, 12.1, 50.7, 44.9], [40.2, 30.6, 70.9, 90.1],
                    [0, 0, 0, 0]], np.float32)
    valid = np.array([True, True, False])
    labels = np.array([3, 1, 0], np.int32)
    bbox_valid = rs.rand(50) > 0.2
    args = [boxes, gts, valid, labels, bbox_valid]
    assign = JaxMaxIoU(0.5, 0.4, min_pos_iou=0).assign(
        *args[:4], bbox_valid=bbox_valid)
    want = JaxPseudoSampler().sample(jax.random.PRNGKey(0), assign, boxes,
                                     gts, valid, labels,
                                     bbox_valid=bbox_valid)
    t = list(map(T, args))
    got = PseudoSampler().sample(
        MaxIoUAssigner(0.5, 0.4, min_pos_iou=0).assign(*t[:4],
                                                       bbox_valid=t[4]),
        t[0], t[1], t[2], t[3], bbox_valid=t[4])
    for k in want._fields:
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
    assert 0 < int(got.num_pos) < int(got.num_neg) < 50


# ------------------------------------------------------------------- SGD
@pytest.mark.parametrize('nesterov', [False, True])
def test_sgd_trajectory_matches_jax(nesterov):
    """10 SGD steps in fp64 with the same gradients on both sides, one of
    them zero (weight decay and momentum alone), through linear warm-up,
    a step decay, a decay_mult=0 key and an lr_mult key."""
    rs = np.random.RandomState(1)
    values = {n: rs.randn(*s) for n, s in NAMES.items()}
    grads = [{n: rs.randn(*s) for n, s in NAMES.items()} for _ in range(10)]
    grads[3] = {n: np.zeros(s) for n, s in NAMES.items()}
    base_lr, iters_per_epoch = 0.05, 3
    opt_cfg = dict(type='SGD', lr=base_lr, momentum=0.9, weight_decay=0.01,
                   nesterov=nesterov,
                   paramwise_cfg=dict(custom_keys=CUSTOM_KEYS))
    model = torch.nn.Module()
    params = torch.nn.ParameterDict()
    for n, v in values.items():
        params[n.replace('.', '__')] = torch.nn.Parameter(
            torch.tensor(v, dtype=torch.float64))
    model.named_parameters = lambda: [
        (k.replace('__', '.'), p) for k, p in params.items()]
    opt = build_optimizer(model, opt_cfg)
    assert isinstance(opt, torch.optim.SGD)
    schedule = build_lr_schedule(LR_CONFIG, base_lr, iters_per_epoch)
    with jax.enable_x64():
        tree = _flax_tree(values)
        tx = jax_build_opt(tree, copy.deepcopy(opt_cfg),
                           jax_schedule(LR_CONFIG, base_lr, iters_per_epoch))
        state = tx.init(tree)
        for t in range(10):
            for name, p in model.named_parameters():
                p.grad = torch.tensor(grads[t][name])
            set_lr(opt, schedule(t))
            opt.step()
            updates, state = tx.update(_flax_tree(grads[t]), state, tree)
            tree = optax.apply_updates(tree, updates)
            want = _by_name(tree)
            for name, p in model.named_parameters():
                err = _rel(p.detach().numpy(), want[name])
                assert err < 1e-6, f'step {t} {name}: rel err {err:.2e}'


# ------------------------------------------------- tiny Faster R-CNN R-50
def tiny_faster_rcnn_cfg():
    """The Faster R-CNN R-50 config's graph scaled down as
    tiny_maskrcnn_cfg: a ResNet-50 of base width 8 (stage widths 32-256),
    frozen_stages=1, FPN and heads at 32 channels, 4 classes."""
    cfg = tiny_maskrcnn_cfg(with_mask=False)
    cfg['type'] = 'FasterRCNN'
    cfg['backbone'] = dict(type='ResNet', depth=50, base_channels=8,
                           num_stages=4, out_indices=(0, 1, 2, 3),
                           frozen_stages=1, norm_eval=True)
    cfg['roi_head'].pop('mask_roi_extractor')
    cfg['roi_head'].pop('mask_head')
    return cfg


@pytest.fixture(scope='module')
def faster():
    """The JAX detector, numpy params (rpn_cls and fc_cls with std 1) and
    batch statistics, and the port's FasterRCNN on them (eval mode)."""
    cfg = tiny_faster_rcnn_cfg()
    jm, params = jax_detector_params(cfg, seed=0)
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    stats = _draw_stats(shapes['batch_stats'], 200)
    sd = state_dict_from_jax(params, stats)
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(sd, strict=True)
    return dict(cfg=cfg, jm=jm, params=params, stats=stats, sd=sd,
                port=port.eval())


def test_faster_rcnn_simple_test_matches_jax(faster):
    assert isinstance(faster['port'], FasterRCNN)
    assert not faster['port'].roi_head.with_mask
    rs = np.random.RandomState(11)
    img = rs.randn(2, H, W, 3).astype(np.float32)
    shapes = np.array([[H, W], [H - 8, W - 16]], np.int32)
    sf = np.array([[1.0] * 4, [0.75] * 4], np.float32)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, *a: faster['jm'].apply(v, *a, method='simple_test'))(
        {'params': faster['params'], 'batch_stats': faster['stats']}, img,
        shapes, sf))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in faster['port'].simple_test(
            T(img), T(shapes), T(sf)).items()}
    v = want['det_valid']
    assert set(got) == {'dets', 'labels', 'det_valid'}
    assert np.array_equal(got['det_valid'], v) and v.sum() >= 8
    assert np.array_equal(got['labels'][v], want['labels'][v])
    np.testing.assert_allclose(got['dets'][v][:, :4], want['dets'][v][:, :4],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got['dets'][v][:, 4], want['dets'][v][:, 4],
                               rtol=0, atol=1e-4)


@pytest.fixture(scope='module')
def faster_train(faster):
    """forward_train on both sides with the same batch and sampler keys:
    losses, every gradient, the keys and the port's batch."""
    cfg, jm = faster['cfg'], faster['jm']
    batch = make_batch()
    del batch['gt_masks']
    n_rpn = 3 * sum(-(-H // s) * -(-W // s) for s in (4, 8, 16, 32, 64))
    n_rcnn = 3 + cfg['train_cfg']['rpn_proposal']['max_per_img']
    keys = sampler_keys(n_rpn, n_rcnn)
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxSampler, '_pos_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][0]))
    mp.setattr(JaxSampler, '_neg_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][1]))
    try:
        args = [jnp.asarray(batch[k]) for k in (
            'img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
            'gt_labels')]

        def total(p):
            losses = jm.apply({'params': p, 'batch_stats': faster['stats']},
                              *args, method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(1)})
            return jax_parse_losses(losses)
        (_, want), grads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(faster['params'])
    finally:
        mp.undo()
    grads = jax.tree.map(np.asarray, grads)
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(faster['sd'], strict=True)
    port.train()
    tb = {k: T(v) for k, v in batch.items()}
    tkeys = {name: [tuple(T(k) for k in keys[n])] * 2
             for name, n in (('rpn', n_rpn), ('rcnn', n_rcnn))}
    losses = port.forward_train(tb['img'], tb['img_shapes'],
                                tb['pad_shapes'], tb['gt_bboxes'],
                                tb['gt_valid'], tb['gt_labels'],
                                sampler_keys=tkeys)
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    return dict(want={k: float(v) for k, v in want.items()},
                got={k: float(v.detach()) for k, v in losses.items()},
                jax_grads=grads, want_grads=state_dict_from_jax(grads),
                port=port, batch=tb, keys=tkeys)


def test_faster_rcnn_forward_train_matches_jax(faster_train):
    want, got = faster_train['want'], faster_train['got']
    assert set(got) == {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'acc',
                        'loss_bbox'}
    for k, v in got.items():
        assert np.isfinite(v), k
        assert abs(v - want[k]) <= TOL_LOSS * max(abs(want[k]), 1e-6), \
            (k, v, want[k])
    port = faster_train['port']
    checked = 0
    for name, p in port.named_parameters():
        w = faster_train['want_grads'][name]
        if name.startswith(('backbone.conv1.', 'backbone.bn1.',
                            'backbone.layer1.')):
            assert p.grad is None and not w.abs().max(), name
            continue
        assert p.grad is not None, name
        if w.abs().max() > 0:
            assert _rel(p.grad, w) <= TOL_GRAD, (name, _rel(p.grad, w))
            checked += 1
    assert checked > 100


# the optimizers of the step below, and the most a parameter may move
# apart from the JAX package's in one step, given the largest entry of its
# gradient: SGD moves it by lr times the gradient, whose error is within
# TOL_GRAD of that entry; AdamW by lr times g / (|g| + eps), which a
# gradient's error can move by at most twice lr
STEP_OPTIMIZERS = {
    'SGD': (dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=1e-4),
            lambda g: 0.02 * TOL_GRAD * g),
    'AdamW': (dict(type='AdamW', lr=1e-4, betas=(0.9, 0.999),
                   weight_decay=0.05), lambda g: 2 * 1e-4),
}


@pytest.mark.parametrize('opt', list(STEP_OPTIMIZERS))
def test_faster_rcnn_train_step_matches_jax(faster, faster_train, opt):
    """One make_train_step step with the config's SGD (lr 0.02, momentum
    0.9, weight decay 1e-4), or AdamW, at a constant lr: every parameter
    after the step equals the JAX package's optax chain applied to its own
    gradients, the frozen stem and layer1 included, which weight decay
    alone moves (their gradient is zero on both sides: the port's step
    gives them a zero one, which torch.optim would otherwise skip)."""
    cfg, limit = STEP_OPTIMIZERS[opt]
    lr = cfg['lr']
    port = build_detector(copy.deepcopy(faster['cfg']))
    port.load_state_dict(faster['sd'], strict=True)
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    step = make_train_step(port, build_optimizer(port, cfg), lambda it: lr)
    log = step(dict(faster_train['batch']), torch.Generator().manual_seed(0),
               sampler_keys=faster_train['keys'])
    assert np.isfinite(log['loss']) and log['grad_norm'] > 0
    params = faster['params']
    tx = jax_build_opt(params, dict(cfg), lambda s: lr)
    updates, _ = jax.jit(tx.update)(faster_train['jax_grads'],
                                    tx.init(params), params)
    want = state_dict_from_jax(jax.tree.map(
        np.asarray, optax.apply_updates(params, updates)))
    frozen = 0
    for name, p in port.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        if name.startswith(('backbone.conv1.', 'backbone.bn1.',
                            'backbone.layer1.')):
            assert not torch.equal(p.detach(), before[name]), name
            assert _rel(got, w) <= TOL_STEP, name
            frozen += 1
            continue
        g = np.abs(faster_train['want_grads'][name].numpy()).max()
        assert np.abs(got - w).max() <= limit(g) + TOL_STEP * np.abs(
            w).max(), name
    assert frozen > 10
