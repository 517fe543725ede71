"""Hybrid Task Cascade in the port against the JAX package on the CPU, fp32,
on the same numpy weights, inputs and sampler keys:

- the align-corners bilinear resize against the JAX package's
  ``torch_bilinear_resize(align_corners=True)``;
- ``FusedSemanticHead``: its logits and embedding, and its loss with
  ignored (255) and out-of-range labels, on a label map of the logits'
  size and of another (the half-pixel nearest resize);
- ``HTCMaskHead`` with and without ``conv_res``, under each of its
  ``return_logits`` / ``return_feat`` choices;
- the JAX tests' tiny HTC (``tiny_htc_cfg``: Swin depths [1, 1, 1, 1],
  narrow widths) with and without the semantic branch, and without it
  and with ``interleaved`` and ``mask_info_flow`` off: ``simple_test`` of
  each, ``aug_test_two_stage``, ``forward_train``'s losses and every
  gradient of the first and the last (each switch on and off), and one
  ``make_train_step`` step that carries ``gt_semantic_seg``;
- the three places where the port follows the JAX package and not mmdet:
  test-time augmentation without the semantic fusion and the mask
  information flow, ``LoadAnnotations(with_seg)``'s channel 0 of a BGR
  decode, and the semantic loss's label resize;
- the stuff-map data path, ``LoadAnnotations(with_seg)`` -> ``Resize`` ->
  ``RandomFlip`` -> ``Pad`` -> ``SegRescale`` -> ``collate_detection``
  (and ``RandomCrop``) against the JAX pipeline on a grayscale PNG, bit
  for bit;
- the 13 HTC configs build in both packages, and those still waiting for
  RFP / SAC and SCNet refuse in the port naming what they lack; a strict
  load of the mmdet-named weights, and their round trip through the JAX
  converter.

Tolerances: module outputs at 1e-5 of their largest entry, the semantic
loss at rel 1e-6; detections with labels equal, boxes within 1e-3 px,
scores and mask probabilities within 1e-4; losses at rel 1e-4 and
gradients at 1e-3 of each tensor's largest entry.

Sampler keys: with ``interleaved``, a stage's bbox sample and the previous
stage's mask sample both have G + num candidates, so the JAX samplers'
``_pos_keys`` / ``_neg_keys`` are patched to hand out the keys by call
order (the RPN's, then each stage's bbox sample and its mask sample), the
order in which the port takes them through ``sampler_keys['rcnn']``.
"""
import copy
import functools
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.apis import aug_test as jax_aug_test
from swindet_tpu.apis.inference import DetectorHandle
from swindet_tpu.checkpoint import (convert_torch_state_dict,
                                    default_flatten_hints)
from swindet_tpu.core.bbox import samplers as jax_samplers
from swindet_tpu.core.bbox.samplers import RandomSampler as JaxSampler
from swindet_tpu.datasets.builder import \
    collate_detection as jax_collate_detection
from swindet_tpu.datasets.pipelines import Compose as JaxCompose
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.models.builder import build_head as jax_build_head
from swindet_tpu.ops.interpolate import torch_bilinear_resize
from swindet_tpu.utils import Config as JaxConfig

from tests.test_models.test_cascade import tiny_htc_cfg
from tests.test_torch_atss import jax_setup
from tests.test_torch_backbones import _ClampedTake, jit_o0
from tests.test_torch_cascade import numpy_params_from
from tests.test_torch_checkpoint import numpy_params
from tests.test_torch_fcos import _config
from tests.test_torch_train import make_batch
from tests.test_torch_zoo import _det_errors, _test_inputs
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.apis.aug_test import aug_test_two_stage
from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.datasets.builder import collate_detection
from swindet_tpu_torch.datasets.pipelines import Compose
from swindet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                      make_train_step)
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.builder import build_head
from swindet_tpu_torch.models.roi_heads.htc_roi_head import \
    resize_bilinear_align_corners

cap_torch_threads()

TOL_MODULE = 1e-5
TOL_SEM_LOSS = 1e-6
TOL_LOSS = 1e-4
TOL_GRAD = 1e-3
H, W = 64, 96
NUM_STUFF = 8


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _init(jm, *inputs, seed=0, **kw):
    shapes = jax.eval_shape(lambda k: jm.init(k, *inputs, **kw),
                            jax.random.PRNGKey(0))
    return numpy_params_from(shapes['params'], seed)


def _load(port, params, name, prefix):
    """The port module's state_dict from a JAX head's params (the RoI
    head's child ``name``), through state_dict_from_jax under the
    detector's names, then ``prefix`` cut."""
    sd = state_dict_from_jax({'_roi_head': {name: params}})
    assert all(k.startswith(prefix) for k in sd)
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                         strict=True)
    return port


# ---------------------------------------------------------------- resize
@pytest.mark.parametrize('src,dst', [((8, 12), (16, 24)), ((16, 24), (8, 12)),
                                     ((4, 6), (8, 12)), ((3, 5), (13, 7)),
                                     ((8, 12), (8, 12))])
def test_align_corners_resize_matches_jax(src, dst):
    x = np.random.RandomState(1).randn(2, *src, 5).astype(np.float32)
    want = torch_bilinear_resize(jnp.asarray(x), dst, align_corners=True)
    got = resize_bilinear_align_corners(T(x), dst)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) <= TOL_MODULE


# --------------------------------------------------------- semantic head
SEM_CFG = dict(type='FusedSemanticHead', num_ins=5, fusion_level=1,
               num_convs=2, in_channels=16, conv_out_channels=16,
               num_classes=NUM_STUFF, ignore_label=255, loss_weight=0.2)
LEVELS = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]


@pytest.fixture(scope='module')
def semantic():
    rs = np.random.RandomState(2)
    feats = [rs.randn(2, h, w, 16).astype(np.float32) for h, w in LEVELS]
    jm = jax_build_head(dict(SEM_CFG))
    params = _init(jm, [jnp.asarray(f) for f in feats], seed=3)
    port = _load(build_head(dict(SEM_CFG)), params, '_semantic_head',
                 'roi_head.semantic_head.')
    want = jm.apply({'params': params}, [jnp.asarray(f) for f in feats])
    got = port([T(f) for f in feats])
    return dict(jm=jm, params=params, port=port, want=want, got=got)


def test_semantic_head_matches_jax(semantic):
    for got, want in zip(semantic['got'], semantic['want']):
        assert tuple(got.shape) == tuple(want.shape)
        assert got.shape[1:3] == (8, 12)
        assert _rel(got, want) <= TOL_MODULE
    assert ('conv_embedding.conv.weight' in semantic['port'].state_dict())


def _labels(shape, seed):
    rs = np.random.RandomState(seed)
    lab = rs.randint(0, NUM_STUFF, shape)
    lab[rs.rand(*shape) < 0.2] = 255            # ignored
    lab[rs.rand(*shape) < 0.05] = NUM_STUFF + 3  # out of range: ignored
    return lab.astype(np.uint8)


@pytest.mark.parametrize('shape', [(2, 8, 12), (2, 13, 21), (2, 5, 7)])
def test_semantic_loss_matches_jax(semantic, shape):
    """The loss on labels of the logits' size and of others (resized to
    the logits' with half-pixel nearest sampling)."""
    labels = _labels(shape, 4)
    pred = semantic['want'][0]
    want = semantic['jm'].apply({'params': semantic['params']}, pred,
                                jnp.asarray(labels), method='loss')
    got = semantic['port'].loss(T(np.asarray(pred)), T(labels))
    assert abs(float(got) - float(want)) <= TOL_SEM_LOSS * abs(float(want))


def test_semantic_loss_resizes_labels_half_pixel(semantic):
    """Divergence kept from the JAX package: labels of another size are
    resized to the logits' (half-pixel nearest); mmdet feeds them to the
    cross-entropy as they are. Output row 7 of a 13-row map read from 8
    rows is source row floor(7.5 * 13 / 8) = 12, where torch's nearest
    (floor(7 * 13 / 8) = 11) reads another."""
    labels = np.zeros((1, 13, 12), np.uint8)
    labels[0, 12] = 1
    pred = np.zeros((1, 8, 12, NUM_STUFF), np.float32)
    pred[..., 1] = 5.0      # confident in class 1
    one = float(semantic['port'].loss(T(pred), T(labels)))
    labels[0, 12] = 0
    labels[0, 11] = 1
    other = float(semantic['port'].loss(T(pred), T(labels)))
    assert one < other      # row 12 feeds output row 7, row 11 does not


def test_semantic_head_conv_to_res_refuses():
    with pytest.raises(NotImplementedError, match='slice 2e'):
        build_head(dict(SEM_CFG, conv_to_res=True))


# -------------------------------------------------------------- mask head
MASK_CFG = dict(type='HTCMaskHead', num_convs=2, in_channels=16,
                conv_out_channels=16, num_classes=4)


@pytest.mark.parametrize('with_res', [False, True])
@pytest.mark.parametrize('logits,feat', [(True, False), (False, True),
                                         (True, True)])
def test_htc_mask_head_matches_jax(with_res, logits, feat):
    cfg = dict(MASK_CFG, with_conv_res=with_res)
    rs = np.random.RandomState(5)
    x = rs.randn(6, 14, 14, 16).astype(np.float32)
    res = rs.randn(6, 14, 14, 16).astype(np.float32) if with_res else None
    jm = jax_build_head(dict(cfg))
    args = (jnp.asarray(x),) + ((jnp.asarray(res),) if with_res else ())
    params = _init(jm, *args, seed=6, return_logits=True, return_feat=True)
    port = _load(build_head(dict(cfg)), params, '_mask_head1',
                 'roi_head.mask_head.1.')
    assert (port.conv_res is not None) == with_res
    want = jm.apply({'params': params}, *args, return_logits=logits,
                    return_feat=feat)
    got = port(*map(T, [a for a in (x, res) if a is not None]),
               return_logits=logits, return_feat=feat)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == logits + feat
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert _rel(g, w) <= TOL_MODULE
    if feat:    # the tower's output, before the deconv
        assert tuple(got[-1].shape) == (6, 14, 14, 16)


# ----------------------------------------------------------- tiny HTC
# as configs/htc has it, with and without the semantic branch, and with
# each switch off: every one of them is on and off in a trained variant
VARIANTS = {
    'semantic': dict(),
    'without_semantic': dict(with_semantic=False),
    'plain': dict(with_semantic=False, interleaved=False,
                  mask_info_flow=False),
}
# the variants trained against the JAX package: its gradient's trace and
# compile take about 25 s a variant on the CPU
TRAINED = ('semantic', 'plain')


def variant_cfg(name):
    opts = dict(VARIANTS[name])
    cfg = copy.deepcopy(tiny_htc_cfg(opts.pop('with_semantic', True)))
    cfg['roi_head'].update(opts)
    return cfg


def _seg(b=2, seed=7):
    """A stuff map at 1/8 of the batch's canvas, 255 on its last column."""
    lab = _labels((b, H // 8, W // 8), seed)
    lab[:, :, -1] = 255
    return lab


@functools.lru_cache(maxsize=None)
def _case(name):
    """A variant's JAX detector and numpy params (rpn_cls and every
    fc_cls drawn with std 1) and the port's detector on them (eval mode),
    built once: no test changes it."""
    cfg = variant_cfg(name)
    jm = jax_build_detector(copy.deepcopy(cfg))
    params = numpy_params(jm, 0, method='forward_dummy')
    rs = np.random.RandomState(100)
    roi = params['_roi_head']
    for leaf in [params['_rpn_head']['rpn_cls']] + [
            roi[f'_bbox_head{i}']['fc_cls'] for i in range(3)]:
        leaf['kernel'] = rs.randn(*leaf['kernel'].shape).astype(np.float32)
    sd = state_dict_from_jax(params)
    port = build_detector(copy.deepcopy(cfg))
    own = port.state_dict()
    # without the information flow the JAX heads never call conv_res, so
    # flax makes no parameters for it; mmdet's heads (and the port's) hold
    # them all the same, unused: they keep the port's own init
    unused = set(own) - set(sd)
    assert all('.conv_res.' in k for k in unused)
    assert bool(unused) == (not cfg['roi_head']['mask_info_flow'])
    sd.update({k: own[k] for k in unused})
    port.load_state_dict(sd, strict=True)
    return dict(name=name, cfg=cfg, jm=jm, params=params, sd=sd,
                port=port.eval())


@pytest.fixture(scope='module', params=list(VARIANTS))
def htc(request):
    return _case(request.param)


def test_htc_simple_test_matches_jax(htc):
    img, shapes, sf = _test_inputs()
    run = jit_o0(lambda v, *a: htc['jm'].apply(v, *a, method='simple_test'))
    want = jax.tree.map(np.asarray, run({'params': htc['params']}, img,
                                        shapes, sf))
    with torch.no_grad():
        got = {k: t.numpy() for k, t in htc['port'].simple_test(
            T(img), T(shapes), T(sf)).items()}
    v = want['det_valid']
    assert set(got) == set(want)
    assert np.array_equal(got['det_valid'], v) and v.sum() >= 8
    assert np.array_equal(got['labels'][v], want['labels'][v])
    errs = _det_errors(got, want, v)
    assert errs['box'] <= 1e-3 and errs['score'] <= 1e-4 \
        and errs['mask'] <= 1e-4, errs


def _augs():
    img, shapes, sf = _test_inputs()
    return [dict(img=img, img_shapes=shapes, scale_factors=sf, flip=False),
            dict(img=img[:, :, ::-1].copy(), img_shapes=shapes,
                 scale_factors=sf, flip=True, flip_direction='horizontal')]


def test_htc_aug_test_matches_jax():
    """aug_test_two_stage over the image and its flip against the JAX
    package's: both run the cascade's bbox_test / mask_test, without the
    semantic fusion or the mask information flow, so the three variants
    run the same halves; the one with the semantic branch here."""
    htc = _case('semantic')
    handle = DetectorHandle(JaxConfig(dict(model=htc['cfg'])), htc['jm'],
                            {'params': htc['params']})
    want = jax.tree.map(np.asarray, jax_aug_test.aug_test_two_stage(
        handle, _augs()))
    with torch.no_grad():
        got = aug_test_two_stage(htc['port'], [
            {k: T(v) if isinstance(v, np.ndarray) else v
             for k, v in ab.items()} for ab in _augs()])
    got = {k: v.numpy() for k, v in got.items()}
    v = want['det_valid']
    assert np.array_equal(got['det_valid'], v) and v.sum() >= 8
    assert np.array_equal(got['labels'][v], want['labels'][v])
    errs = _det_errors(got, want, v)
    assert errs['box'] <= 1e-3 and errs['score'] <= 1e-4 \
        and errs['mask'] <= 1e-4, errs


def test_htc_aug_halves_drop_fusion_and_flow():
    """Divergence kept from the JAX package: the per-augmentation halves
    are the cascade's, so the stage-averaged scores of aug_bbox_test are
    those of the bbox stages without the semantic fusion (and
    aug_mask_test's the mask heads' without the chain), not
    simple_test's."""
    case = _case('semantic')
    port = case['port']
    img, shapes, _ = _test_inputs()
    rs = np.random.RandomState(12)
    xy = rs.uniform(0, 50, (2, 20, 2))
    props = np.concatenate([xy, xy + rs.uniform(6, 40, (2, 20, 2))], -1) \
        .astype(np.float32)
    with torch.no_grad():
        feats = port.extract_feat(T(img))
        got, _ = port.aug_bbox_test(T(img), T(props), T(shapes))
        roi = port.roi_head
        rois = torch.cat([torch.arange(2.).repeat_interleave(20)[:, None],
                          T(props).reshape(-1, 4)], 1)
        fused, _, _ = roi._ms_bbox_forward(
            feats, rois, T(shapes).repeat_interleave(20, 0),
            roi._fusion('bbox', roi.semantic_head(feats)[1]))
        plain, _, _ = roi._ms_bbox_forward(
            feats, rois, T(shapes).repeat_interleave(20, 0))
    assert torch.equal(got.reshape(-1, got.shape[-1]), plain)
    assert not torch.allclose(plain, fused, atol=1e-3)


class _KeysByCall:
    """The JAX sampler's keys handed out by call order; ``order`` lists
    each call's candidate count."""

    def __init__(self, order, seed=5):
        rs = np.random.RandomState(seed)
        self.order = order
        self.keys = [(rs.rand(n).astype(np.float32),
                      rs.rand(n).astype(np.float32)) for n in order]
        self.calls = {0: 0, 1: 0}

    def get(self, which, n):
        i = self.calls[which]
        self.calls[which] += 1
        assert self.order[i] == n, (i, self.order[i], n)
        return jnp.asarray(self.keys[i][which])


def _call_order(cfg, port, batch):
    """The candidate counts of the samplers' calls: the RPN's anchors, then
    per stage its bbox sample (G + P, then G + num) and, with
    ``interleaved``, its mask sample (G + num)."""
    gen = cfg['rpn_head']['anchor_generator']
    per = len(gen['scales']) * len(gen['ratios'])
    with torch.no_grad():
        feats = port.extract_feat(T(batch['img']))
    order = [per * sum(f.shape[1] * f.shape[2] for f in feats)]
    g = batch['gt_bboxes'].shape[1]
    rcnn = cfg['train_cfg']['rcnn']
    cand = g + cfg['train_cfg']['rpn_proposal']['max_per_img']
    for stage in range(3):
        order.append(cand)
        cand = g + rcnn[stage]['sampler']['num']
        if cfg['roi_head'].get('interleaved', True):
            order.append(cand)
    return order


def _jax_forward_train(case, batch, order):
    """The JAX losses, gradients and proposals with keys by call order
    (the empty slots' gathers clamped, as test_torch_backbones.py's
    check_forward_train takes them)."""
    jm, names = case['jm'], ['img', 'img_shapes', 'pad_shapes', 'gt_bboxes',
                             'gt_valid', 'gt_labels', 'gt_masks',
                             'gt_semantic_seg']
    args = [jnp.asarray(batch[k]) for k in names]
    provider = _KeysByCall(order)
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxSampler, '_pos_keys',
               lambda self, rng, a, m, n: provider.get(0, n))
    mp.setattr(JaxSampler, '_neg_keys',
               lambda self, rng, a, m, n: provider.get(1, n))
    mp.setattr(jax_samplers, 'jnp', _ClampedTake())
    try:
        def total(p, args):
            losses, state = jm.apply(
                {'params': p}, *args, method='forward_train',
                rngs={'sampling': jax.random.PRNGKey(1)},
                mutable=['intermediates'],
                capture_intermediates=lambda mdl, name:
                    name == 'get_proposals')
            loss, log_vars = jax_parse_losses(losses)
            props = state['intermediates']['_rpn_head']['get_proposals'][0]
            return loss, (log_vars, props)
        (_, (want, props)), grads = jit_o0(jax.value_and_grad(
            total, has_aux=True))(case['params'], args)
    finally:
        mp.undo()
    assert provider.calls == {0: len(order), 1: len(order)}
    return want, grads, props, provider


@pytest.fixture(scope='module', params=TRAINED)
def train_run(request):
    htc = _case(request.param)
    batch = dict(make_batch(g=3), gt_semantic_seg=_seg())
    order = _call_order(htc['cfg'], htc['port'], batch)
    want, grads, props, provider = _jax_forward_train(htc, batch, order)
    port = build_detector(copy.deepcopy(htc['cfg']))
    port.load_state_dict(htc['sd'], strict=True)
    port.train()
    tb = {k: T(v) for k, v in batch.items()}
    keys = [tuple(T(k) for k in pair) for pair in provider.keys]
    pinned = tuple(T(np.asarray(a)) for a in props)
    port.rpn_head.get_proposals = lambda *a, **kw: pinned
    losses = port.forward_train(
        tb['img'], tb['img_shapes'], tb['pad_shapes'], tb['gt_bboxes'],
        tb['gt_valid'], tb['gt_labels'], tb['gt_masks'],
        sampler_keys=dict(rpn=[keys[0]] * 2,
                          rcnn=[[k] * 2 for k in keys[1:]]),
        gt_semantic_seg=tb['gt_semantic_seg'])
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    return dict(want={k: float(v) for k, v in want.items() if k != 'loss'},
                got={k: float(v.detach()) for k, v in losses.items()},
                want_grads=state_dict_from_jax(jax.tree.map(np.asarray,
                                                            grads)),
                port=port, name=htc['name'])


def test_htc_forward_train_losses_match_jax(train_run):
    want, got = train_run['want'], train_run['got']
    names = {f's{i}.{k}' for i in range(3)
             for k in ('loss_cls', 'loss_bbox', 'loss_mask', 'acc')} \
        | {'loss_rpn_cls', 'loss_rpn_bbox'}
    if train_run['name'] == 'semantic':
        names.add('loss_semantic_seg')
    assert set(got) == set(want) == names
    for k, v in got.items():
        assert np.isfinite(v), k
        assert abs(v - want[k]) <= TOL_LOSS * max(abs(want[k]), 1e-6), \
            (k, v, want[k])


def test_htc_forward_train_grads_match_jax(train_run):
    """Every parameter's gradient (the frozen-free tiny Swin included)."""
    want = train_run['want_grads']
    checked = 0
    for name, p in train_run['port'].named_parameters():
        if name not in want:    # conv_res without the information flow
            assert '.conv_res.' in name and p.grad is None, name
            continue
        w = want[name]
        assert p.grad is not None, name
        if w.abs().max() > 0:
            assert _rel(p.grad, w) <= TOL_GRAD, (name, _rel(p.grad, w))
            checked += 1
    assert checked > 60
    if train_run['name'] == 'semantic':
        assert float(want['roi_head.semantic_head.convs.0.conv.weight']
                     .abs().max()) > 0


def test_htc_train_step_carries_semantic_seg():
    """One make_train_step step on a batch with gt_semantic_seg: the
    semantic loss is logged and the semantic head's weights move."""
    case = _case('semantic')
    port = build_detector(copy.deepcopy(case['cfg']))
    port.load_state_dict(case['sd'], strict=True)
    opt = build_optimizer(port, dict(type='SGD', lr=0.02, momentum=0.9,
                                     weight_decay=1e-4))
    step = make_train_step(port, opt, build_lr_schedule(
        dict(policy='step', step=[8, 11]), 0.02, 10))
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    batch = {k: T(v) for k, v in dict(make_batch(g=3),
                                      gt_semantic_seg=_seg()).items()}
    log = step(batch, torch.Generator().manual_seed(0))
    assert 'loss_semantic_seg' in log and log['loss_semantic_seg'] > 0
    assert all(np.isfinite(v) for v in log.values())
    after = port.state_dict()
    for k in ('roi_head.semantic_head.convs.1.conv.weight',
              'roi_head.semantic_head.conv_logits.weight',
              'roi_head.mask_head.2.conv_res.conv.weight'):
        assert not torch.equal(before[k], after[k]), k


def test_htc_weights_load_strictly_and_round_trip():
    """The mmdet names of the semantic branch and of conv_res, a strict
    load, and the round trip through the JAX package's converter, bit for
    bit: it reads every name as the port writes it, none renamed."""
    case = _case('semantic')
    sd = case['sd']
    for key in ('roi_head.semantic_head.lateral_convs.0.conv.weight',
                'roi_head.semantic_head.lateral_convs.4.conv.bias',
                'roi_head.semantic_head.convs.1.conv.weight',
                'roi_head.semantic_head.conv_embedding.conv.weight',
                'roi_head.semantic_head.conv_logits.weight',
                'roi_head.mask_head.1.conv_res.conv.weight'):
        assert key in sd, key
    assert not any('mask_head.0.conv_res' in k for k in sd)
    port = build_detector(copy.deepcopy(case['cfg']))
    port.load_state_dict(sd, strict=True)
    new_params, report = convert_torch_state_dict(
        dict(sd), case['params'],
        flatten_hints=default_flatten_hints(case['cfg']))
    assert not report['missing'] and not report['unexpected'], report
    la, lb = jax.tree.leaves(new_params), jax.tree.leaves(case['params'])
    assert len(la) == len(lb)
    assert all(np.array_equal(np.asarray(u), v) for u, v in zip(la, lb))


# ------------------------------------------------------------- data path
def _write_png(path, arr):
    import cv2
    assert cv2.imwrite(path, arr)


SEG_PIPELINE = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True, with_mask=True,
         with_seg=True),
    dict(type='Resize', img_scale=(150, 100), keep_ratio=True),
    dict(type='RandomFlip', flip_ratio=0.5),
    dict(type='Normalize', mean=[123.675, 116.28, 103.53],
         std=[58.395, 57.12, 57.375], to_rgb=True),
    dict(type='Pad', size_divisor=32),
    dict(type='SegRescale', scale_factor=1 / 8),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels', 'gt_masks',
                               'gt_semantic_seg']),
]
CROP_PIPELINE = SEG_PIPELINE[:3] + [
    dict(type='RandomCrop', crop_size=(60, 90))] + SEG_PIPELINE[3:]


def _seg_sample(root, i, h, w):
    rs = np.random.RandomState(20 + i)
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    seg = rs.randint(0, 183, (h, w)).astype(np.uint8)
    seg[:h // 3, :w // 4] = 255
    _write_png(os.path.join(root, 'img', f'{i}.png'), img)
    _write_png(os.path.join(root, 'seg', f'{i}.png'), seg)     # grayscale
    x0, y0 = rs.uniform(0, w / 3), rs.uniform(0, h / 3)
    box = np.array([[x0, y0, x0 + w / 2, y0 + h / 2]], np.float32)
    poly = [[x0, y0, x0 + w / 2, y0, x0 + w / 2, y0 + h / 2, x0,
             y0 + h / 2]]
    return dict(img_info=dict(filename=f'{i}.png', height=h, width=w),
                ann_info=dict(bboxes=box, labels=np.array([1]),
                              masks=[poly], seg_map=f'{i}.png'),
                img_prefix=os.path.join(root, 'img'),
                seg_prefix=os.path.join(root, 'seg'),
                bbox_fields=[], mask_fields=[], seg_fields=[])


@pytest.mark.parametrize('pipeline', ['seg', 'crop'])
def test_seg_data_path_matches_jax(tmp_path, pipeline):
    """The stuff-map path from grayscale PNGs, each sample on its own
    seeded generator (one flipped, one not), into one collated batch:
    bit for bit the JAX pipeline's and collate's."""
    os.makedirs(tmp_path / 'img')
    os.makedirs(tmp_path / 'seg')
    steps = SEG_PIPELINE if pipeline == 'seg' else CROP_PIPELINE
    port, ref = Compose(copy.deepcopy(steps)), JaxCompose(copy.deepcopy(
        steps))
    got, want = [], []
    for i, (h, w) in enumerate([(75, 120), (90, 100)]):
        sample = _seg_sample(str(tmp_path), i, h, w)
        # seeds 0 and 2: the first sample unflipped, the second flipped
        got.append(port(dict(copy.deepcopy(sample),
                             _rng=np.random.RandomState(2 * i))))
        want.append(ref(dict(copy.deepcopy(sample),
                             _rng=np.random.RandomState(2 * i))))
    for g, w in zip(got, want):
        assert np.array_equal(g['gt_semantic_seg'], w['gt_semantic_seg'])
        assert g['gt_semantic_seg'].dtype == np.uint8
    assert {g['img_metas']['flip'] for g in got} == {True, False}
    canvas = (128, 160)
    bg = collate_detection(got, canvas)
    bw = jax_collate_detection(want, canvas)
    assert bg['gt_semantic_seg'].shape == (2, 16, 20)
    assert bg['gt_semantic_seg'].dtype == np.uint8
    assert np.array_equal(bg['gt_semantic_seg'], bw['gt_semantic_seg'])
    assert np.array_equal(bg['img'], bw['img'])
    # the canvas beyond each map is ignored, as are the maps' own 255s
    assert (bg['gt_semantic_seg'][:, -1] == 255).all()
    assert (bg['gt_semantic_seg'] < 183).any()


def test_with_seg_reads_channel_zero_of_a_bgr_decode(tmp_path):
    """Divergence kept from the JAX package: the map is decoded as BGR and
    channel 0 taken, so an RGB stuff map yields its blue component, where
    mmdet reads the file unchanged (a grayscale map reads the same
    either way)."""
    rgb = np.zeros((8, 8, 3), np.uint8)
    rgb[..., 0], rgb[..., 1], rgb[..., 2] = 7, 9, 11      # B, G, R for cv2
    _write_png(str(tmp_path / 'rgb.png'), rgb)
    gray = np.full((8, 8), 42, np.uint8)
    _write_png(str(tmp_path / 'gray.png'), gray)
    load = Compose([dict(type='LoadAnnotations', with_bbox=False,
                         with_label=False, with_seg=True)])
    for name, value in (('rgb.png', 7), ('gray.png', 42)):
        out = load(dict(ann_info=dict(seg_map=name),
                        seg_prefix=str(tmp_path)))
        assert out['seg_fields'] == ['gt_semantic_seg']
        assert (out['gt_semantic_seg'] == value).all(), name


# --------------------------------------------------------------- configs
SWEEP = sorted(glob.glob('configs/htc/*.py')
               + glob.glob('configs/hrnet/htc_*.py')
               + ['configs/res2net/htc_r2_101_fpn_20e_coco.py'])
REFUSED = {
    **{p: 'DetectoRS_ResNet' for p in glob.glob('configs/detectors/*htc*.py')},
    **{p: 'SCNet' for p in glob.glob('configs/scnet/*.py')},
}


def test_sweep_lists_the_slice_configs():
    assert len(SWEEP) == 7 + 5 + 1
    assert len(REFUSED) == 3 + len(glob.glob('configs/scnet/*.py'))


@pytest.mark.parametrize('path', SWEEP)
def test_config_builds_where_jax_builds(path):
    cfg = _config(path)
    jax_setup(copy.deepcopy(cfg))
    with torch.device('meta'):
        model = build_detector(cfg)
    assert type(model).__name__ == 'HybridTaskCascade'
    assert model.roi_head.with_semantic == ('without_semantic' not in path)


@pytest.mark.parametrize('path', sorted(REFUSED))
def test_later_slices_refuse_naming_what_they_lack(path):
    with pytest.raises(KeyError, match=REFUSED[path]):
        with torch.device('meta'):
            build_detector(_config(path))
