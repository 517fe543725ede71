"""Cascade Mask R-CNN in the port against the JAX package on the CPU, fp32,
on the same numpy weights, batch statistics and sampler keys: the norm
layers and ``ConvModule`` with a norm, ``SmoothL1Loss`` and ``GIoULoss``,
the 4conv1fc bbox head with GIoU on decoded boxes, and a tiny Cascade
Mask R-CNN (Swin depths [1, 1, 1, 1], narrow widths, the Swin-B config's
head types: three 4conv1fc heads with SyncBN, GIoU x10, class-specific
deltas, per-stage stds) through ``simple_test``, ``bbox_test`` /
``mask_test``, ``aug_test_two_stage``, ``forward_train`` and one
``make_train_step`` step, and its weights through
``state_dict_from_jax(params, batch_stats)``.

Tolerances: module outputs at 1e-5 relative to the largest entry;
detections with labels equal, boxes within 1e-3 px and scores and mask
probabilities within 1e-4; losses at rel 1e-4 and gradients at rel 1e-3
of each tensor's largest entry (the test_torch_train.py limits); the
updated BN running statistics within 2e-6 of their largest entry, a limit
that an update from the unbiased variance (the factor n / (n - 1) at
n = 2 x 32 slots x 49 bins) and a wrong momentum both exceed, as the test
shows on the JAX side's own numbers.

Sampler keys: the JAX samplers' ``_pos_keys`` / ``_neg_keys`` are
patched to return numpy arrays keyed by the candidate count (the RPN's
anchors; G + P at stage 0; G + num at stages 1 and 2), which the port
takes per stage through ``sampler_keys['rcnn']``.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.apis import aug_test as jax_aug_test
from swindet_tpu.apis.inference import DetectorHandle
from swindet_tpu.core.bbox.samplers import RandomSampler as JaxSampler
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.models.builder import build_head as jax_build_head
from swindet_tpu.models.builder import build_loss as jax_build_loss
from swindet_tpu.models.layers import ConvModule as JaxConvModule
from swindet_tpu.models.layers import build_norm as jax_build_norm
from swindet_tpu.utils import Config as JaxConfig

from tests.test_models.test_cascade import tiny_cascade_cfg
from tests.test_torch_checkpoint import numpy_params
from tests.test_torch_train import make_batch
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.apis.aug_test import aug_test_two_stage
from swindet_tpu_torch.checkpoint import (resume, save_checkpoint,
                                          state_dict_from_jax)
from swindet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                      make_train_step)
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.builder import build_head, build_loss
from swindet_tpu_torch.models.detectors import CascadeRCNN
from swindet_tpu_torch.models.layers import ConvModule, Norm, build_norm

cap_torch_threads()

H, W = 64, 96
TOL_MODULE = 1e-5
TOL_LOSS = 1e-4
TOL_GRAD = 1e-3
TOL_STATS = 2e-6
GRAD_PARAMS = (
    'backbone.layers.0.blocks.0.attn.qkv.weight',
    'neck.fpn_convs.0.conv.weight',
    'rpn_head.rpn_conv.weight',
    'roi_head.bbox_head.0.shared_convs.0.conv.weight',
    'roi_head.bbox_head.0.fc_cls.weight',
    'roi_head.bbox_head.1.shared_fcs.0.weight',
    'roi_head.bbox_head.2.shared_convs.0.conv.weight',
    'roi_head.bbox_head.2.shared_convs.0.bn.weight',
    'roi_head.bbox_head.2.shared_convs.3.bn.bias',
    'roi_head.bbox_head.2.fc_reg.weight',
    'roi_head.mask_head.1.convs.0.conv.weight',
)


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _stage_head(stds):
    return dict(
        type='ConvFCBBoxHead', num_shared_convs=4, num_shared_fcs=1,
        in_channels=16, conv_out_channels=16, fc_out_channels=32,
        roi_feat_size=7, num_classes=4,
        bbox_coder=dict(type='DeltaXYWHBBoxCoder',
                        target_means=[0., 0., 0., 0.], target_stds=stds),
        reg_class_agnostic=False, reg_decoded_bbox=True,
        norm_cfg=dict(type='SyncBN', requires_grad=True),
        loss_cls=dict(type='CrossEntropyLoss', use_sigmoid=False,
                      loss_weight=1.0),
        loss_bbox=dict(type='GIoULoss', loss_weight=10.0))


def cascade_cfg():
    """The JAX package's tiny cascade with the Swin-B config's heads and
    per-stage train settings (match_low_quality off, IoU 0.5 / 0.6 /
    0.7)."""
    cfg = copy.deepcopy(tiny_cascade_cfg())
    cfg['roi_head']['bbox_head'] = [
        _stage_head([0.1, 0.1, 0.2, 0.2]),
        _stage_head([0.05, 0.05, 0.1, 0.1]),
        _stage_head([0.033, 0.033, 0.067, 0.067])]
    return cfg


def _draw_stats(shapes, seed):
    """Running statistics: means N(0, 0.1^2), variances 0.5 + U(0, 1)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: (0.1 * rs.randn(*leaf.shape) if path[-1].key
                            == 'mean' else 0.5 + rs.rand(*leaf.shape))
        .astype(np.float32), shapes)


def cascade_params(cfg, seed=0):
    """The JAX detector, numpy params (rpn_cls and every stage's fc_cls
    drawn with std 1, so no top-k or NMS boundary sits within fp32 noise)
    and batch statistics."""
    jm = jax_build_detector(cfg)
    params = numpy_params(jm, seed, method='forward_dummy')
    rs = np.random.RandomState(seed + 100)
    heads = params['_roi_head']
    for leaf in [params['_rpn_head']['rpn_cls']] + [
            heads[f'_bbox_head{i}']['fc_cls'] for i in range(3)]:
        leaf['kernel'] = rs.randn(*leaf['kernel'].shape).astype(np.float32)
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    return jm, params, _draw_stats(shapes['batch_stats'], seed + 200)


# ----------------------------------------------------------------- norms
NORM_CASES = {
    'bn-train': (dict(type='BN'), True),
    'bn-eval': (dict(type='BN'), False),
    'syncbn-train': (dict(type='SyncBN', momentum=0.03), True),
    'gn': (dict(type='GN', num_groups=4), True),
    'ln': (dict(type='LN'), True),
}


def _jax_norm_vars(kind, c, rs):
    inner = {'bn': 'BatchNorm_0', 'gn': 'GroupNorm_0', 'ln': 'LayerNorm_0'}
    params = {inner[kind]: {
        'scale': (1 + 0.1 * rs.randn(c)).astype(np.float32),
        'bias': (0.1 * rs.randn(c)).astype(np.float32)}}
    stats = {inner[kind]: {'mean': (0.1 * rs.randn(c)).astype(np.float32),
                           'var': (0.5 + rs.rand(c)).astype(np.float32)}} \
        if kind == 'bn' else {}
    return params, stats


def _check_stats(got, want, old, n, momentum):
    """The port's updated running stats against the JAX side's, and the
    limit against an unbiased-variance update and a momentum of 1 - m."""
    err = _rel(got, want)
    assert err <= TOL_STATS, err
    var_b = (want - (1 - momentum) * old) / momentum
    unbiased = (1 - momentum) * old + momentum * var_b * n / (n - 1)
    swapped = momentum * old + (1 - momentum) * var_b
    assert _rel(unbiased, want) > TOL_STATS
    assert _rel(swapped, want) > TOL_STATS


@pytest.mark.parametrize('case', list(NORM_CASES))
def test_norm_matches_jax(case):
    """Norm against the JAX package's build_norm, and in train mode the
    running statistics it leaves."""
    norm_cfg, train = NORM_CASES[case]
    rs = np.random.RandomState(1)
    x = (2.0 + 3.0 * rs.randn(4, 5, 6, 16)).astype(np.float32)
    name, port = build_norm(norm_cfg, 16)
    params, stats = _jax_norm_vars(name, 16, rs)
    jm = jax_build_norm(norm_cfg, name='norm')
    variables = {'params': params}
    if stats:
        variables['batch_stats'] = stats
    want, state = jm.apply(variables, jnp.asarray(x), train=train,
                           mutable=['batch_stats'])
    sd = state_dict_from_jax({'norm': params},
                             {'norm': stats} if stats else None)
    port.load_state_dict({k.split('.', 1)[1]: v for k, v in sd.items()},
                         strict=True)
    port.train(train)
    got = port(T(x))
    assert name == {'BN': 'bn', 'SyncBN': 'bn', 'GN': 'gn',
                    'LN': 'ln'}[norm_cfg['type']]
    assert got.dtype == torch.float32
    assert _rel(got.detach(), want) <= TOL_MODULE
    if name != 'bn':
        return
    m = norm_cfg.get('momentum', 0.1)
    new = state['batch_stats']['BatchNorm_0']
    if train:
        _check_stats(port.running_var.numpy(), np.asarray(new['var']),
                     stats['BatchNorm_0']['var'], 4 * 5 * 6, m)
        assert _rel(port.running_mean.numpy(), new['mean']) <= TOL_STATS
        assert int(port.num_batches_tracked) == 1
    else:
        assert np.array_equal(port.running_var.numpy(),
                              stats['BatchNorm_0']['var'])
        assert int(port.num_batches_tracked) == 0


@pytest.mark.parametrize('norm', ['BN', 'GN', None])
@pytest.mark.parametrize('train', [True, False])
def test_conv_module_with_norm_matches_jax(norm, train):
    """conv -> norm (fp32) -> cast -> ReLU against the JAX ConvModule; a
    norm drops the conv's bias (bias='auto'), and a normed conv never
    takes the conv3x3 kernel."""
    norm_cfg = None if norm is None else dict(
        type=norm, **({'num_groups': 4} if norm == 'GN' else {}))
    rs = np.random.RandomState(2)
    x = rs.randn(3, 7, 7, 16).astype(np.float32)
    jm = JaxConvModule(16, 3, padding=1, norm_cfg=norm_cfg,
                       act_cfg=dict(type='ReLU'))
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    rs2 = np.random.RandomState(4)
    params = jax.tree.map(lambda a: (a + 0.1 * rs2.randn(*a.shape))
                          .astype(np.float32), variables['params'])
    stats = _draw_stats(variables.get('batch_stats', {}), 5)
    want, _ = jm.apply({'params': params, 'batch_stats': stats},
                       jnp.asarray(x), train=train, mutable=['batch_stats'])
    port = ConvModule(16, 16, 3, padding=1, norm_cfg=norm_cfg,
                      act_cfg=dict(type='ReLU'))
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    port.train(train)
    assert (port.conv.bias is None) == (norm is not None)
    assert not port.use_kernel  # 16 channels
    assert ConvModule(128, 128, 3, padding=1, norm_cfg=norm_cfg)\
        .use_kernel == (norm is None)
    assert _rel(port(T(x)).detach(), want) <= TOL_MODULE


def test_bf16_conv_module_casts_after_the_norm():
    """bf16: the conv and the ReLU in bf16, the norm in fp32 between."""
    port = ConvModule(16, 16, 3, padding=1, norm_cfg=dict(type='SyncBN'),
                      act_cfg=dict(type='ReLU'), dtype='bfloat16')
    port.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 7, 7, 16, generator=torch.Generator().manual_seed(1))
    out = port.train()(x)
    assert out.dtype == torch.bfloat16 and (out >= 0).all()
    conv = port.conv
    y = torch.nn.functional.conv2d(
        x.bfloat16().permute(0, 3, 1, 2), conv.weight.bfloat16(),
        padding=1).permute(0, 2, 3, 1)
    port.bn.running_mean.zero_()
    port.bn.running_var.fill_(1.0)
    port.eval()
    assert torch.equal(port(x), torch.relu(port.bn(y).bfloat16()))


# ---------------------------------------------------------------- losses
def _boxes(rs, n):
    xy = rs.uniform(0, 50, (n, 2))
    return np.concatenate([xy, xy + rs.uniform(0.5, 30, (n, 2))], 1)


def _loss_inputs():
    rs = np.random.RandomState(6)
    pred, target = _boxes(rs, 40), _boxes(rs, 40)
    pred[:8] = target[:8] + rs.uniform(-2, 2, (8, 4))  # overlapping
    pred[8:12] = target[8:12] + 200.0                  # disjoint
    pred[12, 2:] = pred[12, :2]                        # degenerate: a point
    pred[13, 2] = pred[13, 0]                          # zero width
    target[14] = pred[14]                              # identical
    pred[15, :2], pred[15, 2:] = pred[15, 2:], pred[15, :2].copy()  # reversed
    weight = (rs.rand(40, 4) > 0.3).astype(np.float32)
    return [a.astype(np.float32) for a in (pred, target, weight)]


@pytest.mark.parametrize('cfg', [
    dict(type='SmoothL1Loss', beta=1.0 / 9.0, loss_weight=1.0),
    dict(type='SmoothL1Loss', beta=1.0, loss_weight=2.0, reduction='sum'),
    dict(type='GIoULoss', loss_weight=10.0),
    dict(type='GIoULoss', eps=1e-6, reduction='none')])
@pytest.mark.parametrize('weighted', [False, True])
def test_box_losses_match_jax(cfg, weighted):
    pred, target, weight = _loss_inputs()
    kw = dict(weight=weight, avg_factor=17.0) if weighted else {}
    want = jax_build_loss(dict(cfg))(
        jnp.asarray(pred), jnp.asarray(target),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    pred_t = T(pred).requires_grad_()
    got = build_loss(dict(cfg))(pred_t, T(target),
                                **{k: torch.as_tensor(v)
                                   for k, v in kw.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    got.sum().backward()
    assert torch.isfinite(pred_t.grad).all()


# ------------------------------------------------------------- bbox head
def test_shared4conv1fc_head_matches_jax():
    """Shared4Conv1FCBBoxHead (SyncBN, GIoU on decoded boxes, class-specific
    deltas) against the JAX ConvFCBBoxHead(num_shared_convs=4): forward in
    train and eval mode, the updated running stats, targets, loss,
    regress_by_class and decode_for_test."""
    head_cfg = dict(_stage_head([0.1, 0.1, 0.2, 0.2]),
                    type='Shared4Conv1FCBBoxHead')
    head_cfg.pop('num_shared_convs')
    head_cfg.pop('num_shared_fcs')
    jax_cfg = dict(_stage_head([0.1, 0.1, 0.2, 0.2]))
    rs = np.random.RandomState(8)
    r = 24
    x = rs.randn(r, 7, 7, 16).astype(np.float32)
    jm = jax_build_head(jax_cfg)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x)),
                            jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 9)
    stats = _draw_stats(shapes['batch_stats'], 10)
    port = build_head(head_cfg)
    sd = state_dict_from_jax({'_bbox_head0': params},
                             {'_bbox_head0': stats})
    port.load_state_dict({k.split('.', 2)[2]: v for k, v in sd.items()},
                         strict=True)
    assert len(port.shared_convs) == 4 and len(port.shared_fcs) == 1
    variables = {'params': params, 'batch_stats': stats}
    apply = jax.jit(lambda v, x, train: jm.apply(
        v, x, train=train, mutable=['batch_stats']), static_argnums=2)
    for train in (False, True):
        (cls_w, reg_w), state = apply(variables, jnp.asarray(x), train)
        cls_g, reg_g = port.train(train)(T(x))
        assert _rel(cls_g.detach(), cls_w) <= TOL_MODULE
        assert _rel(reg_g.detach(), reg_w) <= TOL_MODULE
    for i in range(4):
        new = state['batch_stats'][f'shared_convs{i}']['norm']['BatchNorm_0']
        bn = port.shared_convs[i].bn
        _check_stats(bn.running_var.numpy(), np.asarray(new['var']),
                     stats[f'shared_convs{i}']['norm']['BatchNorm_0']['var'],
                     r * 49, 0.1)

    xy = rs.uniform(0, 60, (r, 2))
    rois = np.concatenate([np.zeros((r, 1)), xy,
                           xy + rs.uniform(4, 40, (r, 2))], 1) \
        .astype(np.float32)
    labels = rs.randint(0, 5, r).astype(np.int32)
    label_weights = (rs.rand(r) > 0.2).astype(np.float32)
    pos = (labels < 4) & (label_weights > 0)
    targets = np.where(pos[:, None], rois[:, 1:] + rs.uniform(
        -3, 3, (r, 4)), 0.0).astype(np.float32)
    bbox_weights = np.repeat(pos[:, None], 4, 1).astype(np.float32)
    args = (rois, labels, label_weights, targets, bbox_weights)
    want = jm.apply(variables, cls_w, reg_w, *map(jnp.asarray, args),
                    method='loss')
    got = port.loss(cls_g, reg_g, *map(T, args))
    assert set(got) == set(want) == {'loss_cls', 'acc', 'loss_bbox'}
    for k in want:
        assert abs(float(got[k]) - float(want[k])) \
            <= TOL_LOSS * abs(float(want[k])), k
    shape = np.array([[70, 90]] * r, np.float32)
    want = jm.apply(variables, jnp.asarray(rois), jnp.asarray(labels),
                    reg_w, (jnp.asarray(shape[:, :1]),
                            jnp.asarray(shape[:, 1:])),
                    method='regress_by_class')
    got = port.regress_by_class(T(rois), T(labels).long(), reg_g.detach(),
                                T(shape))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    want, _ = jm.apply(variables, jnp.asarray(rois[None]), reg_w[None],
                       jnp.asarray([70.0, 90.0]), method='decode_for_test')
    got = port.decode_for_test(T(rois[None]), reg_g.detach()[None],
                               T([[70.0, 90.0]]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def numpy_params_from(shapes, seed):
    """numpy_params' draws on a shape tree."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == 'scale':
            v = 1.0 + 0.1 * rs.randn(*shape)
        else:
            v = 0.02 * rs.randn(*shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


# ------------------------------------------------------- tiny cascade
@pytest.fixture(scope='module')
def cascade():
    """The JAX detector and variables, and the port's CascadeRCNN on the
    same weights and batch statistics (eval mode)."""
    cfg = cascade_cfg()
    jm, params, stats = cascade_params(cfg)
    sd = state_dict_from_jax(params, stats)
    port = build_detector(cfg)
    port.load_state_dict(sd, strict=True)
    port.eval()
    return dict(cfg=cfg, jm=jm, variables={'params': params,
                                           'batch_stats': stats},
                sd=sd, port=port)


def _test_inputs(b=2, seed=11):
    rs = np.random.RandomState(seed)
    img = rs.randn(b, H, W, 3).astype(np.float32)
    shapes = np.array([[H, W], [H - 8, W - 16]][:b], np.int32)
    sf = np.array([[1.0] * 4, [0.8] * 4][:b], np.float32)
    return img, shapes, sf


def _buffers(model):
    return {k: v.clone() for k, v in model.named_buffers()
            if 'running' in k or 'num_batches' in k}


def _port_simple_test(model, img, shapes, sf):
    with torch.no_grad():
        out = model.simple_test(T(img), T(shapes), T(sf))
    return {k: v.numpy() for k, v in out.items()}


def _detection_errors(got, want):
    """None where validity or labels differ, else the box, score and mask
    probability max |d| over the valid detections."""
    if not (np.array_equal(got['det_valid'], want['det_valid'])
            and np.array_equal(got['labels'][want['det_valid']],
                               want['labels'][want['det_valid']])):
        return None
    v = want['det_valid']
    return (float(np.abs(got['dets'][v][:, :4] - want['dets'][v][:, :4])
                  .max()),
            float(np.abs(got['dets'][v][:, 4] - want['dets'][v][:, 4]).max()),
            float(np.abs(got['mask_probs'][v] - want['mask_probs'][v]).max()))


def _within(errs):
    return errs is not None and errs[0] <= 1e-3 and errs[1] <= 1e-4 \
        and errs[2] <= 1e-4


@pytest.fixture(scope='module')
def simple_test_run(cascade):
    img, shapes, sf = _test_inputs()
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, *a: cascade['jm'].apply(v, *a, method='simple_test'))(
        cascade['variables'], img, shapes, sf))
    return img, shapes, sf, want


def test_cascade_weights_load_strictly(cascade):
    """state_dict_from_jax(params, batch_stats) holds every key of the
    port's CascadeRCNN, mmdet-named, BN buffers included."""
    port, sd = cascade['port'], cascade['sd']
    assert isinstance(port, CascadeRCNN)
    assert set(sd) == set(port.state_dict())
    for key in ('roi_head.bbox_head.0.shared_convs.0.bn.running_mean',
                'roi_head.bbox_head.2.shared_convs.3.bn.num_batches_tracked',
                'roi_head.bbox_head.1.shared_fcs.0.weight',
                'roi_head.mask_head.2.convs.0.conv.weight'):
        assert key in sd, key
    assert int(sd['roi_head.bbox_head.0.shared_convs.0.bn'
                  '.num_batches_tracked']) == 0
    assert sum(isinstance(m, Norm) for m in port.modules()) == 12


def test_cascade_simple_test_matches_jax(cascade, simple_test_run):
    """Detections and mask probabilities of simple_test equal the JAX
    package's; eval mode leaves the running statistics alone."""
    img, shapes, sf, want = simple_test_run
    before = _buffers(cascade['port'])
    got = _port_simple_test(cascade['port'], img, shapes, sf)
    errs = _detection_errors(got, want)
    assert int(want['det_valid'].sum()) >= 8
    assert _within(errs), errs
    after = _buffers(cascade['port'])
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_unpermuted_first_fc_fails_the_check(cascade, simple_test_run):
    """Control: the stages' first FCs loaded as JAX reads its inputs (HWC)
    instead of permuted to mmdet's CHW: the check above must fail."""
    img, shapes, sf, want = simple_test_run
    sd = dict(cascade['sd'])
    heads = cascade['variables']['params']['_roi_head']
    for i in range(3):
        sd[f'roi_head.bbox_head.{i}.shared_fcs.0.weight'] = T(
            heads[f'_bbox_head{i}']['shared_fcs0']['kernel'].T.copy())
    port = build_detector(cascade['cfg'])
    port.load_state_dict(sd, strict=True)
    errs = _detection_errors(_port_simple_test(port.eval(), img, shapes, sf),
                             want)
    assert not _within(errs), errs


@pytest.fixture(scope='module')
def jax_handle(cascade):
    """The JAX detector's handle, whose test-time augmentation keeps its
    jitted halves."""
    return DetectorHandle(JaxConfig(dict(model=cascade['cfg'])),
                          cascade['jm'], cascade['variables'])


def test_cascade_aug_test_matches_jax(cascade, jax_handle):
    """aug_test_two_stage with two augmentations, the image and its flip,
    against the JAX package's."""
    img, shapes, sf = _test_inputs()
    augs = [dict(img=img, img_shapes=shapes, scale_factors=sf, flip=False),
            dict(img=img[:, :, ::-1].copy(), img_shapes=shapes,
                 scale_factors=sf, flip=True, flip_direction='horizontal')]
    want = jax.tree.map(np.asarray, jax_aug_test.aug_test_two_stage(
        jax_handle, augs))
    with torch.no_grad():
        got = aug_test_two_stage(cascade['port'], [
            {k: T(v) if isinstance(v, np.ndarray) else v
             for k, v in ab.items()} for ab in augs])
    errs = _detection_errors({k: v.numpy() for k, v in got.items()}, want)
    assert int(want['det_valid'].sum()) >= 8
    assert _within(errs), errs


def _port_forward_train(port, tb, tkeys, proposals=None):
    """The port's forward_train; with ``proposals`` its proposal step
    returns them in place of its own."""
    if proposals is not None:
        port.rpn_head.get_proposals = lambda *a, **kw: proposals
    try:
        return port.forward_train(
            tb['img'], tb['img_shapes'], tb['pad_shapes'], tb['gt_bboxes'],
            tb['gt_valid'], tb['gt_labels'], tb['gt_masks'],
            sampler_keys=tkeys)
    finally:
        port.rpn_head.__dict__.pop('get_proposals', None)


def test_cascade_bbox_and_mask_test_match_jax(cascade, jax_handle):
    """The per-augmentation halves on given proposals and boxes, through
    the JAX package's jitted halves of the test above: stage-averaged
    scores, the last stage's boxes, stage-averaged mask probabilities."""
    img, shapes, _ = _test_inputs()
    rs = np.random.RandomState(12)
    p = cascade['cfg']['test_cfg']['rpn']['max_per_img']
    m = cascade['cfg']['test_cfg']['rcnn']['max_per_img']
    xy = rs.uniform(0, 50, (2, p, 2))
    props = np.concatenate([xy, xy + rs.uniform(6, 40, (2, p, 2))], -1) \
        .astype(np.float32)
    labels = rs.randint(0, 4, (2, m)).astype(np.int32)
    jitted, v = jax_handle._jitted, cascade['variables']
    want_s, want_b = jitted['aug_bbox'](v, img, props, shapes)
    want_m = jitted['aug_mask'](v, img, props[:, :m], labels)
    port = cascade['port']
    with torch.no_grad():
        got_s, got_b = port.aug_bbox_test(T(img), T(props), T(shapes))
        got_m = port.aug_mask_test(T(img), T(props[:, :m]),
                                   T(labels).long())
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_b, want_b, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=1e-4)


@pytest.fixture(scope='module')
def train_run(cascade):
    """forward_train on both sides, same weights, statistics, batch and
    sampler keys: losses, gradients and the updated batch statistics.

    The proposals differ between the two frameworks by up to ~4e-4 px
    (the RPN's fp32 deltas through exp), which moves the 4conv heads'
    roi features by ~2e-5 of their largest entry, and the weight
    gradients behind their four BNs move by ~1e-2 under such noise (a
    random perturbation of that size does the same in float64). So, as
    chip_smoke.py's card-vs-CPU check does, the port's proposal step
    returns the JAX run's proposals for the losses, gradients and
    statistics; the port's own proposals and unpinned losses are held
    apart."""
    cfg = cascade['cfg']
    batch = make_batch(g=3)
    g = batch['gt_bboxes'].shape[1]
    n_rpn = 3 * sum(-(-H // s) * -(-W // s) for s in (4, 8, 16, 32, 64))
    num = cfg['train_cfg']['rcnn'][0]['sampler']['num']
    n_stage = [g + cfg['train_cfg']['rpn_proposal']['max_per_img'],
               g + num, g + num]
    rs = np.random.RandomState(5)
    keys = {n: (rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32))
            for n in sorted({n_rpn, *n_stage})}
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxSampler, '_pos_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][0]))
    mp.setattr(JaxSampler, '_neg_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][1]))
    jm, variables = cascade['jm'], cascade['variables']
    try:
        args = [jnp.asarray(batch[k]) for k in (
            'img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
            'gt_labels', 'gt_masks')]

        def total(p):
            losses, state = jm.apply(
                {'params': p, 'batch_stats': variables['batch_stats']},
                *args, method='forward_train',
                rngs={'sampling': jax.random.PRNGKey(1),
                      'dropout': jax.random.PRNGKey(2)},
                mutable=['batch_stats', 'intermediates'],
                capture_intermediates=lambda mdl, name:
                    name == 'get_proposals')
            loss, log_vars = jax_parse_losses(losses)
            props = state['intermediates']['_rpn_head']['get_proposals'][0]
            return loss, (log_vars, state['batch_stats'], props)

        (_, (want, new_stats, props)), grads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(variables['params'])
    finally:
        mp.undo()
    props = tuple(T(np.asarray(t)) for t in props)
    tb = {k: T(v) for k, v in batch.items()}
    tkeys = dict(rpn=[tuple(T(k) for k in keys[n_rpn])] * 2,
                 rcnn=[[tuple(T(k) for k in keys[n])] * 2 for n in n_stage])
    own = build_detector(cfg)
    own.load_state_dict(cascade['sd'], strict=True)
    own.train()
    with torch.no_grad():
        unpinned = _port_forward_train(own, tb, tkeys)
        feats = own.extract_feat(tb['img'])
        own_props = own.rpn_head.get_proposals(
            *own.rpn_head(feats), tb['img_shapes'],
            dict(cfg['train_cfg']['rpn_proposal']))
    port = build_detector(cfg)
    port.load_state_dict(cascade['sd'], strict=True)
    port.train()
    losses = _port_forward_train(port, tb, tkeys, props)
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    return dict(
        want={k: float(v) for k, v in want.items()},
        got={k: float(v.detach()) for k, v in losses.items()},
        unpinned={k: float(v) for k, v in unpinned.items()},
        props=props, own_props=own_props,
        want_grads=state_dict_from_jax(jax.tree.map(np.asarray, grads)),
        got_grads=dict(port.named_parameters()),
        want_stats=state_dict_from_jax({}, jax.tree.map(np.asarray,
                                                        new_stats)),
        port=port, batch=tb, old_stats=cascade['sd'], n=2 * num * 49)


@pytest.mark.parametrize('pinned', [True, False])
def test_cascade_forward_train_losses_match_jax(train_run, pinned):
    """Every stage's losses and accuracy, with the JAX run's proposals and
    with the port's own, which lie within 1e-3 px of them."""
    want = train_run['want']
    got = train_run['got' if pinned else 'unpinned']
    names = {f's{i}.{k}' for i in range(3)
             for k in ('loss_cls', 'loss_bbox', 'loss_mask', 'acc')}
    assert names <= set(got) and set(want) - {'loss'} == set(got)
    for k, v in got.items():
        assert np.isfinite(v), k
        assert abs(v - want[k]) <= TOL_LOSS * max(abs(want[k]), 1e-6), \
            (k, v, want[k])
    if not pinned:
        (jb, _, jv), (pb, _, pv) = train_run['props'], \
            train_run['own_props']
        assert torch.equal(jv, pv) and int(jv.sum()) > 0
        assert float((jb - pb).abs()[jv].max()) <= 1e-3


@pytest.mark.parametrize('name', GRAD_PARAMS)
def test_cascade_forward_train_grads_match_jax(train_run, name):
    want = train_run['want_grads'][name].numpy()
    got = train_run['got_grads'][name].grad
    assert got is not None and np.abs(want).max() > 0
    assert _rel(got, want) <= TOL_GRAD, _rel(got, want)


def test_cascade_forward_train_updates_running_stats_as_jax(train_run):
    """Every bbox head's BN running statistics after one training
    forward, against the JAX package's updated batch_stats; the limit
    fails an unbiased-variance update and a swapped momentum."""
    want, port = train_run['want_stats'], train_run['port']
    bufs = dict(port.named_buffers())
    names = [k for k in want if k.endswith('running_var')]
    assert len(names) == 12
    for k in names:
        _check_stats(bufs[k].numpy(), want[k].numpy(),
                     train_run['old_stats'][k].numpy(), train_run['n'], 0.1)
        mean = k.replace('running_var', 'running_mean')
        assert _rel(bufs[mean], want[mean]) <= TOL_STATS
        assert int(bufs[k.replace('running_var', 'num_batches_tracked')]) \
            == 1


def test_cascade_train_step_moves_params_and_stats(cascade, tmp_path):
    """One make_train_step step with the Swin config's AdamW groups moves
    the parameters and the BN buffers; a checkpoint resumes them
    exactly."""
    port = build_detector(cascade['cfg'])
    port.load_state_dict(cascade['sd'], strict=True)
    opt_cfg = dict(
        type='AdamW', lr=1e-4, betas=(0.9, 0.999), weight_decay=0.05,
        paramwise_cfg=dict(custom_keys=dict(
            norm=dict(decay_mult=0.0),
            relative_position_bias_table=dict(decay_mult=0.0))))
    opt = build_optimizer(port, opt_cfg)
    no_decay = [n for g in opt.param_groups if g['weight_decay'] == 0
                for n in g['names']]
    assert not any('.bn.' in n for n in no_decay)
    step = make_train_step(port, opt, build_lr_schedule(
        dict(policy='step', step=[8, 11]), 1e-4, 10))
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    batch = {k: T(v) for k, v in make_batch(g=3).items()}
    log = step(batch, torch.Generator().manual_seed(0))
    assert all(np.isfinite(v) for v in log.values())
    after = port.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    for i in range(3):
        for j in range(4):
            pre = f'roi_head.bbox_head.{i}.shared_convs.{j}'
            assert {f'{pre}.conv.weight', f'{pre}.bn.weight',
                    f'{pre}.bn.running_mean', f'{pre}.bn.running_var',
                    f'{pre}.bn.num_batches_tracked'} <= set(moved), pre
    path = str(tmp_path / 'step.pth')
    save_checkpoint(path, port, opt, meta=dict(iter=1))
    back = build_detector(cascade['cfg'])
    assert resume(path, back, build_optimizer(back, opt_cfg))['iter'] == 1
    assert all(torch.equal(v, back.state_dict()[k])
               for k, v in port.state_dict().items())
