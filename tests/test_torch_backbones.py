"""The port's ResNet-family backbones (RegNetX, Res2Net, ResNeSt, HRNet) and
the HRFPN neck against the JAX package on the CPU, fp32, on the same
numpy weights, batch statistics and inputs:

- ``generate_regnet`` and the stage widths of every arch string;
- ``RegNet`` (a shrunk arch dict), ``Res2Net`` (its first block of a
  strided stage, ``'stage'``, pooling its last slice), ``ResNeSt`` (radix
  1 and 2), ``HRNet`` (branches 8 / 16 / 32 / 64) and ``HRFPN`` (AVG and
  MAX pooling; its bilinear resize against ``jax.image.resize``): their
  outputs and the gradients of every parameter and of the input;
- the JAX RegNet's fault, which the port keeps: a ``norm_cfg`` (10 of the
  13 configs/regnet files) is a TypeError in both packages;
- ``faster_rcnn_regnetx-3.2GF_fpn_1x`` shrunk (``tiny_cfg``): the
  detector checks below (test_torch_backbone_configs.py runs them on the
  three other configs);
- the six configs of the slice at full width (these four,
  ``faster_rcnn_regnetx-3.2GF_fpn_1x``, ``faster_rcnn_r2_101_fpn_2x``,
  ``faster_rcnn_s50_fpn_syncbn-backbone+head_mstrain-range_1x``,
  ``mask_rcnn_hrnetv2p_w32_1x``, and the plugins' two): the parameter
  names and shapes against ``state_dict_from_jax`` of the JAX init's.

The detector checks (``simple_test``, ``forward_train``'s losses and every
gradient with the same sampler keys and proposals, the weights' round trip
through the JAX converter) are defined here and run on the other three
configs shrunk in test_torch_backbone_configs.py and on the plugins' two
in test_torch_plugins.py. Tolerances are test_torch_resnet.py's:
module outputs at 1e-5 of their largest entry, module gradients at 1e-4;
detections with labels equal, boxes within 1e-3 px and scores and mask
probabilities within 1e-4; losses at rel 1e-4, detector gradients at 1e-3
of each tensor's largest entry; each detector limit or twice what the JAX
package's own output moves by under fp32 noise of 1e-7 where that is more,
as test_torch_zoo.py takes them.
"""
import copy
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.checkpoint import (convert_torch_state_dict,
                                    default_flatten_hints)
from swindet_tpu.core.bbox import samplers as jax_samplers
from swindet_tpu.core.bbox.samplers import RandomSampler as JaxSampler
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.models.backbones import hrnet as jax_hrnet
from swindet_tpu.models.backbones import regnet as jax_regnet
from swindet_tpu.models.backbones import res2net as jax_res2net
from swindet_tpu.models.backbones import resnest as jax_resnest
from swindet_tpu.models.necks.hrfpn import HRFPN as JaxHRFPN

from tests.test_torch_cascade import _draw_stats, numpy_params_from
from tests.test_torch_checkpoint import numpy_params
from tests.test_torch_dcn import _perturbed
from tests.test_torch_train import make_batch, sampler_keys
from tests.test_torch_zoo import _det_errors, _fc_cls_leaves, _test_inputs

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.backbones import hrnet, regnet, res2net, resnest
from swindet_tpu_torch.models.necks.hrfpn import HRFPN, resize_bilinear
from swindet_tpu_torch.utils.config import Config

TOL_MODULE = 1e-5
TOL_MODULE_GRAD = 1e-4
TOL_LOSS = 1e-4
TOL_GRAD = 1e-3
# the most that twice the JAX package's own move under 1e-7 noise may
# raise a detector gradient's limit to: a leaf whose gradient moves more
# than that under fp32 noise is too ill-conditioned to hold the port to
NOISE_CAP = 0.1
H, W = 64, 96


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# parameters whose gradient is zero in exact arithmetic: a softmax takes no
# gradient from a constant added to all its logits. ContextBlock's
# conv_mask bias shifts every pixel's logit alike; GeneralizedAttention's
# geometry FC biases add, for each query, one constant to all its keys'
# energies. Both packages give them rounding noise, held below
# TOL_INVARIANT of the largest gradient entry.
INVARIANT = ('conv_mask.bias', 'appr_geom_fc_x.bias', 'appr_geom_fc_y.bias')
TOL_INVARIANT = 1e-5


def check_invariant(grads, scale):
    """Each INVARIANT gradient of ``grads`` (name -> tensor or None) within
    TOL_INVARIANT of ``scale``; returns the names checked."""
    names = [n for n in grads if n.endswith(INVARIANT)]
    for n in names:
        g = grads[n]
        assert g is None or float(g.abs().max()) <= TOL_INVARIANT * scale, n
    return names


def jit_o0(fn):
    """``jax.jit(fn)`` compiled with XLA:CPU's LLVM backend at optimization
    level 0, for the JAX references of these tests. At the default level,
    XLA:CPU computes the gradient of the JAX ResNeSt's radix-2 stages 2%
    off: layer2.1.bn3.bias -14.58 where the eager gradient, the one
    compiled at level 0 and the port's read -14.91 (to 2e-7), on the
    module test's weights and input."""
    jitted, compiled = jax.jit(fn), {}

    def run(*args):
        key = (jax.tree.structure(args),
               tuple(np.shape(a) for a in jax.tree.leaves(args)))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={'xla_backend_optimization_level': 0})
        return compiled[key](*args)
    return run


# --------------------------------------------------------------- modules
def check_module(jm, port, x, sd_of=state_dict_from_jax, seed=0):
    """``jm`` (JAX) and ``port`` on the same numpy weights (every leaf
    drawn, zero-init ones included) and running statistics and on ``x``:
    the outputs at TOL_MODULE, the gradients of a random projection of
    them, for every parameter and for the input, at TOL_MODULE_GRAD.
    ``sd_of`` maps the JAX trees to the port's state_dict. Returns the
    JAX parameters."""
    shapes = jax.eval_shape(lambda k: jm.init(k, x), jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], seed + 1)
    stats = _draw_stats(shapes['batch_stats'], seed + 2) \
        if 'batch_stats' in shapes else None
    port.load_state_dict(sd_of(params, stats), strict=True)

    def variables(p):
        return {'params': p, **({'batch_stats': stats} if stats else {})}

    def outs(p, x):
        o = jm.apply(variables(p), x)
        return tuple(o) if isinstance(o, (tuple, list)) else (o,)
    want = jit_o0(outs)(params, x)
    rs = np.random.RandomState(seed + 3)
    gs = [rs.randn(*o.shape).astype(np.float32) for o in want]
    gp, gx = jit_o0(jax.grad(lambda p, x: sum(
        jnp.sum(o * g) for o, g in zip(outs(p, x), gs)),
        argnums=(0, 1)))(params, x)
    want_grads = sd_of(jax.tree.map(np.asarray, gp), None)
    xt = [T(a).requires_grad_(True) for a in x] if isinstance(x, list) \
        else T(x).requires_grad_(True)
    got = port.train()(xt)
    got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a, b) <= TOL_MODULE
    sum((o * T(g)).sum() for o, g in zip(got, gs)).backward()
    listed = isinstance(x, list)
    for a, b in zip(xt if listed else [xt], gx if listed else [gx]):
        assert _rel(a.grad, b) <= TOL_MODULE_GRAD
    scale = max(float(w.abs().max()) for w in want_grads.values())
    params_ = dict(port.named_parameters())
    invariant = check_invariant(want_grads, scale) + check_invariant(
        {n: p.grad for n, p in params_.items()}, scale)
    for name, p in params_.items():
        if name in invariant:
            continue
        w = want_grads[name]
        assert p.grad is not None and w.abs().max() > 0, name
        assert _rel(p.grad, w) <= TOL_MODULE_GRAD, (name, _rel(p.grad, w))
    return params


@pytest.mark.parametrize('arch', list(jax_regnet.ARCH_SETTINGS))
def test_regnet_widths_match_jax(arch):
    """Every arch string's block widths, stage widths, blocks and group
    widths, as the JAX RegNet derives them."""
    a = regnet.ARCH_SETTINGS[arch]
    assert a == jax_regnet.ARCH_SETTINGS[arch]
    args = (a['w0'], a['wa'], a['wm'], a['depth'])
    assert regnet.generate_regnet(*args) == jax_regnet.generate_regnet(*args)
    widths, n = jax_regnet.generate_regnet(*args)
    sw, sb = jax_regnet.stages_from_blocks(widths)
    want = jax_regnet.adjust_width_group(sw, [a['bot_mul']] * n,
                                         [a['group_w']] * n)
    got = regnet.regnet_stages(arch)
    assert (got[0], got[2]) == want and got[1] == sb and len(sb) == 4


# four stages of widths 16, 24, 32, 56 in groups of 8, 1, 1, 2, 2 blocks
TINY_REGNET = dict(w0=16, wa=8, wm=1.5, group_w=8, depth=6, bot_mul=1.0)
TINY_HRNET = dict(
    stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                num_blocks=(1,), num_channels=(16,)),
    stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                num_blocks=(1, 1), num_channels=(8, 16)),
    stage3=dict(num_modules=1, num_branches=3, block='BASIC',
                num_blocks=(1, 1, 1), num_channels=(8, 16, 32)),
    stage4=dict(num_modules=1, num_branches=4, block='BASIC',
                num_blocks=(1, 1, 1, 1), num_channels=(8, 16, 32, 64)))
BACKBONES = {
    'regnet': (jax_regnet.RegNet, regnet.RegNet,
               dict(arch=TINY_REGNET, stem_channels=16)),
    'res2net': (jax_res2net.Res2Net, res2net.Res2Net,
                dict(depth=50, base_channels=16, base_width=8, scales=4,
                     num_stages=2, out_indices=(0, 1))),
    'resnest-r2': (jax_resnest.ResNeSt, resnest.ResNeSt,
                   dict(base_channels=16, stem_channels=16, radix=2,
                        num_stages=2, out_indices=(0, 1))),
    'resnest-r1': (jax_resnest.ResNeSt, resnest.ResNeSt,
                   dict(base_channels=16, stem_channels=16, radix=1,
                        num_stages=2, out_indices=(0, 1))),
    'hrnet': (jax_hrnet.HRNet, hrnet.HRNet, dict(extra=TINY_HRNET)),
}


@pytest.mark.parametrize('name', list(BACKBONES))
def test_backbone_matches_jax(name):
    """Outputs and every gradient, on an input whose size is a multiple of
    32 (the pipeline's pad) but not of 64."""
    jax_cls, port_cls, kw = BACKBONES[name]
    x = np.random.RandomState(4).randn(2, 96, 160, 3).astype(np.float32)
    port = port_cls(**kw)
    check_module(jax_cls(**kw), port, x)
    if name == 'res2net':
        block = port.layer2[0]
        assert block.stage_type == 'stage' and block.stride == 2
    if name == 'hrnet':
        assert [o.shape[-1] for o in port(T(x))] == [8, 16, 32, 64]


def test_hrnet_names_follow_mmdet():
    """The fuse and transition Sequentials under mmdet's indices."""
    sd = hrnet.HRNet(extra=TINY_HRNET).state_dict()
    for key in ('transition1.0.0.weight', 'transition1.1.0.0.weight',
                'transition2.2.0.1.running_var',
                'stage3.0.fuse_layers.0.2.0.weight',
                'stage3.0.fuse_layers.2.0.1.1.bias',
                'stage4.0.branches.3.0.conv2.weight'):
        assert key in sd, key
    assert not any(k.startswith('transition2.0.') for k in sd)


@pytest.mark.parametrize('pooling', ['AVG', 'MAX'])
def test_hrfpn_matches_jax(pooling):
    rs = np.random.RandomState(5)
    xs = [rs.randn(2, 24 // 2 ** i, 40 // 2 ** i, c).astype(np.float32)
          for i, c in enumerate((8, 16, 32, 64))]
    kw = dict(in_channels=(8, 16, 32, 64), out_channels=16,
              pooling_type=pooling)

    def sd_of(params, stats):
        return {k[len('neck.'):]: v for k, v in state_dict_from_jax(
            {'_neck': params}).items()}
    port = HRFPN(**kw)
    check_module(JaxHRFPN(**kw), port, xs, sd_of=sd_of)
    assert not any(c.use_kernel for c in port.fpn_convs)


def test_hrfpn_bilinear_equals_jax_resize():
    """Upsampling by 2, 4 and 8 (integer factors): F.interpolate with
    align_corners=False equals jax.image.resize('bilinear') to fp32
    rounding."""
    x = np.random.RandomState(6).randn(2, 5, 7, 3).astype(np.float32)
    for f in (2, 4, 8):
        want = jax.image.resize(x, (2, 5 * f, 7 * f, 3), 'bilinear')
        got = resize_bilinear(T(x), (5 * f, 7 * f))
        assert _rel(got, want) <= 1e-6, f


def test_regnet_norm_cfg_is_a_type_error():
    """configs/regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py sets the
    backbone's norm_cfg, which the JAX RegNet does not take (nor dcn, the
    mdconv file's): it fails to build there, and the port, which takes the
    JAX RegNet's arguments, refuses it alike."""
    cfg = _plain(Config.fromfile(
        'configs/regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py').model)
    assert 'norm_cfg' in cfg['backbone']
    with pytest.raises(TypeError, match='norm_cfg'):
        jax_build_detector(copy.deepcopy(cfg)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
            method='forward_dummy')
    with pytest.raises(TypeError, match='norm_cfg'):
        build_detector(copy.deepcopy(cfg))


# chip_smoke.py's proposal check lets the card's proposals of near-tied
# scores (ResNeSt's seeded RPN has hundreds) take each other's slots, but
# only one to one: each plain box once
_A, _B, _C = [0., 0., 10., 10.], [5., 5., 20., 20.], [1., 1., 3., 3.]


@pytest.mark.parametrize('card, swapped', [
    ([_A, _B, _C], 0),      # the plain order
    ([_B, _A, _C], 2),      # the tied pair swapped
    ([_A, _A, _C], None),   # B lost and A doubled
    ([_C, _B, _A], None),   # A and C swapped, their scores not tied
])
def test_proposal_check_matches_tied_slots_one_to_one(card, swapped):
    from chip_smoke import _swapped_slots

    def proposals(boxes):
        return (torch.tensor([boxes]), torch.tensor([[.9, .9, .5]]),
                torch.ones(1, 3, dtype=torch.bool))
    want = proposals([_A, _B, _C])
    assert _swapped_slots(want, proposals(card), want[2]) == swapped


def test_proposal_check_matching_is_maximal():
    """_max_matching against every assignment of small random graphs."""
    import itertools
    from chip_smoke import _max_matching
    rs = np.random.RandomState(0)
    for _ in range(200):
        n = rs.randint(1, 6)
        fits = rs.rand(n, n) < 0.4
        best = max(sum(bool(fits[i, p[i]]) for i in range(n))
                   for p in itertools.permutations(range(n)))
        assert _max_matching(torch.from_numpy(fits)) == best, fits


# ------------------------------------------------------------- detectors
def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def full_cfg(path):
    cfg = _plain(Config.fromfile(path).model)
    cfg.pop('pretrained', None)
    return cfg


def shrink_heads(cfg, neck_in):
    """The neck (from ``neck_in`` channels) and heads at 32 channels, 4
    classes, samplers of 64 and 32, 128 / 64 proposals, 16 detections."""
    cfg['neck'].update(in_channels=list(neck_in), out_channels=32)
    cfg['rpn_head'].update(in_channels=32, feat_channels=32)
    roi = cfg['roi_head']
    roi['bbox_roi_extractor']['out_channels'] = 32
    roi['bbox_head'].update(in_channels=32, fc_out_channels=64,
                            num_classes=4)
    if roi.get('mask_head'):
        roi['mask_roi_extractor']['out_channels'] = 32
        roi['mask_head'].update(in_channels=32, conv_out_channels=32,
                                num_classes=4)
    train, test = cfg['train_cfg'], cfg['test_cfg']
    train['rpn']['sampler']['num'] = 64
    train['rpn_proposal'].update(nms_pre=128, max_per_img=64)
    train['rcnn']['sampler']['num'] = 32
    test['rpn'].update(nms_pre=128, max_per_img=64)
    test['rcnn']['max_per_img'] = 16
    return cfg


def jax_readable(sd, params):
    """The port's mmdet-keyed state_dict under the names and shapes the JAX
    converter reads (``swindet_tpu/checkpoint.py:45-48, :365``). That
    converter follows the JAX module names, so it reads none of mmdet's
    names for a plugin, the Res2Net stem and ``bns``, an avg-down
    shortcut, the split-attention norms, an HRNet branch, fuse or
    transition, or HRFPN's ConvModules, and it takes ContextBlock's
    LayerNorm and GeneralizedAttention's biases in the JAX shapes (those of
    ``params``). Each such key is renamed here; the converter then must
    read every tensor."""
    from swindet_tpu.checkpoint import _flatten
    from swindet_tpu.checkpoint import flax_path_to_torch_key as jax_key
    jax_shapes = {jax_key(p): np.shape(v)
                  for p, v in _flatten(params).items()}
    res2net_stem = any('.bns.' in k for k in sd)
    avg_down = {m.group(1) for k in sd for m in [re.match(
        r'^(.*\.layer\d+\.\d+)\.(bns\.0|conv2\.bn0)\.', k)] if m}
    hrfpn = 'neck.reduction_conv.conv.weight' in sd

    def seq(kind):
        # the JAX converter folds a BN's '.bn.' away
        return ('.conv.', '.')[int(kind)]
    out = {}
    for k, v in sd.items():
        k = re.sub(r'\.(context_block|gen_attention_block)\.', '.plugin0.', k)
        if res2net_stem:
            k = re.sub(r'^backbone\.stem\.(\d)\.', lambda m: 'backbone.stem'
                       + ('', '_bn')[int(m.group(1)) % 3]
                       + f'{int(m.group(1)) // 3}.', k)
        k = re.sub(r'\.bns\.(\d+)\.', r'.bns\1.', k)
        m = re.match(r'^(.*\.layer\d+\.\d+)\.downsample\.(\d)\.(.*)$', k)
        if m and m.group(1) in avg_down:
            k = f'{m.group(1)}.downsample.{int(m.group(2)) - 1}.{m.group(3)}'
        k = re.sub(r'\.conv2\.bn([01])\.', r'.conv2.norm\1.', k)
        k = re.sub(r'\.branches\.(\d+)\.(\d+)\.', r'.branches\1.\2.', k)
        k = re.sub(r'\.fuse_layers\.(\d+)\.(\d+)\.(\d+)\.([01])\.',
                   lambda m: f'.fuse{m.group(1)}.{m.group(2)}.down'
                   f'{m.group(3)}{seq(m.group(4))}', k)
        k = re.sub(r'\.fuse_layers\.(\d+)\.(\d+)\.([01])\.',
                   lambda m: f'.fuse{m.group(1)}.{m.group(2)}'
                   f'{seq(m.group(3))}', k)
        k = re.sub(r'\.transition(\d+)\.(\d+)\.(?:0\.)?([01])\.',
                   lambda m: f'.transition{m.group(1)}.{m.group(2)}'
                   f'{seq(m.group(3))}', k)
        if hrfpn and k.startswith('neck.'):
            k = k.replace('.conv.', '.')
        if re.search(r'\.plugin0\.(channel_(add|mul)_conv\.1\.|appr_bias$|'
                     r'geom_bias$)', k):
            v = v.reshape(jax_shapes[k])
        out[k] = v
    return out


class _ClampedTake:
    """jax.numpy with ``take`` clamping out-of-range indices."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def take(a, indices, axis=None, **kw):
        return jnp.take(a, indices, axis=axis, mode='clip')


def detector_case(cfg):
    """A shrunk config's JAX detector, numpy params (rpn_cls and fc_cls
    drawn with std 1, so that no top-k or NMS boundary sits within fp32
    noise; every other leaf, zero-init plugin ones included, drawn as
    numpy_params draws) and batch statistics, and the port's detector on
    them (eval mode)."""
    jm = jax_build_detector(copy.deepcopy(cfg))
    params = numpy_params(jm, 0, method='forward_dummy')
    rs = np.random.RandomState(100)
    for leaf in [params['_rpn_head']['rpn_cls']] + _fc_cls_leaves(params):
        leaf['kernel'] = rs.randn(*leaf['kernel'].shape).astype(np.float32)
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    stats = _draw_stats(shapes.get('batch_stats', {}), 200)
    sd = state_dict_from_jax(params, stats)
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(sd, strict=True)
    return dict(cfg=cfg, jm=jm, params=params, stats=stats, sd=sd,
                port=port.eval())


def check_round_trip(case):
    """state_dict_from_jax, then (through jax_readable) the JAX package's
    convert_torch_state_dict: the parameters and batch statistics back bit
    for bit, no key missing or left over."""
    new_params, new_stats, report = convert_torch_state_dict(
        jax_readable(case['sd'], case['params']), case['params'],
        batch_stats=case['stats'],
        flatten_hints=default_flatten_hints(case['cfg']))
    assert not report['missing'] and not report['unexpected'], report
    for a, b in ((new_params, case['params']), (new_stats, case['stats'])):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb)
        assert all(np.array_equal(np.asarray(u), v) for u, v in zip(la, lb))


def check_simple_test(case):
    """simple_test: detections equal (validity and labels), boxes within
    1e-3 px, scores and mask probabilities within 1e-4, each or within
    twice what the JAX package's own output moves by under fp32 noise of
    1e-7 in the input or the weights, where that is more."""
    port = case['port']
    img, shapes, sf = _test_inputs()
    variables = {'params': case['params'], 'batch_stats': case['stats']}
    run = jit_o0(lambda v, *a: case['jm'].apply(v, *a,
                                                method='simple_test'))
    want = jax.tree.map(np.asarray, run(variables, img, shapes, sf))
    v = want['det_valid']
    noise = dict(box=0.0, score=0.0, mask=0.0)
    for seed in (3, 4):
        moved = jax.tree.map(np.asarray, run(
            _perturbed(variables, seed) if seed == 4 else variables,
            _perturbed(img, seed) if seed == 3 else img, shapes, sf))
        assert np.array_equal(moved['det_valid'], v)
        for k, d in _det_errors(moved, want, v).items():
            noise[k] = max(noise[k], d)
    with torch.no_grad():
        got = {k: t.numpy() for k, t in port.simple_test(
            T(img), T(shapes), T(sf)).items()}
    assert set(got) == set(want)
    assert np.array_equal(got['det_valid'], v) and v.sum() >= 8
    assert np.array_equal(got['labels'][v], want['labels'][v])
    errs = _det_errors(got, want, v)
    for k, tol in (('box', 1e-3), ('score', 1e-4), ('mask', 1e-4)):
        if k in errs:
            assert errs[k] <= max(tol, 2 * noise[k]), (k, errs[k], noise[k])


def check_forward_train(case, frozen=('backbone.conv1.', 'backbone.bn1.',
                                      'backbone.stem.', 'backbone.layer1.')):
    """forward_train on both sides with the same batch, sampler keys and
    proposals (the JAX run's): losses at rel 1e-4 and every gradient at
    1e-3 of its largest entry, or twice what the JAX package's own moves
    by under fp32 noise of 1e-7 in the weights and image, where that is
    more, up to NOISE_CAP (a noise limit above it fails); none in the
    parameters under ``frozen``, where the config freezes them. Prints the
    gradients held to the noise limit, each with its reading and limit.
    Returns the port model."""
    cfg, jm = case['cfg'], case['jm']
    batch = make_batch()
    if not cfg['roi_head'].get('mask_head'):
        del batch['gt_masks']
    gen = cfg['rpn_head']['anchor_generator']
    per = len(gen['scales']) * len(gen['ratios'])
    with torch.no_grad():
        feats = case['port'].extract_feat(T(batch['img']))
    n_rpn = per * sum(f.shape[1] * f.shape[2] for f in feats)
    n_rcnn = 3 + cfg['train_cfg']['rpn_proposal']['max_per_img']
    keys = sampler_keys(n_rpn, n_rcnn)
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxSampler, '_pos_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][0]))
    mp.setattr(JaxSampler, '_neg_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][1]))
    # the JAX sampler gives its empty slots out-of-range indices meant to
    # clamp ("gathers clamp", swindet_tpu/core/bbox/samplers.py:155), but
    # jnp.take fills them with NaN: the empty slots' boxes are NaN, masked
    # in the forward, and where the mask branch has empty positive slots
    # (the gcb config here) RoIAlign's backward passes 0 x NaN into the
    # features' gradient. Clamped, as meant, the reference's forward is
    # the same and its gradient finite.
    mp.setattr(jax_samplers, 'jnp', _ClampedTake())
    names = ['img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
             'gt_labels'] + (['gt_masks'] if 'gt_masks' in batch else [])
    try:
        args = [jnp.asarray(batch[k]) for k in names]

        def total(p, args):
            losses, state = jm.apply(
                {'params': p, 'batch_stats': case['stats']}, *args,
                method='forward_train',
                rngs={'sampling': jax.random.PRNGKey(1)},
                mutable=['batch_stats', 'intermediates'],
                capture_intermediates=lambda mdl, name:
                    name == 'get_proposals')
            loss, log_vars = jax_parse_losses(losses)
            props = state['intermediates']['_rpn_head']['get_proposals'][0]
            return loss, (log_vars, props)
        value_and_grad = jit_o0(jax.value_and_grad(total, has_aux=True))
        (_, (want, props)), grads = value_and_grad(case['params'], args)
        moved = value_and_grad(_perturbed(case['params'], 5),
                               [_perturbed(args[0], 6)] + args[1:])[1]
    finally:
        mp.undo()
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(case['sd'], strict=True)
    port.train()
    tb = {k: T(v) for k, v in batch.items()}
    tkeys = {part: [tuple(T(k) for k in keys[n])] * 2
             for part, n in (('rpn', n_rpn), ('rcnn', n_rcnn))}
    pinned = tuple(T(np.asarray(a)) for a in props)
    port.rpn_head.get_proposals = lambda *a, **kw: pinned
    losses = port.forward_train(*[tb[k] for k in names],
                                sampler_keys=tkeys)
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    want = {k: float(v) for k, v in want.items() if k != 'loss'}
    got = {k: float(v.detach()) for k, v in losses.items()}
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.isfinite(v), k
        assert abs(v - want[k]) <= TOL_LOSS * max(abs(want[k]), 1e-6), \
            (k, v, want[k])
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    moved_grads = state_dict_from_jax(jax.tree.map(np.asarray, moved))
    checked, noisy = 0, []
    freezes = cfg['backbone'].get('frozen_stages', -1) >= 1 \
        and cfg['backbone']['type'] != 'HRNet'
    scale = max(float(w.abs().max()) for w in want_grads.values())
    params_ = dict(port.named_parameters())
    invariant = check_invariant(want_grads, scale) + check_invariant(
        {n: p.grad for n, p in params_.items()}, scale)
    for name, p in params_.items():
        if name in invariant:
            continue
        w = want_grads[name]
        if freezes and name.startswith(frozen):
            assert p.grad is None and not w.abs().max(), name
            continue
        assert p.grad is not None, name
        if w.abs().max() > 0:
            noise = 2 * _rel(moved_grads[name], w)
            assert noise <= NOISE_CAP, (name, 'noise limit', noise)
            err = _rel(p.grad, w)
            if noise > TOL_GRAD:
                noisy.append(f'{name} {err:.3g} (limit {noise:.3g})')
            assert err <= max(TOL_GRAD, noise), (name, err, noise)
            checked += 1
    print(f'{len(noisy)} of {checked} gradients held to the noise limit: '
          + ', '.join(noisy))
    assert checked > 40
    return port


def check_full_width_names(cfg):
    """At full width, every parameter and buffer of the port's detector
    (built on the meta device) has the name and shape that
    state_dict_from_jax gives the JAX init's shapes, part by part."""
    jm = jax_build_detector(copy.deepcopy(cfg))
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    with torch.device('meta'):
        port = build_detector(copy.deepcopy(cfg))
    own = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    keys = set()
    for part, tree in shapes['params'].items():
        sd = state_dict_from_jax(
            {part: jax.tree.map(
                lambda s: np.broadcast_to(np.float32(0), s.shape), tree)},
            {part: jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                shapes.get('batch_stats', {}).get(part, {}))})
        for k, v in sd.items():
            assert own.get(k) == tuple(v.shape), (k, own.get(k), v.shape)
        keys |= set(sd)
    assert keys == set(own)
    return port


CONFIGS = {
    'regnet': 'configs/regnet/faster_rcnn_regnetx-3.2GF_fpn_1x_coco.py',
    'res2net': 'configs/res2net/faster_rcnn_r2_101_fpn_2x_coco.py',
    'resnest': 'configs/resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_'
               'mstrain-range_1x_coco.py',
    'hrnet': 'configs/hrnet/mask_rcnn_hrnetv2p_w32_1x_coco.py',
}


def tiny_cfg(name):
    """The config's model with its backbone shrunk as the module tests
    shrink it (the Res2Net at depth 50, it and the ResNeSt cut to their
    first two stages, the FPN on those two) and shrink_heads' neck and
    heads; every module type and option
    as configured. (The JAX package's XLA compiles, of a few seconds per
    block, set the test's time.)"""
    cfg = full_cfg(CONFIGS[name])
    bb = cfg['backbone']
    if name == 'regnet':
        bb.update(arch=TINY_REGNET, stem_channels=16)
        neck_in = regnet.regnet_stages(TINY_REGNET)[0]
    elif name == 'res2net':
        bb.update(depth=50, base_channels=16, base_width=8, num_stages=2,
                  out_indices=(0, 1))
        neck_in = (64, 128)
    elif name == 'resnest':
        bb.update(base_channels=16, stem_channels=16, num_stages=2,
                  out_indices=(0, 1))
        neck_in = (64, 128)
    else:
        bb['extra'] = copy.deepcopy(TINY_HRNET)
        neck_in = (8, 16, 32, 64)
    return shrink_heads(cfg, neck_in)


# the plugins' configs (test_torch_plugins.py)
PLUGIN_CONFIGS = {
    'gcb': 'configs/gcnet/mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x_coco.py',
    'attn': 'configs/empirical_attention/'
            'faster_rcnn_r50_fpn_attention_1111_1x_coco.py',
}


@pytest.mark.parametrize('name', list(CONFIGS) + list(PLUGIN_CONFIGS))
def test_config_full_width_names_and_shapes(name):
    """The six configs at full width."""
    port = check_full_width_names(full_cfg({**CONFIGS,
                                            **PLUGIN_CONFIGS}[name]))
    if name in PLUGIN_CONFIGS:
        assert any('.context_block.' in k or '.gen_attention_block.' in k
                   for k in port.state_dict())


@pytest.fixture(scope='module')
def regnet_case():
    return detector_case(tiny_cfg('regnet'))


def test_regnet_config_simple_test_matches_jax(regnet_case):
    check_simple_test(regnet_case)
    assert type(regnet_case['port'].backbone).__name__ == 'RegNet'


def test_regnet_config_forward_train_matches_jax(regnet_case):
    check_forward_train(regnet_case)


def test_regnet_config_weights_round_trip_bit_exact(regnet_case):
    check_round_trip(regnet_case)
