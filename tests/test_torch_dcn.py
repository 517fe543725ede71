"""The port's ResNet variants and their modules against the JAX package on
the CPU, fp32, on the same numpy weights and inputs:

- ``DeformConv2d`` with a DCNv2 mask (deform groups 1 and 4, stride 1 and
  2) and ``ModulatedDeformConvPack`` (DCNv2 and DCNv1), outputs and
  gradients;
- ResNet-50s with DCN and DCNv2 bottlenecks, and with GN and ConvWS,
  outputs and gradients under ``frozen_stages=1``;
- ``WSConv2d`` and ``ConvModule`` with ``conv_cfg`` (ConvWS with GN, DCN,
  DCNv2);
- the ``ResLayer`` shared head;
- ``multilevel_deform_roi_pool`` and ``DeformRoIExtractor`` (DeformRoIPool
  and ModulatedDeformRoIPool packs, with non-zero output layers so that
  the offsets and masks act), outputs and gradients.

Each place where the JAX package departs from mmcv, and the port with
it, is shown by building mmcv's form by hand: the DCNv2 offset/mask split,
ConvWS's population std, the ResLayer's style, the mask head's conv_cfg,
the TPU ConvModule dispatch that does not look at conv_cfg, and the JAX
converter's missing gn{i} rule for a GN ResNet.

Tolerances are test_torch_resnet.py's: module outputs at 1e-5 of their
largest entry, module gradients at 1e-4 of theirs; the ResNets' at twice
what the JAX package's own result moves by under fp32 noise of 1e-7 in the
input or weights where that is more (the GN + ConvWS ResNet-50's deeper
stages).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.checkpoint import convert_torch_state_dict
from swindet_tpu.models.backbones.resnet import ResNet as JaxResNet
from swindet_tpu.models.layers import ConvModule as JaxConvModule
from swindet_tpu.models.layers import WSConv as JaxWSConv
from swindet_tpu.models.roi_heads.mask_heads import FCNMaskHead as JaxMaskHead
from swindet_tpu.models.roi_heads.roi_extractor import \
    SingleRoIExtractor as JaxExtractor
from swindet_tpu.models.roi_heads.shared_heads import ResLayer as JaxResLayer
from swindet_tpu.ops.deform_conv import DeformConv2d as JaxDeformConv2d
from swindet_tpu.ops.deform_conv import \
    ModulatedDeformConvPack as JaxPack
from swindet_tpu.ops.deform_roi_pool import \
    multilevel_deform_roi_pool as jax_deform_roi_pool

from tests.test_torch_cascade import _draw_stats, numpy_params_from
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.models.backbones.resnet import Bottleneck, ResNet
from swindet_tpu_torch.models.layers import ConvModule, WSConv2d
from swindet_tpu_torch.models.roi_heads.mask_heads import FCNMaskHead
from swindet_tpu_torch.models.roi_heads.roi_extractor import (
    DeformRoIExtractor, SingleRoIExtractor)
from swindet_tpu_torch.models.roi_heads.shared_heads import ResLayer
from swindet_tpu_torch.ops.deform_conv import (DeformConv2d,
                                               ModulatedDeformConvPack)
from swindet_tpu_torch.ops.deform_roi_pool import multilevel_deform_roi_pool

cap_torch_threads()

TOL_MODULE = 1e-5
TOL_MODULE_GRAD = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _perturbed(tree, seed):
    """Every array of ``tree`` times 1 + N(0, 1e-7^2): fp32 rounding noise."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a * (1 + 1e-7 * rs.randn(*np.shape(a))))
                        .astype(np.float32), tree)


def _init(module, *inputs, seed=0, **kw):
    """numpy params (and batch statistics) of a JAX module on inputs."""
    shapes = jax.eval_shape(lambda k: module.init(k, *inputs, **kw),
                            jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], seed)
    stats = _draw_stats(shapes['batch_stats'], seed + 1) \
        if 'batch_stats' in shapes else None
    return params, stats


def _vjp(module, variables, inputs, g, **kw):
    """The JAX module's output and the gradients of sum(out * g) in its
    inputs and params."""
    def f(p, *xs):
        return module.apply(dict(variables, params=p), *xs, **kw)
    out, vjp = jax.vjp(f, variables['params'], *inputs)
    return out, vjp(g)


def _run(fn, *args):
    """fn jitted, its results as numpy."""
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def _port_grads(port, inputs, g, **kw):
    xs = [T(x).requires_grad_() for x in inputs]
    out = port(*xs, **kw)
    (out * T(g)).sum().backward()
    return out, [x.grad for x in xs]


# ------------------------------------------------------ deformable conv
def _deform_inputs(stride, dg, seed=0):
    rs = np.random.RandomState(seed)
    b, h, w, c, f = 2, 7, 9, 8, 6
    ho, wo = -(-h // stride), -(-w // stride)
    x = rs.randn(b, h, w, c).astype(np.float32)
    off = rs.uniform(-2.3, 2.3, (b, ho, wo, dg * 18)).astype(np.float32)
    mask = (2.0 * rs.randn(b, ho, wo, dg * 9)).astype(np.float32)
    w_ = (0.2 * rs.randn(9, c, f)).astype(np.float32)
    g = rs.randn(b, ho, wo, f).astype(np.float32)
    return x, off, mask, w_, g


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('dg', [1, 4])
def test_modulated_deform_conv_matches_jax(stride, dg):
    """DeformConv2d with a mask (DCNv2) against the JAX DeformConv2d: the
    output and the gradients of x, the offsets, the mask logits and the
    weight."""
    x, off, mask, w, g = _deform_inputs(stride, dg)
    jm = JaxDeformConv2d(w.shape[-1], (3, 3), stride=stride,
                         deform_groups=dg)
    want, (dp, dx, doff, dmask) = _run(lambda *a: _vjp(
        jm, {'params': {'weight': a[0]}}, a[1:4], a[4]), w, x, off, mask, g)
    port = DeformConv2d(x.shape[-1], w.shape[-1], 3, stride=stride,
                        deform_groups=dg)
    port.load_state_dict({'weight': state_dict_from_jax(
        {'c': {'weight': w}})['c.weight']})
    got, (gx, goff, gmask) = _port_grads(port, (x, off, mask), g)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL_MODULE
    for a, b in ((gx, dx), (goff, doff), (gmask, dmask)):
        assert _rel(a, b) <= TOL_MODULE_GRAD
    want_dw = state_dict_from_jax({'c': {'weight': dp['weight']}})['c.weight']
    assert _rel(port.weight.grad, want_dw) <= TOL_MODULE_GRAD
    # the mask acts: without it the output moves far past the bound
    assert _rel(port(T(x), T(off)), want) > 100 * TOL_MODULE


def _pack(modulated, stride=1, dg=2, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 9, 11, 8).astype(np.float32)
    jm = JaxPack(6, 3, stride=stride, deform_groups=dg, modulated=modulated)
    params, _ = _init(jm, x, seed=seed + 1)
    # offsets of a few cells, so that the taps cross cells and borders
    off = params['conv_offset']
    off['kernel'] = off['kernel'] * 4.0
    port = ModulatedDeformConvPack(8, 6, 3, stride=stride, deform_groups=dg,
                                   modulated=modulated)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, port, x


@pytest.mark.parametrize('modulated', [True, False])
def test_deform_conv_pack_matches_jax(modulated):
    """ModulatedDeformConvPack (DCNv2) and its DCNv1 form against the JAX
    pack: mmcv's state_dict names, the output and the gradients of x and
    of every parameter, the offset conv's included."""
    jm, params, port, x = _pack(modulated, stride=2)
    assert set(port.state_dict()) == {'weight', 'bias', 'conv_offset.weight',
                                      'conv_offset.bias'}
    assert port.conv_offset.out_channels == 2 * (3 if modulated else 2) * 9
    out_shape = jax.eval_shape(lambda: jm.apply({'params': params}, x)).shape
    g = np.random.RandomState(9).randn(*out_shape).astype(np.float32)
    want, (dp, dx) = _run(lambda p, x_, g_: _vjp(
        jm, {'params': p}, (x_,), g_), params, x, g)
    got, (gx,) = _port_grads(port, (x,), g)
    assert _rel(got, want) <= TOL_MODULE
    assert _rel(gx, dx) <= TOL_MODULE_GRAD
    want_sd = state_dict_from_jax(dp)
    for name, p in port.named_parameters():
        assert _rel(p.grad, want_sd[name]) <= TOL_MODULE_GRAD, name


def test_dcnv2_split_departs_from_mmcv():
    """The pack reads each tap's (dy, dx) and mask logit from the offset
    conv's output reshaped to (dg, 3, K), as the JAX package does. mmcv
    chunks it into thirds (o1, o2, mask) and reads tap t's (dy, dx) from
    channels 2t, 2t + 1 of cat(o1, o2): built here by hand on the same
    weights, it gives another output."""
    _, _, port, x = _pack(True, dg=1)
    with torch.no_grad():
        got = port(T(x))
        off = torch.nn.functional.conv2d(
            T(x).permute(0, 3, 1, 2), port.conv_offset.weight,
            port.conv_offset.bias, padding=1).permute(0, 2, 3, 1)
        o1, o2, mask = off.chunk(3, dim=-1)
        mmcv = DeformConv2d.forward(port, T(x), torch.cat([o1, o2], -1),
                                    mask)
        ours = off.reshape(*off.shape[:3], 3, 9)
        same = DeformConv2d.forward(
            port, T(x), ours[..., :2, :].transpose(-1, -2).flatten(3),
            ours[..., 2, :])
    assert _rel(same, got) == 0.0
    assert _rel(mmcv, got) > 1e-2


# --------------------------------------------------------------- ResNet
RESNET_VARIANTS = {
    'dcn': dict(dcn=dict(type='DCN', deform_groups=1,
                         fallback_on_stride=False),
                stage_with_dcn=(False, True, True, True)),
    'dcnv2-g2': dict(dcn=dict(type='DCNv2', deform_groups=2,
                              fallback_on_stride=False),
                     stage_with_dcn=(False, True, False, True)),
    # with these weights the GN + ConvWS ResNet-50 carries fp32 noise of
    # 1e-7 in its input (or weights) to 1.0e-6, 3.8e-6, 9.7e-6 and 3.1e-5
    # (6.0e-5) of the largest entry of its four outputs in the JAX package
    # itself (its zero-mean filters cancel most of their input), past the
    # 1e-5 bound from the third on; the DCN ResNets' four stay under 8e-7
    'gn-ws': dict(norm_cfg=dict(type='GN', num_groups=4, requires_grad=True),
                  conv_cfg=dict(type='ConvWS')),
}


def _resnet(case, seed=0):
    kw = dict(depth=50, base_channels=8, out_indices=(0, 1, 2, 3),
              frozen_stages=1)
    kw.update(RESNET_VARIANTS[case])
    jm = JaxResNet(**kw)
    x = np.random.RandomState(seed).randn(2, 45, 61, 3).astype(np.float32)
    params, stats = _init(jm, x, seed=seed + 1)
    gn = case == 'gn-ws'
    port = ResNet(**kw)
    port.load_state_dict(state_dict_from_jax(params, stats, resnet_gn=gn),
                         strict=True)
    return jm, params, stats, port, x


@pytest.mark.parametrize('case', list(RESNET_VARIANTS))
def test_resnet_variant_matches_jax(case):
    """A DCN, a DCNv2 (2 deform groups) and a GN + ConvWS ResNet-50 in
    training mode with frozen_stages=1: the four outputs, and the
    gradients of every parameter (none in the stem and layer1), each at
    its bound or at twice what the JAX package's own result moves by under
    fp32 noise of 1e-7 in the input or in the weights, where that is
    more."""
    jm, params, stats, port, x = _resnet(case)
    variables = {'params': params, **({'batch_stats': stats} if stats
                                      else {})}
    outs = jax.eval_shape(lambda: jm.apply(variables, x, train=True))
    rs = np.random.RandomState(3)
    gs = [rs.randn(*o.shape).astype(np.float32) for o in outs]

    def total(p, x_):
        o = jm.apply(dict(variables, params=p), x_, train=True)
        return sum(jnp.sum(a * b) for a, b in zip(o, gs)), o
    run = jax.jit(jax.value_and_grad(total, has_aux=True))
    gn = case == 'gn-ws'

    def result(p, x_):
        (_, o), grads = run(p, x_)
        return o, state_dict_from_jax(jax.tree.map(np.asarray, grads),
                                      resnet_gn=gn)
    want, want_grads = result(params, x)
    moved = [result(params, _perturbed(x, 3)),
             result(_perturbed(params, 4), x)]
    port.train()
    got = port(T(x))
    sum((o * T(g)).sum() for o, g in zip(got, gs)).backward()
    assert len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(got, want)):
        limit = max([TOL_MODULE] + [2 * _rel(m[0][i], b) for m in moved])
        assert _rel(a, b) <= limit, (i, _rel(a, b), limit)
    names = dict(port.named_parameters())
    if case.startswith('dcn'):
        assert isinstance(port.layer2[0].conv2, ModulatedDeformConvPack)
        assert 'layer4.2.conv2.conv_offset.weight' in names
    else:
        assert 'layer2.0.gn2.weight' in names and 'gn1.weight' in names
    checked = 0
    for name, p in names.items():
        if name.startswith(('conv1.', 'bn1.', 'gn1.', 'layer1.')):
            assert p.grad is None and not want_grads[name].abs().max(), name
            continue
        w = want_grads[name]
        limit = max([TOL_MODULE_GRAD] + [2 * _rel(m[1][name], w)
                                         for m in moved])
        assert _rel(p.grad, w) <= limit, (name, _rel(p.grad, w), limit)
        checked += 1
    assert checked > 20


@pytest.mark.parametrize('case', list(RESNET_VARIANTS))
def test_resnet_variant_weights_round_trip(case):
    """state_dict_from_jax then the JAX converter, bit for bit: for the
    DCN ResNets as they are (mmcv's conv2.weight and conv2.conv_offset.*);
    for GN, only after renaming gn{i} to bn{i}: the JAX converter maps a
    ResNet's norms by the JAX names (bn1 ... whatever the norm) and has no
    gn{i} rule (swindet_tpu/checkpoint.py:79 renames ConvModule norms
    only), so mmdet's names leave them missing."""
    _, params, stats, port, _ = _resnet(case)
    gn = case == 'gn-ws'
    sd = state_dict_from_jax(params, stats, resnet_gn=gn)
    assert set(sd) == set(port.state_dict())
    if gn:
        _, report = convert_torch_state_dict(sd, params)
        assert any(k.endswith('.bn2.weight') for k in report['missing'])
        sd = {k.replace('.gn', '.bn') if k.startswith('layer')
              else k.replace('gn1.', 'bn1.'): v for k, v in sd.items()}
    back = convert_torch_state_dict(sd, params, batch_stats=stats)
    report = back[-1]
    assert not report['missing'] and not report['unexpected']
    pairs = [(back[0], params)] + ([(back[1], stats)] if stats else [])
    for a, b in pairs:
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb)
        assert all(np.array_equal(np.asarray(u), v) for u, v in zip(la, lb))


# --------------------------------------------------- ConvWS, ConvModule
def test_ws_conv_matches_jax_and_unbiased_std_fails():
    """WSConv2d against the JAX WSConv: output and gradients. A control
    with torch's unbiased std (mmcv's conv_ws_2d) must miss the 1e-5
    bound."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 9, 10, 8).astype(np.float32)
    jm = JaxWSConv(6, (3, 3), padding=[(1, 1)] * 2, use_bias=True)
    params, _ = _init(jm, x)
    g = rs.randn(2, 9, 10, 6).astype(np.float32)
    want, (dp, dx) = _run(lambda p, x_, g_: _vjp(
        jm, {'params': p}, (x_,), g_), params, x, g)
    port = WSConv2d(8, 6, 3, padding=1)
    port.load_state_dict(state_dict_from_jax(params))
    from swindet_tpu_torch.models.layers import conv_nhwc
    got, (gx,) = _port_grads(
        lambda t: conv_nhwc(t, port, False, torch.float32, False), (x,), g)
    assert _rel(got, want) <= TOL_MODULE
    assert _rel(gx, dx) <= TOL_MODULE_GRAD
    sd = state_dict_from_jax(dp)
    for name, p in port.named_parameters():
        assert _rel(p.grad, sd[name]) <= TOL_MODULE_GRAD, name
    w = port.weight.detach()
    mean = w.mean((1, 2, 3), keepdim=True)
    unbiased = (w - mean) / (w.std((1, 2, 3), keepdim=True) + port.eps)
    mmcv = torch.nn.functional.conv2d(T(x).permute(0, 3, 1, 2), unbiased,
                                      port.bias, padding=1)
    assert _rel(mmcv.permute(0, 2, 3, 1), want) > TOL_MODULE


CONV_MODULE_CASES = {
    'ws-gn': dict(conv_cfg=dict(type='ConvWS'),
                  norm_cfg=dict(type='GN', num_groups=2)),
    'dcnv2': dict(conv_cfg=dict(type='DCNv2', deform_groups=2)),
    'dcn': dict(conv_cfg=dict(type='DCN', deform_groups=1)),
}


@pytest.mark.parametrize('case', list(CONV_MODULE_CASES))
def test_conv_module_conv_cfg_matches_jax(case):
    """ConvModule with conv_cfg (ConvWS with a GN; DCNv2 and DCN, whose
    pack sits under conv.* with mmcv's names) against the JAX ConvModule:
    output and gradients of x and every parameter."""
    kw = CONV_MODULE_CASES[case]
    rs = np.random.RandomState(5)
    x = rs.randn(2, 8, 10, 8).astype(np.float32)
    jm = JaxConvModule(8, 3, padding=1, act_cfg=dict(type='ReLU'), **kw)
    params, _ = _init(jm, x)
    g = rs.randn(2, 8, 10, 8).astype(np.float32)
    want, (dp, dx) = _run(lambda p, x_, g_: _vjp(
        jm, {'params': p}, (x_,), g_), params, x, g)
    port = ConvModule(8, 8, 3, padding=1, act_cfg=dict(type='ReLU'), **kw)
    sd = state_dict_from_jax(params)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)
    got, (gx,) = _port_grads(port, (x,), g)
    assert _rel(got, want) <= TOL_MODULE
    assert _rel(gx, dx) <= TOL_MODULE_GRAD
    want_sd = state_dict_from_jax(dp)
    for name, p in port.named_parameters():
        assert _rel(p.grad, want_sd[name]) <= TOL_MODULE_GRAD, name


def test_ws_conv_module_stays_off_the_kernel():
    """A norm-free ConvWS 3x3 ConvModule at 128 channels keeps its weight
    standardisation: it does not take the conv3x3 kernel, which the JAX
    ConvModule's TPU dispatch would send it to on the raw weight
    (swindet_tpu/models/layers.py:295-310 does not look at conv_cfg), and
    the raw weight gives another output."""
    gen = torch.Generator().manual_seed(0)
    ws = ConvModule(128, 128, 3, padding=1, conv_cfg=dict(type='ConvWS'))
    plain = ConvModule(128, 128, 3, padding=1)
    ws.init_weights(gen)
    plain.load_state_dict(ws.state_dict())
    assert plain.use_kernel and not ws.use_kernel
    x = torch.randn(1, 6, 7, 128, generator=gen)
    with torch.no_grad():
        assert _rel(plain(x), ws(x)) > 1e-2


def test_mask_head_takes_conv_cfg_as_the_jax_head():
    """FCNMaskHead(conv_cfg=ConvWS, GN) against the JAX head, which builds
    its convs without conv_cfg: equal. mmcv's head standardises them;
    built by hand (the same weights standardised), it differs."""
    rs = np.random.RandomState(6)
    x = rs.randn(3, 14, 14, 16).astype(np.float32)
    kw = dict(num_convs=2, in_channels=16, conv_out_channels=16,
              num_classes=3, conv_cfg=dict(type='ConvWS'),
              norm_cfg=dict(type='GN', num_groups=4))
    jm = JaxMaskHead(**{k: v for k, v in kw.items() if k != 'in_channels'})
    params, _ = _init(jm, x)
    want = np.asarray(jax.jit(lambda p: jm.apply({'params': p}, x))(params))
    port = FCNMaskHead(**kw)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        assert _rel(port(T(x)), want) <= TOL_MODULE
        for conv in port.convs:
            w = conv.conv.weight
            mean = w.mean((1, 2, 3), keepdim=True)
            w.copy_((w - mean) / (w.std((1, 2, 3), keepdim=True,
                                        correction=0) + 1e-5))
        assert _rel(port(T(x)), want) > 1e-2


# ------------------------------------------------------------- ResLayer
def test_res_layer_matches_jax():
    """ResLayer (stage 3, stride 2, frozen BN with running statistics) on
    14x14 roi features against the JAX ResLayer, style 'caffe' as in the
    C4 configs: output and gradients, state_dict layer4.{j}.*. The JAX
    ResLayer does not pass style on, so both put the stride on conv2;
    mmdet's caffe blocks (stride on conv1), built by hand on the same
    weights, give another output."""
    rs = np.random.RandomState(7)
    x = rs.randn(3, 14, 14, 128).astype(np.float32)
    kw = dict(depth=50, stage=3, stride=2, style='caffe', base_channels=8,
              norm_cfg=dict(type='BN', requires_grad=False))
    jm = JaxResLayer(**kw)
    params, stats = _init(jm, x)
    g = rs.randn(3, 7, 7, 256).astype(np.float32)
    want, (dp, dx) = _run(lambda p, x_, g_: _vjp(
        jm, {'params': p, 'batch_stats': stats}, (x_,), g_), params, x, g)
    port = ResLayer(**kw)
    sd = state_dict_from_jax(params, stats)
    assert sorted({k.split('.')[1] for k in sd}) == ['0', '1', '2'] \
        and all(k.startswith('layer4.') for k in sd)
    port.load_state_dict(sd, strict=True)
    port.train()
    got, (gx,) = _port_grads(port, (x,), g)
    assert got.shape == (3, 7, 7, 256)
    assert _rel(got, want) <= TOL_MODULE
    assert _rel(gx, dx) <= TOL_MODULE_GRAD
    want_sd = state_dict_from_jax(dp)
    for name, p in port.named_parameters():
        assert _rel(p.grad, want_sd[name]) <= TOL_MODULE_GRAD, name
    caffe = Bottleneck(128, 64, stride=2, downsample=True, style='caffe')
    caffe.load_state_dict({k[len('layer4.0.'):]: v for k, v in sd.items()
                           if k.startswith('layer4.0.')})
    with torch.no_grad():
        first = port.layer4[0].eval()(T(x))
        assert _rel(caffe.eval()(T(x)), first) > 1e-2


# ---------------------------------------------------- deformable RoI pool
STRIDES = (4, 8, 16, 32)


def _pool_inputs(seed=0, c=8, n=24):
    rs = np.random.RandomState(seed)
    feats = [rs.randn(2, 96 // s, 128 // s, c).astype(np.float32)
             for s in STRIDES]
    xy = rs.uniform(0, 90, (n, 2))
    wh = np.exp(rs.uniform(np.log(6), np.log(120), (n, 2)))
    rois = np.concatenate([rs.randint(0, 2, (n, 1)), xy, xy + wh],
                          1).astype(np.float32)
    return rs, feats, rois


@pytest.mark.parametrize('sampling_ratio', [0, 2])
def test_deform_roi_pool_matches_jax(sampling_ratio):
    """multilevel_deform_roi_pool against the JAX op over 4 levels, rois
    of every level, offsets of up to 0.6 (gamma 0.1: bins moved by up to
    6 % of the roi), some invalid: the output and the gradients of the
    features and the offsets."""
    rs, feats, rois = _pool_inputs()
    n = rois.shape[0]
    off = rs.uniform(-0.6, 0.6, (n, 7, 7, 2)).astype(np.float32)
    valid = rs.rand(n) > 0.15
    g = rs.randn(n, 7, 7, feats[0].shape[-1]).astype(np.float32)
    args = (STRIDES, 7, sampling_ratio, 0.1, 56)

    def f(fs, o):
        return jax_deform_roi_pool(fs, jnp.asarray(rois), o, *args,
                                   roi_valid=jnp.asarray(valid))
    want, vjp = jax.vjp(f, [jnp.asarray(a) for a in feats], jnp.asarray(off))
    dfeats, doff = vjp(jnp.asarray(g))
    ft = [T(a).requires_grad_() for a in feats]
    ot = T(off).requires_grad_()
    got = multilevel_deform_roi_pool(ft, T(rois), ot, *args,
                                     roi_valid=T(valid))
    (got * T(g)).sum().backward()
    assert _rel(got, want) <= TOL_MODULE
    assert _rel(ot.grad, doff) <= TOL_MODULE_GRAD
    for a, b in zip(ft, dfeats):
        assert _rel(a.grad, b) <= TOL_MODULE_GRAD


@pytest.mark.parametrize('kind', ['DeformRoIPoolPack',
                                  'ModulatedDeformRoIPoolPack'])
def test_deform_roi_extractor_matches_jax(kind):
    """SingleRoIExtractor with a deformable pool layer builds a
    DeformRoIExtractor; against the JAX one, its output and the gradients
    of the features and of every pack's FCs, mmcv's names
    (roi_layers.{l}.offset_fc.{0,2,4}, mask_fc.{0,2}). The output layers
    are drawn non-zero, so that the offsets move the bins and the mask
    scales them."""
    rs, feats, rois = _pool_inputs(seed=1, c=8, n=20)
    layer = dict(type=kind, output_size=7, output_channels=8,
                 deform_fc_channels=16)
    cfg = dict(roi_layer=layer, out_channels=8, featmap_strides=STRIDES)
    jm = JaxExtractor(**cfg)
    params, _ = _init(jm, feats, rois, seed=2)
    for k, v in params.items():
        if k.endswith('_out'):
            v['kernel'] = v['kernel'] * 0.2
    g = rs.randn(rois.shape[0], 7, 7, 8).astype(np.float32)
    want, (dp, dfeats, _) = _run(lambda p, fs, r, g_: _vjp(
        jm, {'params': p}, (fs, r), g_), params, feats, rois, g)
    port = SingleRoIExtractor(**cfg)
    assert isinstance(port, DeformRoIExtractor)
    sd = state_dict_from_jax(params)
    assert 'roi_layers.3.offset_fc.4.weight' in sd
    assert ('roi_layers.0.mask_fc.2.bias' in sd) == kind.startswith('Mod')
    port.load_state_dict(sd, strict=True)
    ft = [T(a).requires_grad_() for a in feats]
    got = port(ft, T(rois))
    (got * T(g)).sum().backward()
    assert _rel(got, want) <= TOL_MODULE
    for a, b in zip(ft, dfeats):
        assert _rel(a.grad, b) <= TOL_MODULE_GRAD
    want_sd = state_dict_from_jax(dp)
    for name, p in port.named_parameters():
        assert _rel(p.grad, want_sd[name]) <= TOL_MODULE_GRAD, name
    with torch.no_grad():
        plain = port.roi_layers
        for pack in plain:
            pack.offset_fc[4].weight.zero_()
            pack.offset_fc[4].bias.zero_()
        assert _rel(port([T(a) for a in feats], T(rois)), want) > 1e-3
