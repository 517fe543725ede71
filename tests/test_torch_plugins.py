"""The ResNet's plugins in the port (``ops/plugins.py``: ContextBlock,
GeneralizedAttention) against the JAX package's on the CPU, fp32, on the
same numpy weights and inputs:

- ``ContextBlock`` with 'att' and 'avg' pooling, and with channel_add,
  channel_mul and both;
- ``GeneralizedAttention`` at '1111', '0010' and '0100', with
  ``spatial_range > 0`` and with ``q_stride`` 2 on an odd map; the sine
  embedding and the nearest resize against the JAX package's own;
- a ResNet-50's first two stages (base width 8, frozen stem and layer1)
  with a ContextBlock and a GeneralizedAttention at each position;
- two configs shrunk as test_torch_backbones.py shrinks its four
  (``mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x``,
  ``faster_rcnn_r50_fpn_attention_1111_1x``; the ResNet-50 at base width
  8, cut to two and three stages): ``simple_test``, ``forward_train``
  with every gradient, the weights' round trip through the JAX converter
  (their names and shapes at full width: test_torch_backbones.py).

Every zero-init plugin parameter (ContextBlock's last convs,
GeneralizedAttention's ``gamma``) is drawn non-zero, as every other leaf
(numpy_params): at its init a plugin is the identity and its inner convs
take no gradient, so a zero there would pass whatever the plugin computes.
Tolerances are test_torch_backbones.py's.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.models.backbones.resnet import ResNet as JaxResNet
from swindet_tpu.ops import plugins as jax_plugins

from tests.test_torch_backbones import (INVARIANT, PLUGIN_CONFIGS,
                                        TOL_MODULE, T, _rel,
                                        check_forward_train, check_invariant,
                                        check_module, check_round_trip,
                                        check_simple_test, detector_case,
                                        full_cfg, jit_o0, shrink_heads)
from tests.test_torch_cascade import _draw_stats, numpy_params_from

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.models.backbones.resnet import ResNet
from swindet_tpu_torch.ops import plugins

def _plugin_sd(params, stats):
    """A bare plugin's state_dict: its tree under a ResNet block's
    ``plugin0``, the mmcv name stripped."""
    sd = state_dict_from_jax({'plugin0': params})
    return {k.split('.', 1)[1]: v for k, v in sd.items()}


CONTEXT_CASES = {
    'att-add': dict(pooling_type='att', fusion_types=('channel_add',)),
    'avg-add': dict(pooling_type='avg', fusion_types=('channel_add',)),
    'att-mul': dict(pooling_type='att', fusion_types=('channel_mul',)),
    'att-add-mul': dict(pooling_type='att',
                        fusion_types=('channel_add', 'channel_mul')),
}


@pytest.mark.parametrize('case', list(CONTEXT_CASES))
def test_context_block_matches_jax(case):
    kw = dict(CONTEXT_CASES[case], in_channels=32, ratio=1. / 4)
    x = np.random.RandomState(1).randn(2, 9, 13, 32).astype(np.float32)
    port = plugins.ContextBlock(**kw)
    params = check_module(jax_plugins.ContextBlock(**kw), port, x,
                          sd_of=_plugin_sd)
    for kind in kw['fusion_types']:
        # the zero-init last conv, drawn
        assert np.abs(params[f'{kind}_conv.3']['kernel']).min() > 0
        assert getattr(port, f'{kind}_conv')[1].weight.shape == (8, 1, 1)


ATTENTION_CASES = {
    '1111': dict(attention_type='1111'),
    '0010': dict(attention_type='0010'),
    '0100': dict(attention_type='0100'),
    '1111-range': dict(attention_type='1111', spatial_range=3),
    '1111-qstride': dict(attention_type='1111', q_stride=2),
}


@pytest.mark.parametrize('case', list(ATTENTION_CASES))
def test_generalized_attention_matches_jax(case):
    """Odd map sizes: the strided query and key grids and the q_stride
    upsample do not divide evenly."""
    kw = dict(ATTENTION_CASES[case], in_channels=32, num_heads=4,
              kv_stride=2)
    x = np.random.RandomState(2).randn(2, 11, 13, 32).astype(np.float32)
    port = plugins.GeneralizedAttention(**kw)
    params = check_module(jax_plugins.GeneralizedAttention(**kw), port, x,
                          sd_of=_plugin_sd)
    assert params['gamma'].item() != 0.0
    if port.appr_bias is not None:
        assert port.appr_bias.shape == (32,)


@pytest.mark.parametrize('case', ['1111', '1111-range'])
def test_generalized_attention_serves_then_trains(case):
    """The sine tables and the range mask are made once per shape: a
    block that first served a map under inference mode then trains on one
    of that shape, with the gradients of a block that never served."""
    torch.manual_seed(0)
    kw = dict(ATTENTION_CASES[case], in_channels=32, num_heads=4,
              kv_stride=2)
    x = torch.from_numpy(
        np.random.RandomState(3).randn(1, 9, 15, 32).astype(np.float32))
    port = plugins.GeneralizedAttention(**kw)
    with torch.no_grad():
        port.gamma.fill_(0.5)
    fresh = copy.deepcopy(port)
    grads = []
    for model in (port, fresh):
        plugins._sine_table.cache_clear()
        plugins._keep_mask.cache_clear()
        if model is port:
            with torch.inference_mode():
                model(x)
        model(x).square().sum().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_sine_embedding_and_nearest_resize_equal_jax():
    """The embedding equals the JAX package's bit for bit; the nearest
    resize indexes as jax.image.resize at odd and even sizes."""
    for q, k, dim, mag in ((np.arange(6) * 2, np.arange(3) * 4, 16, 1.0),
                           (np.arange(5), np.arange(5) * 2, 12, 3.0)):
        assert np.array_equal(
            plugins.sine_position_embedding(q, k, dim, mag),
            np.asarray(jax_plugins._sine_position_embedding(q, k, dim, mag)))
    x = np.random.RandomState(3).randn(2, 6, 7, 3).astype(np.float32)
    for size in ((11, 13), (12, 14), (5, 3)):
        want = jax.image.resize(x, (2, *size, 3), 'nearest')
        got = plugins.resize_nearest_half_pixel(T(x), size)
        assert np.array_equal(got.numpy(), np.asarray(want)), size


def _plugged(position):
    cfgs = [dict(type='ContextBlock', ratio=1. / 4),
            dict(type='GeneralizedAttention', num_heads=4,
                 attention_type='1111', kv_stride=2)]
    return [dict(cfg=c, stages=(False, True), position=position)
            for c in cfgs]


@pytest.mark.parametrize('position', ['after_conv1', 'after_conv2',
                                      'after_conv3'])
def test_plugged_resnet_matches_jax(position):
    """A ResNet-50's first two stages with both plugins in stage 2 at
    ``position``:
    outputs and every gradient (frozen_stages=1 on both sides: the stem
    and layer1 take none); the state_dict names them as mmdet does."""
    kw = dict(depth=50, base_channels=8, num_stages=2,
              out_indices=(0, 1), frozen_stages=1,
              plugins=_plugged(position))
    x = np.random.RandomState(4).randn(2, 64, 96, 3).astype(np.float32)
    port = ResNet(**kw)
    jm = JaxResNet(**kw)
    shapes = jax.eval_shape(lambda k: jm.init(k, x), jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 1)
    stats = _draw_stats(shapes['batch_stats'], 2)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    assert 'layer2.0.context_block.conv_mask.weight' in port.state_dict()
    assert 'layer2.3.gen_attention_block.gamma' in port.state_dict()
    assert not any('layer1.0.context' in k for k in port.state_dict())
    assert port.layer2[0].plugin_names[position] == [
        'context_block', 'gen_attention_block']

    def outs(p, x):
        return tuple(jm.apply({'params': p, 'batch_stats': stats}, x))
    want = jit_o0(outs)(params, x)
    rs = np.random.RandomState(5)
    gs = [rs.randn(*o.shape).astype(np.float32) for o in want]
    grads = jit_o0(jax.grad(lambda p: sum(
        jnp.sum(o * g) for o, g in zip(outs(p, x), gs))))(params)
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    got = port.train()(T(x))
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL_MODULE
    sum((o * T(g)).sum() for o, g in zip(got, gs)).backward()
    scale = max(float(w.abs().max()) for w in want_grads.values())
    invariant = check_invariant(want_grads, scale) + check_invariant(
        {n: p.grad for n, p in port.named_parameters()}, scale)
    for name, p in port.named_parameters():
        w = want_grads[name]
        if name in invariant:
            continue
        if name.startswith(('conv1.', 'bn1.', 'layer1.')):
            assert p.grad is None and not w.abs().max(), name
        else:
            assert p.grad is not None and w.abs().max() > 0, name
            assert _rel(p.grad, w) <= 1e-4, (name, _rel(p.grad, w))


def test_plugins_need_bottlenecks():
    """Plugins on a BasicBlock ResNet raise, as mmdet's BasicBlock asserts
    (the JAX ResNet drops them there); an unknown position raises."""
    with pytest.raises(ValueError, match='Bottleneck'):
        ResNet(depth=34, num_stages=2, plugins=_plugged('after_conv2'))
    with pytest.raises(ValueError, match='position'):
        ResNet(depth=50, num_stages=2, plugins=_plugged('after_conv4'))


# ------------------------------------------------------------- detectors
def tiny_cfg(name):
    """The config's model with its ResNet-50 at base width 8 cut to the
    stages up to the first that holds a plugin (gcb two, attn three, the
    FPN on them) and shrink_heads' neck and heads; the plugins as
    configured in those stages."""
    cfg = full_cfg(PLUGIN_CONFIGS[name])
    bb = cfg['backbone']
    n = {'gcb': 2, 'attn': 3}[name]
    bb.update(base_channels=8, num_stages=n, out_indices=tuple(range(n)))
    for p in bb['plugins']:
        p['stages'] = tuple(p['stages'])[:n]
    return shrink_heads(cfg, (32, 64, 128, 256)[:n])


@pytest.fixture(scope='module', params=list(PLUGIN_CONFIGS))
def config_case(request):
    case = detector_case(tiny_cfg(request.param))
    kinds = {type(m).__name__ for m in case['port'].backbone.modules()}
    assert {'gcb': 'ContextBlock',
            'attn': 'GeneralizedAttention'}[request.param] in kinds
    return case


def test_config_simple_test_matches_jax(config_case):
    check_simple_test(config_case)


def test_config_forward_train_matches_jax(config_case):
    port = check_forward_train(config_case)
    grads = {n: p.grad for n, p in port.named_parameters()
             if ('context_block' in n or 'gen_attention_block' in n)
             and not n.endswith(INVARIANT)}
    assert grads and all(g is not None and g.abs().max() > 0
                         for g in grads.values())


def test_config_weights_round_trip_bit_exact(config_case):
    check_round_trip(config_case)
