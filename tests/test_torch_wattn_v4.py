"""The port's v4 window attention (qkv projection, attention and output
projection in one op; ``SWINDET_WATTN_V4=1``) against the JAX package's:
the plain versions of the forward and backward against the Pallas kernels
run with ``interpret=True`` (as tests/test_ops/test_window_attention_v4.py
runs them), the op's gradients against ``jax.grad``, and
``WindowAttention`` and a small Swin backbone with the switch set on both
sides.

The same numpy inputs, made from a seed, go through both sides; the
inputs are those of tests/test_ops/test_window_attention_v4.py. Tolerances
are that file's, in fp32: 2e-5 on values, gradients rtol 5e-4 and atol
5e-5. The module and backbone comparisons hold 1e-4, as the port's other
backbone tests do.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.models.backbones.swin import \
    WindowAttention as JaxWindowAttention
from swindet_tpu.ops.window_attention_v4 import (
    _wattn4_bwd_impl, window_attention_v4 as jax_window_attention_v4,
    window_attention_v4_reference as jax_window_attention_v4_reference)
from tests.test_torch_checkpoint import jax_backbone_params

import torch.nn.functional as F

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.models.backbones.swin import (
    WindowAttention, shifted_window_attn_mask)
from swindet_tpu_torch.models.builder import build_backbone
from swindet_tpu_torch.ops import (window_attention_v4,
                                   window_attention_v4_bwd,
                                   window_attention_v4_bwd_limits,
                                   window_attention_v4_bwd_reference,
                                   window_attention_v4_bwd_reference_f64,
                                   window_attention_v4_op,
                                   window_attention_v4_reference)
from swindet_tpu_torch.ops.window_attention import attention_probs

TINY_SWIN = dict(type='SwinTransformer', embed_dim=32, depths=[2, 2, 2, 1],
                 num_heads=[1, 2, 4, 8], window_size=7, drop_path_rate=0.0)
GRADS = ('x', 'wqkv', 'bqkv', 'bias', 'wproj', 'bproj')


def _inputs(b_=4, n=16, c=32, nh=2, nw=2, with_mask=True, seed=0):
    """tests/test_ops/test_window_attention_v4.py's inputs, in the JAX
    layout: Wqkv (C, 3C), Wproj (C, C)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b_, n, c).astype(np.float32) * 0.5
    wqkv = rs.randn(c, 3 * c).astype(np.float32) * (c ** -0.5)
    bqkv = rs.randn(3 * c).astype(np.float32) * 0.1
    bias = rs.randn(nh, n, n).astype(np.float32) * 0.2
    mask = None
    if with_mask:
        mask = np.where(rs.rand(nw, n, n) > 0.7, -100.0, 0.0) \
            .astype(np.float32)
    wproj = rs.randn(c, c).astype(np.float32) * (c ** -0.5)
    bproj = rs.randn(c).astype(np.float32) * 0.1
    return x, wqkv, bqkv, bias, mask, wproj, bproj


def _port(x, wqkv, bqkv, bias, mask, wproj, bproj):
    """The port's arguments: the weights in the nn.Linear layout."""
    t = torch.from_numpy
    return (t(x), t(wqkv.T.copy()), t(bqkv), t(bias),
            None if mask is None else t(mask), t(wproj.T.copy()), t(bproj))


def _jax(*args):
    return tuple(None if a is None else jnp.asarray(a) for a in args)


@pytest.mark.parametrize('b_,nw,with_mask,seed', [
    (4, 2, False, 0), (4, 2, True, 0), (3, 3, True, 1)])
def test_forward_matches_pallas(b_, nw, with_mask, seed):
    """The wrapper on a CPU tensor (its plain version) against the Pallas
    kernel and the JAX reference; (3, 3) is the odd window count."""
    args = _inputs(b_=b_, nw=nw, with_mask=with_mask, seed=seed)
    got = window_attention_v4(*_port(*args), 2)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b_, 16, 32)
    for want in (jax_window_attention_v4(*_jax(*args), num_heads=2,
                                         interpret=True),
                 jax_window_attention_v4_reference(*_jax(*args),
                                                   num_heads=2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    assert torch.equal(got, window_attention_v4_reference(*_port(*args), 2))


def test_bf16_forward_matches_jax_reference():
    """In bf16 both plain versions round qkv, the attention output and the
    output to bf16; sums in other orders may land a rounding one bf16 unit
    (2^-8 relative) apart, so 2e-2."""
    args = _inputs(seed=2)
    x, rest = args[0], args[1:]
    got = window_attention_v4(torch.from_numpy(x).bfloat16(),
                              *_port(x, *rest)[1:], 2)
    want = jax_window_attention_v4_reference(
        jnp.asarray(x, jnp.bfloat16), *_jax(*rest), num_heads=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def _grads_as_jax(got):
    """The port's (dx, dWqkv, dbqkv, dBias, dWproj, dbproj) in the JAX
    layout."""
    dx, dwqkv, dbqkv, dbias, dwproj, dbproj = [t.detach().numpy()
                                               for t in got]
    return dx, dwqkv.T, dbqkv, dbias, dwproj.T, dbproj


@pytest.mark.parametrize('with_mask', [False, True])
def test_bwd_reference_matches_pallas_bwd(with_mask):
    """The six gradients of the plain backward against _wattn4_bwd_impl in
    interpret mode, for the same output gradient."""
    args = _inputs(with_mask=with_mask, seed=3)
    x, wqkv, bqkv, bias, mask, wproj, _ = args
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    jmask = jnp.zeros((1, 16, 16), jnp.float32) if mask is None \
        else jnp.asarray(mask)
    want = _wattn4_bwd_impl(jnp.asarray(x), jnp.asarray(wqkv),
                            jnp.asarray(bqkv), jnp.asarray(bias), jmask,
                            jnp.asarray(wproj), jnp.asarray(g), 2, True)
    pa = _port(*args)
    got = window_attention_v4_bwd(*pa[:6], torch.from_numpy(g), 2)
    assert [tuple(t.shape) for t in got] == [
        (4, 16, 32), (96, 32), (96,), (2, 16, 16), (32, 32), (32,)]
    for name, a, b in zip(GRADS, _grads_as_jax(got), want):
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape),
                                   rtol=5e-4, atol=5e-5, err_msg=name)
    # on a CPU tensor the wrapper is the plain version
    for a, b in zip(got, window_attention_v4_bwd_reference(
            *pa[:6], torch.from_numpy(g), 2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('with_mask', [False, True])
def test_op_gradients_match_jax_grad(with_mask):
    """window_attention_v4_op's six gradients (its backward is the plain
    version of the backward kernels) against jax.grad through the Pallas
    forward and backward kernels; the mask gets none."""
    args = _inputs(with_mask=with_mask)
    ja = _jax(*args)

    def loss(x_, wqkv_, bqkv_, bias_, wproj_, bproj_):
        out = jax_window_attention_v4(x_, wqkv_, bqkv_, bias_, ja[4], wproj_,
                                      bproj_, num_heads=2, interpret=True)
        return jnp.sum(out * jnp.cos(out * 0.1))

    want = jax.grad(loss, argnums=tuple(range(6)))(*ja[:4], *ja[5:])
    pa = list(_port(*args))
    leaves = [t.requires_grad_() for i, t in enumerate(pa) if i != 4]
    out = window_attention_v4_op(*leaves[:4], pa[4], *leaves[4:], 2)
    (out * torch.cos(out * 0.1)).sum().backward()
    got = _grads_as_jax([t.grad for t in leaves])
    for name, a, b in zip(GRADS, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4, atol=5e-5,
                                   err_msg=f'grad {name}')
    if pa[4] is not None:
        assert pa[4].grad is None


def _bwd_as_first_written(x, wqkv, bqkv, bias, mask, wproj, g, num_heads):
    """The plain backward as it read before it took the tensor-core
    kernels' rounding option, kept here to hold the option's default to
    it bit for bit."""
    b_, n, c = x.shape
    hd = c // num_heads
    scale = hd ** -0.5
    xf, gf = x.float(), g.float()
    qkv = F.linear(xf, wqkv.float(), bqkv.float())
    p, v = attention_probs(qkv, bias, mask, num_heads)
    attn = (p @ v).transpose(1, 2).reshape(b_ * n, c)
    g2 = gf.reshape(b_ * n, c)
    dwproj = g2.t() @ attn
    dbproj = g2.sum(0)
    da = (g2 @ wproj.float()).view(b_, n, num_heads, hd).transpose(1, 2)
    q, k = qkv.view(b_, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)[:2]
    q = q * scale
    dv = p.transpose(-1, -2) @ da
    dp = da @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = ds.transpose(-1, -2) @ q
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4) \
        .reshape(b_ * n, 3 * c)
    dwqkv = dqkv.t() @ xf.reshape(b_ * n, c)
    dx = (dqkv @ wqkv.float()).view(b_, n, c).to(x.dtype)
    return dx, dwqkv, dqkv.sum(0), ds.sum(0), dwproj, dbproj


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('with_mask', [False, True])
def test_bwd_reference_default_is_unchanged(dtype, with_mask):
    """With tc_rounding off (the default, what every fp32 check reads) the
    plain backward equals its first form bit for bit."""
    x, wqkv, bqkv, bias, mask, wproj, _ = _port(*_inputs(
        with_mask=with_mask, seed=5))
    g = torch.from_numpy(np.random.RandomState(6).randn(*x.shape)
                         .astype(np.float32))
    args = (x.to(dtype), wqkv, bqkv, bias, mask, wproj, g.to(dtype), 2)
    for a, b in zip(window_attention_v4_bwd_reference(*args),
                    _bwd_as_first_written(*args)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# a stage-1 width (C 96, 3 heads, with the shift mask of a 14 x 21 map's 6
# windows) and a stage-4 width (C 768, 24 heads, no shift), a few windows
# each
V4_WIDTHS = [(12, 96, 3, (14, 21)), (4, 768, 24, None)]


def _v4_case(b_, c, nh, shift_map, seed=0):
    """Seeded bf16 x and g, fp32 weights of a Swin block (the scales of
    chip_smoke.py's _v4_inputs) and the shift mask or None."""
    rs = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale)
                                .astype(np.float32))

    mask = None if shift_map is None else torch.from_numpy(
        shifted_window_attn_mask(*shift_map, 7, 3))
    return (t(b_, 49, c).bfloat16(), t(3 * c, c, scale=c ** -0.5),
            t(3 * c, scale=0.1), t(nh, 49, 49, scale=0.5), mask,
            t(c, c, scale=c ** -0.5), t(c, scale=0.1),
            t(b_, 49, c).bfloat16())


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize('b_,c,nh,shift_map', V4_WIDTHS)
def test_rounding_bwd_is_as_close_as_the_bf16_chain(b_, c, nh, shift_map):
    """In bf16, the plain backward with the tensor-core kernels' rounding
    is no farther from the fp32 plain version than 1.5 times the bf16
    autograd of the unfused chain (window_attention_v4_reference, what
    the JAX package's non-TPU path computes), per output, as a share of
    the output's largest entry."""
    x, wqkv, bqkv, bias, mask, wproj, bproj, g = _v4_case(b_, c, nh,
                                                          shift_map)
    args = (x, wqkv, bqkv, bias, mask, wproj, g, nh)
    fp32 = window_attention_v4_bwd_reference(*args)
    mine = window_attention_v4_bwd_reference(*args, tc_rounding=True)
    leaves = [t.clone().requires_grad_()
              for t in (x, wqkv, bqkv, bias, wproj, bproj)]
    out = window_attention_v4_reference(*leaves[:4], mask, *leaves[4:], nh)
    out.backward(g)
    chain = [leaves[i].grad for i in (0, 1, 2, 3, 4, 5)]
    for name, a, b, f in zip(GRADS, mine, chain, fp32):
        assert a.dtype == f.dtype and a.shape == f.shape
        assert _rel(a, f) <= 1.5 * _rel(b, f), name


@pytest.mark.parametrize('b_,c,nh,shift_map', V4_WIDTHS)
def test_bwd_limit_from_the_order_spread(b_, c, nh, shift_map):
    """The bf16 check's limits of the fp32 outputs (dWqkv, dbqkv, dBias,
    dWproj, dbproj), derived on the check's own inputs: the same
    computation in float64 passes them, and the rounding plain version
    with one 64-row tile of g zeroed (a kernel that dropped a tile) fails
    every one."""
    x, wqkv, bqkv, bias, mask, wproj, _, g = _v4_case(b_, c, nh, shift_map,
                                                      seed=1)
    args = (x, wqkv, bqkv, bias, mask, wproj, g, nh)
    want = window_attention_v4_bwd_reference(*args, tc_rounding=True)
    limits = window_attention_v4_bwd_limits(*args, want)
    assert len(limits) == 5 and all(lim > 0 for lim in limits)
    other = window_attention_v4_bwd_reference_f64(*args)
    assert all((o - w).abs().max().item() <= lim
               for o, w, lim in zip(other, want[1:], limits))
    dropped = g.clone()
    dropped.view(-1, c)[64:128] = 0
    control = window_attention_v4_bwd_reference(*args[:-2], dropped, nh,
                                                tc_rounding=True)
    assert all((a - w).abs().max().item() > lim
               for a, w, lim in zip(control[1:], want[1:], limits))


def _jax_attention_params(c, nh, ws, qkv_bias, seed):
    rs = np.random.RandomState(seed)
    p = {'relative_position_bias_table':
         rs.randn((2 * ws - 1) ** 2, nh).astype(np.float32) * 0.1,
         'qkv': {'kernel': rs.randn(c, 3 * c).astype(np.float32) * c ** -0.5},
         'proj': {'kernel': rs.randn(c, c).astype(np.float32) * c ** -0.5,
                  'bias': rs.randn(c).astype(np.float32) * 0.1}}
    if qkv_bias:
        p['qkv']['bias'] = rs.randn(3 * c).astype(np.float32) * 0.1
    return p


@pytest.mark.parametrize('qkv_bias', [True, False])
def test_window_attention_module_with_the_switch_matches_jax(monkeypatch,
                                                             qkv_bias):
    """WindowAttention with SWINDET_WATTN_V4=1 on both sides (as
    tests/test_ops/test_wattn_v4_integration.py sets it on the JAX side):
    the port's module takes the v4 op, keeps the state_dict of the switch
    off, and matches the JAX module's output and parameter gradients."""
    monkeypatch.delenv('SWINDET_WATTN_V4', raising=False)
    off = WindowAttention(32, 4, 2, qkv_bias)
    assert not off.v4
    monkeypatch.setenv('SWINDET_WATTN_V4', '1')
    port = WindowAttention(32, 4, 2, qkv_bias)
    assert port.v4
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in off.state_dict().items()}
    rs = np.random.RandomState(0)
    x = rs.randn(4, 16, 32).astype(np.float32)
    mask = np.where(rs.rand(2, 16, 16) > 0.7, -100.0, 0.0) \
        .astype(np.float32)
    params = _jax_attention_params(32, 2, 4, qkv_bias, seed=1)
    mod = JaxWindowAttention(dim=32, window_size=(4, 4), num_heads=2,
                             qkv_bias=qkv_bias)

    def loss(p):
        out = mod.apply({'params': p}, jnp.asarray(x), jnp.asarray(mask))
        return jnp.sum(out * jnp.cos(out * 0.1)), out

    (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(params)
    sd = {'relative_position_bias_table':
          torch.from_numpy(params['relative_position_bias_table'])}
    for fc in ('qkv', 'proj'):
        sd[f'{fc}.weight'] = torch.from_numpy(params[fc]['kernel'].T.copy())
        if 'bias' in params[fc]:
            sd[f'{fc}.bias'] = torch.from_numpy(params[fc]['bias'])
    port.load_state_dict(sd, strict=True)
    out = port(torch.from_numpy(x), torch.from_numpy(mask))
    (out * torch.cos(out * 0.1)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        port.relative_position_bias_table.grad.numpy(),
        np.asarray(want_g['relative_position_bias_table']), rtol=5e-4,
        atol=5e-5)
    for fc in ('qkv', 'proj'):
        layer = getattr(port, fc)
        np.testing.assert_allclose(layer.weight.grad.numpy().T,
                                   np.asarray(want_g[fc]['kernel']),
                                   rtol=5e-4, atol=5e-5, err_msg=fc)
        if layer.bias is not None:
            np.testing.assert_allclose(layer.bias.grad.numpy(),
                                       np.asarray(want_g[fc]['bias']),
                                       rtol=5e-4, atol=5e-5, err_msg=fc)


def test_swin_with_the_switch_matches_jax(monkeypatch):
    """A small Swin backbone with SWINDET_WATTN_V4=1 on both sides: every
    block's attention takes the v4 op, the state_dict equals the one
    without the switch (so state_dict_from_jax needs no change), and the
    four stages equal the JAX package's."""
    monkeypatch.delenv('SWINDET_WATTN_V4', raising=False)
    plain = build_backbone(dict(TINY_SWIN)).state_dict()
    monkeypatch.setenv('SWINDET_WATTN_V4', '1')
    jm, params = jax_backbone_params(TINY_SWIN, seed=7)
    img = np.random.RandomState(7).randn(1, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda p, x: jm.apply({'params': p}, x))(
        params, jnp.asarray(img))
    port = build_backbone(dict(TINY_SWIN))
    attns = [m for m in port.modules() if isinstance(m, WindowAttention)]
    assert len(attns) == 7 and all(m.v4 for m in attns)
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in plain.items()}
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(img))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
