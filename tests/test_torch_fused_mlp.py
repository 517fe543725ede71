"""The port's fused MLP against the JAX package's: the plain versions of
the forward and backward against the Pallas kernels run with
``interpret=True`` (as tests/test_ops/test_fused_mlp.py runs them), the
``Mlp`` module and a small Swin backbone with the JAX package's switch
``SWINDET_FUSED_MLP=1`` set on both sides, and the width guard that picks
the fused layers.

The same numpy inputs, made from a seed, go through both sides.
Tolerances are those of tests/test_ops/test_fused_mlp.py in fp32: 2e-5
on values, gradients rtol 5e-4 and atol 5e-5. In bf16 both sides round
the activation and the output at the same points but sum in other
orders, so a rounding may land one bf16 unit (2^-8 relative) apart:
2e-2. The port's erf is XLA's rational approximation; on the CPU the JAX
module's reference path takes lax.erf, a few fp32 ulps away.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.models.layers import Mlp as JaxMlp
from swindet_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from tests.test_torch_checkpoint import jax_backbone_params

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.models.builder import build_backbone
from swindet_tpu_torch.models.layers import Mlp
from swindet_tpu_torch.ops import (fused_mlp, fused_mlp_bwd,
                                   fused_mlp_bwd_reference, fused_mlp_op,
                                   fused_mlp_reference)

TINY_SWIN = dict(type='SwinTransformer', embed_dim=32, depths=[2, 2, 2, 1],
                 num_heads=[1, 2, 4, 8], window_size=7, drop_path_rate=0.0)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(r=48, c=32, h=64, seed=0):
    """x and the JAX layout's weights (C, H), (H, C), as in
    tests/test_ops/test_fused_mlp.py."""
    rs = np.random.RandomState(seed)
    x = rs.randn(r, c).astype(np.float32) * 0.5
    w1 = rs.randn(c, h).astype(np.float32) * (c ** -0.5)
    b1 = rs.randn(h).astype(np.float32) * 0.1
    w2 = rs.randn(h, c).astype(np.float32) * (h ** -0.5)
    b2 = rs.randn(c).astype(np.float32) * 0.1
    return x, w1, b1, w2, b2


def _port(x, w1, b1, w2, b2, dtype):
    """The port's arguments: x and the weights (nn.Linear layout) in
    dtype, the biases fp32."""
    t = torch.from_numpy
    return (t(x).to(dtype), t(w1.T.copy()).to(dtype), t(b1),
            t(w2.T.copy()).to(dtype), t(b2))


def _jax(x, w1, b1, w2, b2, dtype):
    d = JAX_DTYPE[dtype]
    return (jnp.asarray(x, d), jnp.asarray(w1, d), jnp.asarray(b1),
            jnp.asarray(w2, d), jnp.asarray(b2))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if isinstance(
        a, jax.Array) else a.detach().float().numpy()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_forward_matches_pallas(dtype):
    args = _inputs()
    want = jax_fused_mlp(*_jax(*args, dtype), interpret=True)
    got = fused_mlp(*_port(*args, dtype))
    assert got.dtype == dtype and tuple(got.shape) == (48, 32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(got, fused_mlp_reference(*_port(*args, dtype)))


def _loss_jax(*a):
    out = jax_fused_mlp(*a, interpret=True).astype(jnp.float32)
    return jnp.sum(out * jnp.sin(out * 0.3))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_gradients_match_pallas(dtype):
    """All five gradients of fused_mlp_op (its backward is the plain
    version of the backward kernel) against jax.grad through the Pallas
    forward and backward kernels. bf16: per output within 2e-2 of its
    largest entry, for a gradient summed over rows from rounded terms."""
    args = _inputs(seed=1)
    want = jax.grad(_loss_jax, argnums=(0, 1, 2, 3, 4))(*_jax(*args, dtype))
    leaves = [t.requires_grad_() for t in _port(*args, dtype)]
    out = fused_mlp_op(*leaves).float()
    (out * torch.sin(out * 0.3)).sum().backward()
    for name, leaf, w, transpose in zip(('x', 'w1', 'b1', 'w2', 'b2'),
                                        leaves, want,
                                        (False, True, False, True, False)):
        got, w = _np(leaf.grad), _np(w)
        assert leaf.grad.dtype == leaf.dtype, name
        if transpose:
            got = got.T
        if dtype == torch.float32:
            np.testing.assert_allclose(got, w, rtol=5e-4, atol=5e-5,
                                       err_msg=f'grad {name}')
        else:
            assert np.abs(got - w).max() <= 2e-2 * np.abs(w).max(), name


def test_backward_wrapper_is_the_plain_version_on_cpu():
    x, w1, b1, w2, _ = _port(*_inputs(seed=2), torch.float32)
    g = torch.from_numpy(np.random.RandomState(3).randn(48, 32)
                         .astype(np.float32))
    got = fused_mlp_bwd(x, w1, b1, w2, g)
    want = fused_mlp_bwd_reference(x, w1, b1, w2, g)
    assert [tuple(t.shape) for t in got] == [(48, 32), (64, 32), (64,),
                                             (32, 64), (32,)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _jax_mlp_params(c, h, seed):
    rs = np.random.RandomState(seed)
    return {'fc1': {'kernel': rs.randn(c, h).astype(np.float32) * c ** -0.5,
                    'bias': rs.randn(h).astype(np.float32) * 0.1},
            'fc2': {'kernel': rs.randn(h, c).astype(np.float32) * h ** -0.5,
                    'bias': rs.randn(c).astype(np.float32) * 0.1}}


def test_mlp_module_with_the_switch_matches_jax(monkeypatch):
    """The port's Mlp and the JAX package's with SWINDET_FUSED_MLP=1: the
    same parameter names, outputs and parameter gradients."""
    monkeypatch.setenv('SWINDET_FUSED_MLP', '1')
    params = _jax_mlp_params(32, 128, seed=4)
    x = np.random.RandomState(5).randn(2, 16, 32).astype(np.float32)
    mod = JaxMlp(hidden_features=128, out_features=32)

    def loss(p):
        out = mod.apply({'params': p}, jnp.asarray(x))
        return jnp.sum(out * jnp.sin(out * 0.3)), out

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    port = Mlp(32, 128, 32)
    assert port.fused
    port.load_state_dict(
        {f'{fc}.{k}': torch.from_numpy(
            params[fc]['kernel'].T.copy() if k == 'weight'
            else params[fc]['bias'])
         for fc in ('fc1', 'fc2') for k in ('weight', 'bias')}, strict=True)
    out = port(torch.from_numpy(x))
    (out * torch.sin(out * 0.3)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for fc in ('fc1', 'fc2'):
        layer = getattr(port, fc)
        np.testing.assert_allclose(layer.weight.grad.numpy().T,
                                   np.asarray(want_g[fc]['kernel']),
                                   rtol=5e-4, atol=5e-5, err_msg=fc)
        np.testing.assert_allclose(layer.bias.grad.numpy(),
                                   np.asarray(want_g[fc]['bias']),
                                   rtol=5e-4, atol=5e-5, err_msg=fc)


@pytest.mark.parametrize('switch,c,fused', [
    ('1', 96, True), ('1', 384, True), ('1', 768, False), ('0', 96, False),
    (None, 96, False)])
def test_mlp_reads_the_switch_and_keeps_the_width_guard(monkeypatch, switch,
                                                       c, fused):
    """Swin-T fuses stages 1-3 and leaves stage 4 (C = 768, 18.9 MB of
    fp32 weight gradients) unfused, as the JAX package does."""
    if switch is None:
        monkeypatch.delenv('SWINDET_FUSED_MLP', raising=False)
    else:
        monkeypatch.setenv('SWINDET_FUSED_MLP', switch)
    assert Mlp(c, 4 * c, c).fused is fused
    assert Mlp(c, 4 * c, c, fused=False).fused is False


def test_swin_with_the_switch_matches_jax(monkeypatch):
    """A small Swin backbone with SWINDET_FUSED_MLP=1 on both sides: every
    block's MLP fused in the port, the same state_dict as without the
    switch, and the four stages equal to the JAX package's."""
    monkeypatch.delenv('SWINDET_FUSED_MLP', raising=False)
    unfused = build_backbone(dict(TINY_SWIN)).state_dict()
    monkeypatch.setenv('SWINDET_FUSED_MLP', '1')
    jm, params = jax_backbone_params(TINY_SWIN, seed=6)
    img = np.random.RandomState(6).randn(1, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda p, x: jm.apply({'params': p}, x))(
        params, jnp.asarray(img))
    port = build_backbone(dict(TINY_SWIN))
    mlps = [m for m in port.modules() if isinstance(m, Mlp)]
    assert len(mlps) == 7 and all(m.fused for m in mlps)
    sd = port.state_dict()
    assert {k: v.shape for k, v in sd.items()} == \
        {k: v.shape for k, v in unfused.items()}
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(img))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
