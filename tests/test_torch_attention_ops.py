"""The port's v1 window attention (head-major q, k, v) and its full-map
shifted-window attention against the JAX package's Pallas kernels, run
with ``interpret=True`` as tests/test_ops/test_window_attention.py and
tests/test_ops/test_swin_attention.py run them: forwards, and gradients
against ``jax.grad`` through the JAX ops (whose backward recomputes
through their lax references, as the port's does through its plain
versions). The full-map attention is also held to the port's own
blockwise path: the backbone's pad + roll + partition gather, window
attention with the shift mask, and the inverse gather; and the form its
tensor-core kernel computes (``swin_attention_kernel_form``: wrapped
pixel reads, a mask from region ids only in the last window row and
column, output at rolled pixels) to the Pallas kernel.

The same numpy inputs, made from a seed, go through both sides.
Tolerances are those of the JAX package's tests, in fp32: forwards 1e-5,
gradients 1e-4; bf16 forwards at the card's bf16 tolerance, 2e-2
(chip_smoke.py TOL: one bf16 unit of an output, 2^-8 relative, and a
probability rounded one bf16 unit apart).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.ops.swin_attention import \
    swin_window_attention as jax_swin_window_attention
from swindet_tpu.ops.window_attention import \
    window_attention as jax_window_attention

from swindet_tpu_torch.models.backbones.swin import window_gather_indices
from swindet_tpu_torch.ops import (shifted_window_attn_mask,
                                   swin_attention_kernel_form,
                                   swin_attention_reference,
                                   swin_window_attention, window_attention,
                                   window_attention_reference)


def _mask(nw, n):
    m = np.zeros((nw, n, n), np.float32)
    m[1, :10, 10:] = -100.0
    m[1, 10:, :10] = -100.0
    return m


@pytest.mark.parametrize('b_,nh,hd,nw', [(12, 3, 32, None), (12, 3, 32, 4),
                                         (5, 2, 16, None)])
def test_window_attention_matches_pallas(b_, nh, hd, nw):
    """N = 49 (not a multiple of the TPU's sublane padding); (5, 2, 16)
    is the window count that is no multiple of the TPU's block."""
    rs = np.random.RandomState(0)
    n, c = 49, nh * hd
    qkv = rs.randn(b_, n, 3 * c).astype(np.float32)
    bias = rs.randn(nh, n, n).astype(np.float32)
    mask = None if nw is None else _mask(nw, n)
    want = jax_window_attention(
        jnp.asarray(qkv), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), num_heads=nh, wblk=8,
        interpret=True)
    got = window_attention(torch.from_numpy(qkv), torch.from_numpy(bias),
                           None if mask is None else torch.from_numpy(mask),
                           nh)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b_, n, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # on a CPU tensor the kernel's place is taken by the plain version
    assert torch.equal(got, window_attention_reference(
        torch.from_numpy(qkv), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), nh))


@pytest.mark.parametrize('mask_on', [False, True])
def test_window_attention_gradients_match_jax(mask_on):
    rs = np.random.RandomState(1)
    b_, n, nh, hd = 8, 49, 2, 16
    c = nh * hd
    qkv = rs.randn(b_, n, 3 * c).astype(np.float32)
    bias = rs.randn(nh, n, n).astype(np.float32)
    mask = _mask(4, n) if mask_on else None
    g = rs.randn(b_, n, c).astype(np.float32)

    def loss(a, b):
        out = jax_window_attention(a, b, None if mask is None
                                   else jnp.asarray(mask), num_heads=nh,
                                   wblk=4, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv),
                                          jnp.asarray(bias))
    leaves = [torch.from_numpy(qkv).requires_grad_(),
              torch.from_numpy(bias).requires_grad_()]
    out = window_attention(*leaves, None if mask is None
                           else torch.from_numpy(mask), nh)
    out.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('b,hp,wp,shift', [(2, 21, 28, 0), (2, 21, 28, 3),
                                           (1, 28, 14, 3)])
def test_swin_attention_matches_pallas(b, hp, wp, shift):
    rs = np.random.RandomState(2)
    nh, hd, ws = 2, 16, 7
    c = nh * hd
    qkv = rs.randn(b, hp, wp, 3 * c).astype(np.float32)
    bias = rs.randn(nh, ws * ws, ws * ws).astype(np.float32)
    want = jax_swin_window_attention(jnp.asarray(qkv), jnp.asarray(bias), ws,
                                     shift, nh, interpret=True)
    got = swin_window_attention(torch.from_numpy(qkv),
                                torch.from_numpy(bias), ws, shift, nh)
    assert tuple(got.shape) == (b, hp, wp, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, swin_attention_reference(
        torch.from_numpy(qkv), torch.from_numpy(bias), ws, shift, nh))


@pytest.mark.parametrize('b,hp,wp,shift', [
    (2, 21, 28, 0), (2, 21, 28, 3), (1, 28, 14, 3), (2, 7, 21, 3),
    (1, 14, 7, 3), (1, 7, 7, 3), (1, 7, 14, 0)])
def test_swin_attention_kernel_form_matches_pallas(b, hp, wp, shift):
    """The tensor-core kernel's form of row 15 against the Pallas kernel:
    no shift and shift 3, batch 2, non-square maps, and the edge maps
    Hp = 7 and Wp = 7, where every window lies in the last window row or
    column and wraps."""
    rs = np.random.RandomState(5)
    nh, hd, ws = 2, 16, 7
    c = nh * hd
    qkv = rs.randn(b, hp, wp, 3 * c).astype(np.float32)
    bias = rs.randn(nh, ws * ws, ws * ws).astype(np.float32)
    want = jax_swin_window_attention(jnp.asarray(qkv), jnp.asarray(bias), ws,
                                     shift, nh, interpret=True)
    got = swin_attention_kernel_form(torch.from_numpy(qkv),
                                     torch.from_numpy(bias), ws, shift, nh)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hp, wp, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_swin_attention_kernel_form_matches_pallas_in_bf16():
    """The same in bf16 on both sides (logits and softmax in fp32, P
    rounded to bf16 before the product with v), held at 2e-2."""
    rs = np.random.RandomState(6)
    b, hp, wp, nh, hd, ws, shift = 2, 14, 21, 2, 16, 7, 3
    c = nh * hd
    qkv = jnp.asarray(rs.randn(b, hp, wp, 3 * c).astype(np.float32),
                      jnp.bfloat16)
    bias = rs.randn(nh, ws * ws, ws * ws).astype(np.float32)
    want = jax_swin_window_attention(qkv, jnp.asarray(bias), ws, shift, nh,
                                     interpret=True)
    got = swin_attention_kernel_form(
        torch.from_numpy(np.asarray(qkv, np.float32)).bfloat16(),
        torch.from_numpy(bias), ws, shift, nh)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, hp, wp, c)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_swin_attention_matches_the_blockwise_path():
    """Un-rolled, the full-map attention equals the backbone's own path:
    the roll + partition gather of window_gather_indices, window attention
    with shifted_window_attn_mask, and the inverse gather."""
    rs = np.random.RandomState(3)
    b, hp, wp, nh, hd, ws, shift = 1, 14, 21, 1, 8, 7, 3
    c = nh * hd
    qkv = torch.from_numpy(rs.randn(b, hp, wp, 3 * c).astype(np.float32))
    bias = torch.from_numpy(rs.randn(nh, ws * ws, ws * ws)
                            .astype(np.float32))
    idx, valid, inv_idx = window_gather_indices(hp, wp, ws, shift)
    assert valid.all()
    wins = qkv.reshape(b, hp * wp, 3 * c)[:, torch.from_numpy(idx)]
    mask = torch.from_numpy(shifted_window_attn_mask(hp, wp, ws, shift))
    attn = window_attention_reference(wins.reshape(-1, ws * ws, 3 * c), bias,
                                      mask, nh)
    expected = attn.reshape(b, -1, c)[:, torch.from_numpy(inv_idx)] \
        .reshape(b, hp, wp, c)
    out = torch.roll(swin_window_attention(qkv, bias, ws, shift, nh),
                     (shift, shift), (1, 2))
    np.testing.assert_allclose(out.numpy(), expected.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('shift', [0, 3])
def test_swin_attention_gradients_match_jax(shift):
    rs = np.random.RandomState(4)
    b, hp, wp, nh, hd, ws = 1, 14, 21, 2, 8, 7
    c = nh * hd
    qkv = rs.randn(b, hp, wp, 3 * c).astype(np.float32)
    bias = rs.randn(nh, ws * ws, ws * ws).astype(np.float32)

    def loss(q, bi):
        return jnp.sum(jax_swin_window_attention(q, bi, ws, shift, nh,
                                                 interpret=True) ** 2)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv),
                                          jnp.asarray(bias))
    leaves = [torch.from_numpy(qkv).requires_grad_(),
              torch.from_numpy(bias).requires_grad_()]
    (swin_window_attention(*leaves, ws, shift, nh) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
