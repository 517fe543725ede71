"""Gradients of the port's kernel operators against the JAX package's
production ``custom_vjp``s with their Pallas kernels in interpret mode, as
tests/test_ops/ run them, on the same numpy inputs and cotangents (fp32).

Two layers each:
- the port's ``torch.autograd.Function`` (the ``*_op`` entry points) on
  the CPU, where it runs the plain versions, against ``jax.vjp`` through
  the JAX function with ``interpret=True``;
- each split plain version (softmax-saving forward, attention backward,
  conv filter gradient, RoIAlign backward) against the JAX kernel's own
  implementation function called alone, so that the function the card's
  kernel is held to is itself held to the TPU kernel.

Tolerances: window attention 2e-4, conv and RoIAlign 1e-4, LayerNorm
1e-5; fp32 sums in another order.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.models.backbones.swin import (relative_position_index,
                                               shifted_window_attn_mask)
from swindet_tpu.ops.conv3x3 import _conv3x3_dw, conv3x3 as jax_conv
from swindet_tpu.ops.layer_norm import layer_norm as jax_ln
from swindet_tpu.ops.roi_align import multilevel_roi_align as jax_roi
from swindet_tpu.ops.roi_align_pallas import (_roi_align_pallas_bwd_impl,
                                              multilevel_roi_align_pallas)
from swindet_tpu.ops.window_attention_v3 import (_wattn3_bwd_impl,
                                                 _wattn3_fwd_p_impl,
                                                 window_attention_v3
                                                 as jax_wattn)

from swindet_tpu_torch.ops import (conv3x3_dw, conv3x3_dw_reference,
                                   conv3x3_op, layer_norm_op,
                                   multilevel_roi_align_backward,
                                   roi_align_bwd, roi_align_op,
                                   window_attention_bwd,
                                   window_attention_bwd_reference,
                                   window_attention_fwd_p,
                                   window_attention_fwd_p_reference,
                                   window_attention_op)

T = torch.from_numpy


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _leaf(a):
    return T(np.array(a)).requires_grad_()


# ------------------------------------------------------------ layer norm
@pytest.mark.parametrize('shape', [(2, 7, 9, 96), (37, 192)])
def test_layer_norm_grads_match_jax(shape):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    s = rs.randn(shape[-1]).astype(np.float32)
    b = rs.randn(shape[-1]).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_ln(*a, interpret=True),
                     *map(jnp.asarray, (x, s, b)))
    want = vjp(jnp.asarray(g))
    leaves = [_leaf(a) for a in (x, s, b)]
    layer_norm_op(*leaves).backward(T(g))
    for got, w in zip(leaves, want):
        _close(got.grad, w, 1e-5)


# ------------------------------------------------------ window attention
def _attn_inputs(b_, c, nh, shift, seed=0):
    rs = np.random.RandomState(seed)
    n = 49
    qkv = rs.randn(b_, n, 3 * c).astype(np.float32)
    table = (rs.randn(169, nh) * 0.5).astype(np.float32)
    bias = table[relative_position_index(7, 7).reshape(-1)] \
        .reshape(n, n, nh).transpose(2, 0, 1).copy()
    mask = shifted_window_attn_mask(14, 21, 7, 3) if shift else None
    g = rs.randn(b_, n, c).astype(np.float32)
    return qkv, bias, mask, g


@pytest.mark.parametrize('shift', [False, True])
@pytest.mark.parametrize('c,nh', [(96, 3), (64, 2)])
def test_window_attention_grads_match_jax(shift, c, nh):
    qkv, bias, mask, g = _attn_inputs(12, c, nh, shift)
    jmask = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda q, b: jax_wattn(q, b, jmask, nh,
                                              interpret=True),
                       jnp.asarray(qkv), jnp.asarray(bias))
    dqkv, dbias = vjp(jnp.asarray(g))
    tq, tb = _leaf(qkv), _leaf(bias)
    got = window_attention_op(tq, tb, None if mask is None else T(mask), nh)
    _close(got.detach(), out, 1e-5)
    got.backward(T(g))
    _close(tq.grad, dqkv, 2e-4)
    _close(tb.grad, dbias, 2e-4)


@pytest.mark.parametrize('shift', [False, True])
def test_window_attention_split_plain_versions_match_pallas(shift):
    nh = 3
    qkv, bias, mask, g = _attn_inputs(12, 96, nh, shift, seed=1)
    jmask = jnp.asarray(mask if mask is not None
                        else np.zeros((1, 49, 49), np.float32))
    out, p = _wattn3_fwd_p_impl(jnp.asarray(qkv), jnp.asarray(bias), jmask,
                                nh, True)
    got_out, got_p = window_attention_fwd_p_reference(
        T(qkv), T(bias), None if mask is None else T(mask), nh)
    _close(got_out, out, 1e-5)
    _close(got_p, p, 1e-5)
    # the CPU wrappers are the plain versions
    w_out, w_p = window_attention_fwd_p(
        T(qkv), T(bias), None if mask is None else T(mask), nh)
    assert torch.equal(w_out, got_out) and torch.equal(w_p, got_p)

    dqkv, dbias = _wattn3_bwd_impl(jnp.asarray(qkv), p, jnp.asarray(g), nh,
                                   True)
    p_np = np.asarray(p)
    got_dqkv, got_dbias = window_attention_bwd_reference(
        T(qkv), T(p_np), T(g), nh)
    _close(got_dqkv, dqkv, 2e-4)
    _close(got_dbias, dbias, 2e-4)
    w_dqkv, w_dbias = window_attention_bwd(T(qkv), T(p_np), T(g), nh)
    assert torch.equal(w_dqkv, got_dqkv) and torch.equal(w_dbias, got_dbias)


@pytest.mark.parametrize('shift', [False, True])
def test_bf16_window_attention_split_plain_versions_match_pallas(shift):
    """bf16 qkv and g: the plain training forward and backward against
    the Pallas kernels' own implementations in interpret mode. Both keep
    P in fp32 (1e-5) and round the output once (the card's bf16 2e-2);
    the backward computes dS and dBias in fp32 from the fp32 P and rounds
    dqkv once to bf16, so dqkv is held as on the card, to 1e-2 of its
    largest entry (one bf16 unit of an entry), and dBias to 1e-4 of its
    largest (fp32 sums in another order)."""
    nh = 3
    qkv, bias, mask, g = _attn_inputs(12, 96, nh, shift, seed=3)
    qb, gb = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    jmask = jnp.asarray(mask if mask is not None
                        else np.zeros((1, 49, 49), np.float32))
    out, p = _wattn3_fwd_p_impl(qb, jnp.asarray(bias), jmask, nh, True)
    tq = T(np.asarray(qb, np.float32)).bfloat16()
    tg = T(np.asarray(gb, np.float32)).bfloat16()
    got_out, got_p = window_attention_fwd_p_reference(
        tq, T(bias), None if mask is None else T(mask), nh)
    assert got_out.dtype == torch.bfloat16
    _close(got_out.float(), np.asarray(out, np.float32), 2e-2)
    _close(got_p, p, 1e-5)

    dqkv, dbias = _wattn3_bwd_impl(qb, p, gb, nh, True)
    got_dqkv, got_dbias = window_attention_bwd_reference(
        tq, T(np.asarray(p)), tg, nh)
    assert got_dqkv.dtype == torch.bfloat16
    for got, want, tol in ((got_dqkv.float(), np.asarray(dqkv, np.float32),
                            1e-2), (got_dbias, np.asarray(dbias), 1e-4)):
        err = np.abs(got.numpy() - want).max()
        assert err <= tol * np.abs(want).max(), err


# ------------------------------------------------------------- conv 3x3
@pytest.mark.parametrize('relu', [False, True])
@pytest.mark.parametrize('hw', [(8, 12), (5, 7)])
def test_conv3x3_grads_match_jax(relu, hw):
    rs = np.random.RandomState(1)
    h, w_ = hw
    x = rs.randn(2, h, w_, 32).astype(np.float32)
    w = (rs.randn(3, 3, 32, 48) * 0.1).astype(np.float32)
    b = rs.randn(48).astype(np.float32)
    g = rs.randn(2, h, w_, 48).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_conv(*a, relu, True),
                       *map(jnp.asarray, (x, w, b)))
    want = vjp(jnp.asarray(g))
    leaves = [_leaf(a) for a in (x, w, b)]
    got = conv3x3_op(*leaves, relu)
    _close(got.detach(), out, 1e-4)
    got.backward(T(g))
    for name, leaf, ref in zip('xwb', leaves, want):
        _close(leaf.grad, ref, 1e-4)


def test_conv3x3_dw_plain_version_matches_pallas():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 6, 10, 32).astype(np.float32)
    g = rs.randn(2, 6, 10, 40).astype(np.float32)
    want = _conv3x3_dw(jnp.asarray(x), jnp.asarray(g), interpret=True)
    got = conv3x3_dw_reference(T(x), T(g))
    assert got.shape == (3, 3, 32, 40) and got.dtype == torch.float32
    _close(got, want, 1e-4)
    assert torch.equal(conv3x3_dw(T(x), T(g)), got)


# ------------------------------------------------------------- roi align
SHAPES = [(50, 84), (25, 42), (13, 21), (7, 11)]
STRIDES = (4, 8, 16, 32)
ROIS = np.array([
    [0, 0, 0, 30, 30],           # top-left corner
    [0, 300, 180, 360, 230],     # past the bottom-right border
    [1, 320, 10, 335, 190],      # tall right-edge sliver
    [0, 100, 0, 118, 470],       # oversize: no strip pass fits it
    [0, 2, 3, 40, 300],          # taller than the canvas
    [1, 40, 30, 200, 160],       # level 1
    [0, 20, 0, 336, 200],        # level 2
    [0, 10, 12, 60, 50],         # overlaps the first roi
    [0, 0, 0, 0, 0],             # padding roi
    [1, 0, 90, 336, 96],         # full-width sliver (wide strip pass)
    [1, -100, -60, 480, 420],    # past every border, level 3
], np.float32)
VALID = np.array([True] * 8 + [False, True, True])
# The last two rois: at 14 x 14 the JAX package's strip passes depart from
# the contract (swindet_tpu/ops/roi_align.py:93) for them, forward and
# backward alike (max |d| 0.06 and 1.4 against the exact forward), so
# they are held to the contract's gradient only.
STRIP_EXACT = slice(0, 9)


@pytest.fixture(scope='module')
def feats():
    rs = np.random.RandomState(2)
    return [rs.randn(2, h, w, 32).astype(np.float32) for h, w in SHAPES]


def _port_grads(feats, rois, valid, g, out_size):
    leaves = [_leaf(f) for f in feats]
    out = roi_align_op(leaves, T(rois), STRIDES, out_size,
                       roi_valid=T(valid))
    out.backward(T(g))
    return [leaf.grad for leaf in leaves]


@pytest.mark.parametrize('out_size', [7, 14])
def test_roi_align_grads_match_jax(feats, out_size):
    rois, valid = ROIS[STRIP_EXACT], VALID[STRIP_EXACT]
    rs = np.random.RandomState(3)
    g = rs.randn(len(rois), out_size, out_size, 32).astype(np.float32)
    _, vjp = jax.vjp(lambda fs: multilevel_roi_align_pallas(
        fs, jnp.asarray(rois), STRIDES, out_size,
        roi_valid=jnp.asarray(valid), interpret=True),
        [jnp.asarray(f) for f in feats])
    (want,) = vjp(jnp.asarray(g))
    # levels 0-2 hold rois (level 3 only the contract test's last roi)
    assert all(np.abs(np.asarray(ref)).max() > 0 for ref in want[:3])
    for got, ref in zip(_port_grads(feats, rois, valid, g, out_size), want):
        _close(got, ref, 1e-4)


@pytest.mark.parametrize('out_size', [7, 14])
def test_roi_align_grads_match_the_contract(feats, out_size):
    """Every roi, against the gradient of the JAX package's exact
    RoIAlign (the contract the port's forward computes)."""
    rs = np.random.RandomState(5)
    g = rs.randn(len(ROIS), out_size, out_size, 32).astype(np.float32)
    _, vjp = jax.vjp(lambda fs: jax_roi(
        fs, jnp.asarray(ROIS), STRIDES, out_size,
        roi_valid=jnp.asarray(VALID)), [jnp.asarray(f) for f in feats])
    (want,) = vjp(jnp.asarray(g))
    for got, ref in zip(_port_grads(feats, ROIS, VALID, g, out_size), want):
        _close(got, ref, 1e-4)


def test_roi_align_backward_plain_version_matches_pallas(feats):
    rs = np.random.RandomState(4)
    rois, valid = ROIS[STRIP_EXACT], VALID[STRIP_EXACT]
    g = rs.randn(len(rois), 14, 14, 32).astype(np.float32)
    want = _roi_align_pallas_bwd_impl(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois),
        jnp.asarray(valid), jnp.asarray(g), STRIDES, 14, 0, 56, True)
    shapes = [f.shape for f in feats]
    got = multilevel_roi_align_backward(shapes, torch.float32, T(rois),
                                        T(g), STRIDES, 14,
                                        roi_valid=T(valid))
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    wrapped = roi_align_bwd(shapes, torch.float32, T(rois), T(g), STRIDES,
                            14, roi_valid=T(valid))
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))
