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

from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.ops import (conv3x3_dw, conv3x3_dw_reference,
                                   conv3x3_op, layer_norm_op,
                                   multilevel_roi_align_backward,
                                   roi_align_bwd, roi_align_op,
                                   window_attention_bwd,
                                   window_attention_bwd_reference,
                                   window_attention_fwd_p,
                                   window_attention_fwd_p_reference,
                                   window_attention_op)

from chip_smoke import _crowded_rois

from .test_torch_ops import (SEP_ROIS, SEP_STRIP_EXACT, SEP_VALID,
                             separable_matrices)

cap_torch_threads()

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


# ----------------------------------------- roi align: the separable form
def _window_overlaps(roi, scale, y0, x0, tile):
    """The backward kernel's test of a roi against a tile: its window on
    the level, widened by a cell for rounding, meets the tile."""
    f32 = np.float32
    x1, y1, x2, y2 = (f32(f32(v) * f32(scale)) - f32(0.5) for v in roi[1:])
    return (np.floor(min(x1, x2)) - 1 <= x0 + tile - 1
            and np.floor(max(x1, x2)) + 2 >= x0
            and np.floor(min(y1, y2)) - 1 <= y0 + tile - 1
            and np.floor(max(y1, y2)) + 2 >= y0)


def separable_roi_align_backward(shapes, rois, g, strides, out_size,
                                 sampling_ratio=0, roi_valid=None,
                                 tile=None):
    """A_y^T . g . A_x per roi, added into its level ((B, H, W, C) each,
    fp64); nothing from invalid rois or rois whose batch index lies
    outside the batch. With ``tile``, every tile x tile block of every
    level and image is computed on its own, as the backward kernel does:
    from the rois, in index order, that pass its window test, each with A_y
    and A_x restricted to the tile, and written once."""
    grads = [np.zeros(s) for s in shapes]
    mats = separable_matrices(rois, [s[1:3] for s in shapes], strides,
                              out_size, sampling_ratio)
    for r, (l, ay, ax) in enumerate(mats):
        b = int(rois[r, 0])
        if (roi_valid is not None and not roi_valid[r]) \
                or not 0 <= b < shapes[l][0]:
            continue
        if tile is None:
            grads[l][b] += np.einsum('py,pqc,qx->yxc', ay.astype(np.float64),
                                     g[r], ax.astype(np.float64))
            continue
        h, w = shapes[l][1:3]
        for y0 in range(0, h, tile):
            for x0 in range(0, w, tile):
                if not _window_overlaps(rois[r], 1.0 / strides[l], y0, x0,
                                        tile):
                    continue
                grads[l][b, y0:y0 + tile, x0:x0 + tile] += np.einsum(
                    'py,pqc,qx->yxc', ay[:, y0:y0 + tile].astype(np.float64),
                    g[r], ax[:, x0:x0 + tile].astype(np.float64))
    return grads


def _sep_case(out_size, seed):
    """SEP_ROIS, a roi on level 1 and one on level 2, 24 rois piled on
    one 20 x 20-cell area of level 0; the output gradient."""
    more = np.array([[1, 40, 30, 200, 160], [0, 20, 0, 336, 200]],
                    np.float32)
    rois = np.concatenate([SEP_ROIS, more,
                           _crowded_rois(torch.Generator().manual_seed(seed),
                                         24, x0=100.0, y0=100.0,
                                         device='cpu').numpy()])
    valid = np.concatenate([SEP_VALID, np.ones(26, bool)])
    g = np.random.RandomState(seed).randn(len(rois), out_size, out_size,
                                          32).astype(np.float32)
    return rois, valid, g


@pytest.mark.parametrize('out_size,ratio', [(7, 0), (14, 0), (7, 2)])
def test_roi_align_separable_backward_matches_the_plain_version(
        feats, out_size, ratio):
    rois, valid, g = _sep_case(out_size, 7)
    keep = np.arange(len(rois)) != 9   # the plain version needs b < B
    shapes = [f.shape for f in feats]
    got = separable_roi_align_backward(shapes, rois[keep], g[keep], STRIDES,
                                       out_size, ratio, valid[keep])
    want = multilevel_roi_align_backward(shapes, torch.float32,
                                         T(rois[keep]), T(g[keep]), STRIDES,
                                         out_size, ratio,
                                         roi_valid=T(valid[keep]))
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


@pytest.mark.parametrize('out_size', [7, 14])
def test_roi_align_separable_backward_matches_pallas_and_the_contract(
        feats, out_size):
    """The Pallas backward in interpret mode on the rois where its strip
    passes keep the contract; the gradient of the JAX package's exact
    RoIAlign on every roi, the reversed one, the sliver and the roi past
    every border among them, at 1e-4 as everywhere; no gradient from the
    roi whose batch index is out of range."""
    rois, valid, g = _sep_case(out_size, 8)
    shapes = [f.shape for f in feats]
    exact = SEP_STRIP_EXACT
    got = separable_roi_align_backward(shapes, rois[exact], g[exact],
                                       STRIDES, out_size,
                                       roi_valid=valid[exact])
    want = _roi_align_pallas_bwd_impl(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois[exact]),
        jnp.asarray(valid[exact]), jnp.asarray(g[exact]), STRIDES,
        out_size, 0, 56, True)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    keep = np.arange(len(rois)) != 9
    _, vjp = jax.vjp(lambda fs: jax_roi(
        fs, jnp.asarray(rois[keep]), STRIDES, out_size,
        roi_valid=jnp.asarray(valid[keep])), [jnp.asarray(f) for f in feats])
    (want,) = vjp(jnp.asarray(g[keep]))
    got = separable_roi_align_backward(shapes, rois, g, STRIDES, out_size,
                                       roi_valid=valid)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


@pytest.mark.parametrize('out_size', [7, 14])
@pytest.mark.parametrize('tile', [16, 5])
def test_roi_align_separable_backward_by_tiles_sums_to_the_whole(
        feats, out_size, tile):
    """The backward kernel's tiling: every tile from the rois that pass
    its window test, with A restricted to it, gives the whole level; the
    test keeps no roi off a tile it touches."""
    rois, valid, g = _sep_case(out_size, 9)
    shapes = [f.shape for f in feats]
    whole = separable_roi_align_backward(shapes, rois, g, STRIDES,
                                         out_size, roi_valid=valid)
    tiled = separable_roi_align_backward(shapes, rois, g, STRIDES,
                                         out_size, roi_valid=valid,
                                         tile=tile)
    assert all(np.abs(w).max() > 0 for w in whole)
    for a, b in zip(tiled, whole):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


@pytest.mark.parametrize('out_size', [7, 14])
def test_roi_align_separable_backward_split_tiles_sum_to_the_whole(
        feats, out_size):
    """The backward's split of a crowded tile: its kept rois, in index
    order, cut into 4 contiguous runs (the r-th from kept * r // 4 to
    kept * (r + 1) // 4), each run summed on its own and the 4 sums added
    in rank order, give the tile of the whole level."""
    rois, valid, g = _sep_case(out_size, 10)
    shapes = [f.shape for f in feats]
    whole = separable_roi_align_backward(shapes, rois, g, STRIDES,
                                         out_size, roi_valid=valid)
    mats = separable_matrices(rois, [s[1:3] for s in shapes], STRIDES,
                              out_size)
    tile, parts, most = 16, 4, 0
    for l, (b_, h, w, c) in enumerate(shapes):
        for b in range(b_):
            for y0 in range(0, h, tile):
                for x0 in range(0, w, tile):
                    kept = [r for r, (lr, _, _) in enumerate(mats)
                            if lr == l and valid[r] and int(rois[r, 0]) == b
                            and _window_overlaps(rois[r], 1.0 / STRIDES[l],
                                                 y0, x0, tile)]
                    runs = [kept[len(kept) * k // parts:
                                 len(kept) * (k + 1) // parts]
                            for k in range(parts)]
                    assert sum(runs, []) == kept
                    most = max(most, len(kept))
                    got = np.zeros((min(tile, h - y0), min(tile, w - x0), c))
                    for run in runs:
                        part = np.zeros_like(got)
                        for r in run:
                            _, ay, ax = mats[r]
                            part += np.einsum(
                                'py,pqc,qx->yxc',
                                ay[:, y0:y0 + tile].astype(np.float64), g[r],
                                ax[:, x0:x0 + tile].astype(np.float64))
                        got += part
                    np.testing.assert_allclose(
                        got, whole[l][b, y0:y0 + tile, x0:x0 + tile],
                        rtol=0, atol=1e-9)
    assert most > parts   # some tile is split into runs of several rois
