"""The port's hand-written kernels against their plain versions on the
card, at small and ragged shapes that the main path does not reach (odd
widths, partial tiles, invalid rois). Marked ``cuda``: they skip without
a CUDA device and run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax, which this file does
not need.)

Tolerances: fp32 at 1e-4 (summation order; RoIAlign 1e-3 for one-ulp
sample coordinates, see chip_smoke.py), bf16 at 2e-2 (one rounding of
the output on each side). The backward kernels sum across blocks (by fp32
atomics in a changing order, but RoIAlign's, which sums in roi order and
is checked to repeat bit for bit) and their entries cancel, so they are
held to a fraction of each output's largest entry (chip_smoke.py
TOL_SUM).
The 3x3 conv, its filter gradient, the fused MLP and the window
attention's forward and backward (rows 2 and 7) run their tensor-core
kernels in bf16 and their SIMT kernels in fp32, so every case runs in
both. The fused MLP backward's fp32 weight gradients of a bf16 run
are held to a limit derived from the plain version's own summation-order
spread on the same inputs (ops/fused_mlp.py fused_mlp_bwd_limits).
The NMS kernel must equal its plain version exactly. The v4 attention
(rows 12 and 13) runs its tensor-core kernels in bf16 and its SIMT
kernels in fp32. Its forward is held in bf16 to the plain version
computed in fp32 on the same bf16 inputs and rounded once; its bf16
backward to the plain version with the tensor-core kernels' bf16
roundings (``tc_rounding``): dx at 1e-2 of its largest entry, the fp32
weight and bias gradients at limits derived on the same inputs
(ops/window_attention_v4.py window_attention_v4_bwd_limits), which the
plain version with one 64-row tile of g zeroed must exceed.
"""
import pytest
import torch

from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.ops import (conv3x3, conv3x3_dw, conv3x3_dw_reference,
                                   conv3x3_op, conv3x3_reference, fused_mlp,
                                   fused_mlp_bwd, fused_mlp_bwd_limits,
                                   fused_mlp_bwd_reference,
                                   fused_mlp_op, fused_mlp_reference,
                                   launch_counts, layer_norm, layer_norm_op,
                                   layer_norm_reference,
                                   multilevel_roi_align,
                                   multilevel_roi_align_backward,
                                   nms_sorted, nms_sorted_reference,
                                   reset_launch_counts, roi_align,
                                   roi_align_bwd, roi_align_op,
                                   tc_launch_counts,
                                   swin_attention_reference,
                                   swin_window_attention, window_attention,
                                   window_attention_bwd,
                                   window_attention_bwd_reference,
                                   window_attention_fwd_p,
                                   window_attention_fwd_p_reference,
                                   window_attention_op,
                                   window_attention_reference,
                                   window_attention_v3, window_attention_v4,
                                   window_attention_v4_bwd,
                                   window_attention_v4_bwd_limits,
                                   window_attention_v4_bwd_reference,
                                   window_attention_v4_op,
                                   window_attention_v4_reference)
from swindet_tpu_torch.models.backbones.swin import shifted_window_attn_mask

from chip_smoke import (CASCADE_CONFIG, LN_SHAPES, REPPOINTS_CONFIG,
                        RESNET_CONFIGS, SWINB_ATTN_STAGES, SWINB_LN_SHAPES,
                        ZOO_CONFIGS, ZOO_TRAINED, _crowded_rois,
                        _matched_errors, _set_class_logits, _spread_heads,
                        cascade_launches, reppoints_launches,
                        resnet_launches, zoo_launches)

cap_torch_threads()

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).cuda().to(dtype)


def _close(got, want, dtype, atol32=1e-4):
    tol = atol32 if dtype == torch.float32 else 2e-2
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


# (rows, C) of Swin-T's 32 norms on an 800x1344 canvas (chip_smoke.py
# LN_SHAPES), Swin-B's widest (2048), an odd width, ragged row counts,
# Swin-B's other widths (bf16 K 1, 2 and 4), and Swin-B's 56 norms on the
# same canvas (SWINB_LN_SHAPES)
LN_CASES = [(3, 5, 7, 33), (1, 1536), (1000, 96), *LN_SHAPES, (301, 2048),
            (2, 7, 192), (1000, 128), (301, 256), (301, 512), (301, 1024),
            *SWINB_LN_SHAPES]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', LN_CASES)
def test_layer_norm(gen, dtype, shape):
    """Both kernels against the plain version: the vector kernel where C
    is a multiple of the 16-byte vector (ln_geometry), the first kernel
    at C = 33 and for the same x copied to a base one element past a
    16-byte boundary."""
    x = _randn(gen, *shape, dtype=dtype, scale=3.0)
    w, b = _randn(gen, shape[-1]), _randn(gen, shape[-1])
    want = layer_norm_reference(x, w, b)
    _close(layer_norm(x, w, b), want, dtype)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=x.device)
    off = flat[1:].view(x.shape)
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16
    _close(layer_norm(off, w, b), want, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('n,c,nh,shift', [(49, 96, 3, True),
                                          (49, 64, 1, False),
                                          (16, 48, 3, False)])
def test_window_attention(gen, dtype, n, c, nh, shift):
    ws = int(n ** 0.5)
    mask = None
    b_ = 6
    if shift:
        mask = torch.from_numpy(shifted_window_attn_mask(
            2 * ws, 3 * ws, ws, ws // 2)).cuda()
        b_ = 2 * mask.shape[0]
    qkv = _randn(gen, b_, n, 3 * c, dtype=dtype)
    bias = _randn(gen, nh, n, n, scale=0.5)
    _close(window_attention_v3(qkv, bias, mask, nh),
           window_attention_reference(qkv, bias, mask, nh), dtype)


# ragged in every dimension; then the main path's widths (FPN P4, RPN P6,
# the mask head); and a width (37) that is no multiple of the box width
# the bf16 kernel picks for it (8 x 8 boxes)
CONV_CASES = [(2, 5, 9, 16, 24), (3, 14, 14, 128, 128), (1, 1, 70, 32, 200),
              (1, 50, 84, 256, 256), (1, 13, 21, 256, 256),
              (4, 14, 14, 256, 256), (2, 7, 37, 64, 64),
              (2, 7, 11, 256, 256)]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('relu', [False, True])
@pytest.mark.parametrize('shape', CONV_CASES)
def test_conv3x3(gen, dtype, relu, shape):
    b, h, w, c, co = shape
    x = _randn(gen, b, h, w, c, dtype=dtype)
    wt = _randn(gen, 3, 3, c, co, dtype=dtype, scale=0.1)
    bias = _randn(gen, co)
    _close(conv3x3(x, wt, bias, relu),
           conv3x3_reference(x, wt, bias, relu), dtype)


# rois at the borders, a thin tall one, one degenerate, the full-width
# sliver and the roi past every border of ROADMAP section 3 item 3, on
# 4 levels of a 160 x 224 canvas
ROI_CASES = [
    [0, 0, 0, 30, 30], [1, 100, 60, 180, 150], [0, 10, 5, 220, 158],
    [1, 200, 140, 260, 200], [0, 50, 0, 52, 160], [1, 3, 3, 3, 3],
    [0, 0, 0, 224, 160], [1, 0, 90, 224, 96], [1, -100, -60, 480, 420]]
ROI_LEVELS = ((40, 56), (20, 28), (10, 14), (5, 7))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('out_size,ratio', [(7, 0), (14, 0), (7, 2)])
def test_roi_align(gen, dtype, out_size, ratio):
    feats = [_randn(gen, 2, h, w, 48, dtype=dtype) for h, w in ROI_LEVELS]
    rois = torch.tensor(ROI_CASES + [[5, 10, 10, 40, 40]],
                        dtype=torch.float32).cuda()
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1, 1, 1],
                         dtype=torch.bool).cuda()
    strides = (4, 8, 16, 32)
    got = roi_align(feats, rois, strides, out_size, ratio, roi_valid=valid)
    # the roi with batch index 5 is out of range: the kernel zeroes it
    want = multilevel_roi_align(feats, rois[:9], strides, out_size, ratio,
                                roi_valid=valid[:9])
    _close(got[:9], want, dtype, atol32=1e-3)
    assert got[6].abs().max() == 0 and got[9].abs().max() == 0


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('out_size', [7, 14])
@pytest.mark.parametrize('n,c', [(256, 64), (512, 256), (2048, 64)])
def test_roi_align_crowded_and_deterministic(gen, dtype, out_size, n, c):
    """n rois piled on one 20 x 20-cell area of P2: every backward tile
    there sums many overlapping rois, and those keeping more than 64 are
    split over a cluster (512 rois at C 256 make 48 such items, more than
    the split kernel's 32 clusters; 2,048 rois take two scan rounds, each
    cut into runs). Two backward runs are equal bit for bit (no
    atomics)."""
    shapes = [(2, h, w, c) for h, w in ((64, 96), (32, 48), (16, 24),
                                        (8, 12))]
    feats = [_randn(gen, *s, dtype=dtype) for s in shapes]
    rois = _crowded_rois(gen, n, x0=100.0, y0=60.0)
    strides = (4, 8, 16, 32)
    _close(roi_align(feats, rois, strides, out_size),
           multilevel_roi_align(feats, rois, strides, out_size), dtype,
           atol32=1e-3)
    g = _randn(gen, n, out_size, out_size, c, dtype=dtype)
    got = roi_align_bwd(shapes, dtype, rois, g, strides, out_size)
    want = multilevel_roi_align_backward(shapes, dtype, rois, g, strides,
                                         out_size)
    for a, b in zip(got, want):
        _close_summed(a, b, dtype, tol32=1e-3)
    again = roi_align_bwd(shapes, dtype, rois, g, strides, out_size)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_roi_align_refuses_what_the_kernels_do_not_take(gen):
    """The kernels carry 8 channels in 16-byte pieces: C a multiple of 8,
    16-byte aligned bases; the backward holds up to 64 x 64 bins."""
    rois = torch.tensor([[0, 0, 0, 30, 30]], dtype=torch.float32).cuda()
    strides = (4, 8)
    feats = [_randn(gen, 1, 8, 8, 12), _randn(gen, 1, 4, 4, 12)]
    with pytest.raises(ValueError):
        roi_align(feats, rois, strides, 7)
    g = _randn(gen, 1, 7, 7, 12)
    with pytest.raises(ValueError):
        roi_align_bwd([f.shape for f in feats], torch.float32, rois, g,
                      strides, 7)
    flat = _randn(gen, 8 * 8 * 16 + 1)
    feats = [flat[1:].view(1, 8, 8, 16), _randn(gen, 1, 4, 4, 16)]
    assert feats[0].is_contiguous() and feats[0].data_ptr() % 16
    with pytest.raises(ValueError):
        roi_align(feats, rois, strides, 7)
    g = _randn(gen, 1, 65, 65, 16)
    with pytest.raises(ValueError):
        roi_align_bwd([f.shape for f in feats], torch.float32, rois, g,
                      strides, 65)


@pytest.mark.parametrize('dtype', DTYPES)
def test_conv_picks_its_kernel_by_dtype(gen, dtype):
    """bf16 runs the tensor-core kernels (tc_launches rises with
    launches), fp32 the SIMT kernels (tc_launches stays)."""
    x = _randn(gen, 2, 9, 11, 64, dtype=dtype)
    w = _randn(gen, 3, 3, 64, 64, dtype=dtype, scale=0.1)
    reset_launch_counts()
    conv3x3_op(x.requires_grad_(), w.requires_grad_(),
               _randn(gen, 64).requires_grad_(), True).sum().backward()
    tc = int(dtype == torch.bfloat16)
    # the forward, dx (the forward on g) and dw
    assert (conv3x3.launches, conv3x3_dw.launches) == (2, 1)
    counts = tc_launch_counts()
    assert (counts['conv3x3'], counts['conv3x3_dw']) == (2 * tc, tc)


def test_bf16_conv_refuses_what_tma_does_not_take(gen):
    """The tensor-core kernels read through TMA: channels in multiples of
    8 and 16-byte aligned bases."""
    for c, co in ((12, 16), (16, 12)):
        x = _randn(gen, 1, 4, 4, c, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            conv3x3(x, _randn(gen, 3, 3, c, co, dtype=torch.bfloat16),
                    _randn(gen, co))
        with pytest.raises(ValueError):
            conv3x3_dw(x, _randn(gen, 1, 4, 4, co, dtype=torch.bfloat16))
    flat = _randn(gen, 4 * 4 * 16 + 1, dtype=torch.bfloat16)
    x = flat[1:].view(1, 4, 4, 16)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = _randn(gen, 3, 3, 16, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        conv3x3(x, w, _randn(gen, 16))
    with pytest.raises(ValueError):
        conv3x3_dw(x, _randn(gen, 1, 4, 4, 16, dtype=torch.bfloat16))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = _randn(gen, 4, 8, 8, 24)
    with pytest.raises(ValueError):
        conv3x3(x, _randn(gen, 3, 3, 24, 32), _randn(gen, 32))
    with pytest.raises(TypeError):
        layer_norm(x.half(), _randn(gen, 24), _randn(gen, 24))
    with pytest.raises(ValueError):
        layer_norm(x.transpose(1, 2), _randn(gen, 24), _randn(gen, 24))
    with pytest.raises(ValueError):
        window_attention_v3(_randn(gen, 2, 81, 96), _randn(gen, 1, 81, 81),
                            None, 1)
    boxes = _randn(gen, 1, 10, 4)
    with pytest.raises(ValueError):
        nms_sorted(boxes, _randn(gen, 1, 10), torch.ones(1, 10).cuda(),
                   torch.arange(10).cuda()[None], 0.5, 5)
    # the kernels read a box in one 16-byte load
    with pytest.raises(ValueError):
        nms_sorted(_randn(gen, 41)[1:].view(1, 10, 4), _randn(gen, 1, 10),
                   torch.ones(1, 10, dtype=torch.bool).cuda(),
                   torch.arange(10).cuda()[None], 0.5, 5)
    w1, b1, w2, b2 = (_randn(gen, 96, 24), _randn(gen, 96),
                      _randn(gen, 24, 96), _randn(gen, 24))
    with pytest.raises(ValueError):
        fused_mlp(x.view(-1, 24), w1, b1.bfloat16(), w2, b2)
    with pytest.raises(ValueError):
        fused_mlp(x, w1, b1, w2, b2)


def _close_summed(got, want, dtype, tol32=1e-4):
    tol = tol32 if dtype == torch.float32 else 1e-2
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


def _attn_case(gen, dtype, n, c, nh, shift, b_=6):
    ws = int(n ** 0.5)
    mask = None
    if shift:
        mask = torch.from_numpy(shifted_window_attn_mask(
            2 * ws, 3 * ws, ws, ws // 2)).cuda()
        b_ = 2 * mask.shape[0]
    qkv = _randn(gen, b_, n, 3 * c, dtype=dtype)
    bias = _randn(gen, nh, n, n, scale=0.5)
    return qkv, bias, mask


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('n,c,nh,shift', [(49, 96, 3, True),
                                          (49, 64, 1, False),
                                          (16, 48, 3, False)])
def test_window_attention_fwd_p_and_bwd(gen, dtype, n, c, nh, shift):
    qkv, bias, mask = _attn_case(gen, dtype, n, c, nh, shift, b_=19)
    out, p = window_attention_fwd_p(qkv, bias, mask, nh)
    want_out, want_p = window_attention_fwd_p_reference(qkv, bias, mask, nh)
    _close(out, want_out, dtype)
    _close(p, want_p, torch.float32)
    g = _randn(gen, *out.shape, dtype=dtype)
    got = window_attention_bwd(qkv, want_p, g, nh)
    want = window_attention_bwd_reference(qkv, want_p, g, nh)
    _close_summed(got[0], want[0], dtype)
    _close_summed(got[1], want[1], torch.float32)


# rows 2 and 7 at the main path's shapes and at ragged ones: (B_, N, C,
# nH, padded map of the shift mask or None). The forward runs at the
# stage's windows of one request, the backward at twice as many (a
# training batch of 2): stage 1 (shifted) and stage 4 of an 800x1344
# canvas; 1,403 windows, whose last backward block (of 8 windows, at 132
# SMs) is partial; N 16 with hd 16; hd 64; a 14x21 map's 6 masks.
TC_ATTN_CASES = [(1392, 49, 96, 3, (203, 336)), (24, 49, 768, 24, None),
                 (24, 49, 768, 24, (28, 42)), (1403, 49, 96, 3, None),
                 (19, 16, 48, 3, None), (7, 49, 64, 1, None),
                 (6, 49, 96, 3, (14, 21))] + [
    # Swin-B's four stages (C 128-1,024, 4-32 heads), shifted
    (b_, 49, c, nh, hw) for b_, c, nh, hw in SWINB_ATTN_STAGES]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('b_,n,c,nh,shift_map', TC_ATTN_CASES)
def test_window_attention_picks_its_kernel(gen, dtype, b_, n, c, nh,
                                           shift_map):
    """bf16 runs the tensor-core kernels of rows 2, 6 and 7 (tc_launches
    rises with launches), fp32 the SIMT kernels; all are held to their
    plain versions with phase 3's limits (row 6's out at the input type's,
    its fp32 P at fp32's)."""
    ws = int(n ** 0.5)
    mask = None if shift_map is None else torch.from_numpy(
        shifted_window_attn_mask(*shift_map, ws, ws // 2)).cuda()
    qkv = _randn(gen, b_, n, 3 * c, dtype=dtype)
    bias = _randn(gen, nh, n, n, scale=0.5)
    reset_launch_counts()
    _close(window_attention_v3(qkv, bias, mask, nh),
           window_attention_reference(qkv, bias, mask, nh), dtype)
    qkv2 = _randn(gen, 2 * b_, n, 3 * c, dtype=dtype)
    out, p_got = window_attention_fwd_p(qkv2, bias, mask, nh)
    want_out, p = window_attention_fwd_p_reference(qkv2, bias, mask, nh)
    _close(out, want_out, dtype)
    _close(p_got, p, torch.float32)
    g = _randn(gen, 2 * b_, n, c, dtype=dtype)
    got = window_attention_bwd(qkv2, p, g, nh)
    want = window_attention_bwd_reference(qkv2, p, g, nh)
    _close_summed(got[0], want[0], dtype)
    _close_summed(got[1], want[1], torch.float32)
    tc = int(dtype == torch.bfloat16)
    assert (window_attention_v3.launches, window_attention_fwd_p.launches,
            window_attention_bwd.launches) == (1, 1, 1)
    counts = tc_launch_counts()
    assert (counts['window_attention_v3'], counts['window_attention_fwd_p'],
            counts['window_attention_bwd']) == (tc, tc, tc)


def test_bf16_window_attention_refuses_misaligned_rows(gen):
    """The tensor-core kernels copy rows in 16-byte pieces: a bf16 qkv
    (rows 2, 6 and 15) or g that does not start on a 16-byte boundary is
    refused, not run on the SIMT kernels."""
    flat = _randn(gen, 4 * 49 * 288 + 1, dtype=torch.bfloat16)
    qkv = flat[1:].view(4, 49, 288)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16
    bias = _randn(gen, 3, 49, 49)
    with pytest.raises(ValueError):
        window_attention_v3(qkv, bias, None, 3)
    with pytest.raises(ValueError):
        window_attention_fwd_p(qkv, bias, None, 3)
    # row 15 copies a pixel's row in the same 16-byte pieces
    with pytest.raises(ValueError):
        swin_window_attention(qkv.view(1, 14, 14, 288), bias, 7, 3, 3)
    good = qkv.clone()
    p = torch.full((3, 4, 49, 49), 1 / 49).cuda()
    gflat = _randn(gen, 4 * 49 * 96 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        window_attention_bwd(good, p, gflat[1:].view(4, 49, 96), 3)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(2, 5, 9, 24, 40)] + CONV_CASES[1:])
def test_conv3x3_dw(gen, dtype, shape):
    b, h, w, c, co = shape
    x = _randn(gen, b, h, w, c, dtype=dtype)
    g = _randn(gen, b, h, w, co, dtype=dtype)
    _close_summed(conv3x3_dw(x, g), conv3x3_dw_reference(x, g),
                  torch.float32)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('out_size,ratio', [(7, 0), (14, 0), (7, 2)])
def test_roi_align_bwd(gen, dtype, out_size, ratio):
    shapes = [(2, h, w, 48) for h, w in ROI_LEVELS]
    rois = torch.tensor(ROI_CASES + [[0, 12, 8, 40, 36]],
                        dtype=torch.float32).cuda()
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1, 1, 1],
                         dtype=torch.bool).cuda()
    g = _randn(gen, 10, out_size, out_size, 48, dtype=dtype)
    strides = (4, 8, 16, 32)
    got = roi_align_bwd(shapes, dtype, rois, g, strides, out_size, ratio,
                        roi_valid=valid)
    want = multilevel_roi_align_backward(shapes, dtype, rois, g, strides,
                                         out_size, ratio, roi_valid=valid)
    for a, b in zip(got, want):
        _close_summed(a, b, dtype, tol32=1e-3)


def test_autograd_ops_on_the_card_match_the_cpu(gen):
    """Each differentiable op's gradients, fp32, kernels on the card
    against the plain versions on the CPU."""
    def grads(fn, inputs, consts):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves, *consts)
        out.backward(torch.linspace(-1, 1, out.numel(), device=out.device)
                     .view(out.shape))
        return [t.grad for t in leaves]

    qkv, bias, mask = _attn_case(gen, torch.float32, 49, 96, 3, True)
    x = _randn(gen, 2, 9, 11, 128)
    w, b = _randn(gen, 3, 3, 128, 128, scale=0.05), _randn(gen, 128)
    feats = [_randn(gen, 2, h, w_, 32) for h, w_ in ((40, 56), (20, 28),
                                                     (10, 14), (5, 7))]
    rois = torch.tensor([[0, 0, 0, 30, 30], [1, 100, 60, 180, 150],
                         [0, 10, 5, 220, 158]], dtype=torch.float32).cuda()
    cases = [
        (lambda a, bb, m: window_attention_op(a, bb, m, 3), (qkv, bias),
         (mask,)),
        (lambda a, ww, bb: conv3x3_op(a, ww, bb, True), (x, w, b), ()),
        (layer_norm_op, (x, b, b), ()),
        (lambda f0, f1, f2, f3, r: roi_align_op([f0, f1, f2, f3], r,
                                                (4, 8, 16, 32), 7),
         feats, (rois,)),
    ]
    w1, b1 = _randn(gen, 512, 128, scale=0.1), _randn(gen, 512)
    w2, b2 = _randn(gen, 128, 512, scale=0.05), _randn(gen, 128)
    cases.append((fused_mlp_op, (x.view(-1, 128), w1, b1, w2, b2), ()))
    x4, wqkv, bqkv, wproj, bproj = _v4_params(gen, qkv.shape[0], 49, 96,
                                              torch.float32)
    cases += [
        (lambda a, wq, bq, bb, wp, bp, m: window_attention_v4_op(
            a, wq, bq, bb, m, wp, bp, 3), (x4, wqkv, bqkv, bias, wproj,
                                           bproj), (mask,)),
        (lambda a, bb, m: window_attention(a, bb, m, 3), (qkv, bias),
         (mask,)),
        (lambda a, bb: swin_window_attention(a, bb, 7, 3, 3),
         (_randn(gen, 2, 14, 21, 288), bias), ()),
    ]
    reset_launch_counts()
    for fn, inputs, consts in cases:
        on_card = grads(fn, inputs, consts)
        on_cpu = grads(fn, [t.cpu() for t in inputs],
                       [t.cpu() for t in consts])
        for a, c in zip(on_card, on_cpu):
            _close_summed(a.cpu(), c, torch.float32, tol32=1e-3)
    counts = launch_counts()
    # with a gradient wanted, attention runs the softmax-saving forward;
    # NMS is no differentiable op; the v1 and full-map attentions recompute
    # their backward through the plain version
    assert counts.pop('window_attention_v3') == 0
    assert counts.pop('nms_sorted') == 0
    assert all(v > 0 for v in counts.values()), counts
    # serving keeps to the inference kernel
    reset_launch_counts()
    with torch.inference_mode():
        window_attention_op(qkv, bias, mask, 3)
    assert launch_counts()['window_attention_fwd_p'] == 0
    assert launch_counts()['window_attention_v3'] == 1


def _nms_case(gen, b, n, layout, valid_share=0.9):
    """Score-sorted candidates. ``layout`` False: proposal-like boxes over
    a 200 x 300 canvas; True: the same with batched_nms's class offsets;
    'chain': after one box far away, boxes 10 px wide each 3 px right of
    the one before (IoU 0.538 with the next, 0.25 with the one after) with
    falling scores, so at IoU 0.5 every other one is kept and boxes 63 and
    127 suppress 64 and 128 across the scan's 64-box block edges;
    'disjoint': boxes that do not touch, all kept until max_out;
    'invalid': proposal-like boxes, none of them valid."""
    u = torch.rand(b, n, 5, generator=gen)
    wh = 4 + 80 * u[..., 2:4]
    xy = u[..., :2] * torch.tensor([300.0, 200.0])
    if layout in ('chain', 'disjoint'):
        x = torch.arange(n, dtype=torch.float32) * (3 if layout == 'chain'
                                                    else 20)
        x[0] = 5000.0 if layout == 'chain' else 0.0
        xy = torch.stack([x, torch.zeros(n)], -1).expand(b, n, 2)
        wh = torch.full((b, n, 2), 10.0)
        u[..., 4] = torch.linspace(1, 0.1, n)
        valid_share = 1.0
    boxes = torch.cat([xy, xy + wh], -1)
    if layout is True:
        boxes = boxes + (torch.randint(0, 80, (b, n, 1), generator=gen)
                         * 385.0)
    if layout == 'invalid':
        valid_share = 0.0
    valid = torch.rand(b, n, generator=gen) < valid_share
    score = torch.where(valid, u[..., 4], -torch.inf)
    order = torch.sort(-score, dim=1, stable=True).indices
    take = lambda t: torch.gather(t, 1, order if t.ndim == 2 else
                                  order[..., None].expand(-1, -1, 4))
    return [t.cuda().contiguous() for t in (take(boxes), take(score),
                                            take(valid), order)]


# the main path's shapes and ragged ones; then cases aimed at the scan's
# 64-box blocks: a suppression chain across block edges, max_out reached
# at index 64 k + 5 inside a block, N one short of, at and one past whole
# blocks, every box invalid, and the training step's RPN (B 2, N 8,819)
@pytest.mark.parametrize('b,n,thr,max_out,layout', [
    (1, 300, 0.5, 100, False), (2, 1000, 0.7, 1000, True),
    (1, 4819, 0.7, 1000, True), (3, 65, 0.3, 8, False), (1, 1, 0.5, 4, False),
    (2, 2048, 0.5, 100, True),
    (2, 300, 0.5, 200, 'chain'), (1, 1000, 0.5, 1000, 'chain'),
    (1, 320, 0.5, 70, 'disjoint'), (2, 320, 0.5, 134, 'disjoint'),
    (1, 127, 0.3, 100, False), (1, 128, 0.3, 100, False),
    (1, 129, 0.3, 100, False), (2, 4095, 0.7, 1000, True),
    (2, 4096, 0.7, 1000, True), (2, 4097, 0.7, 1000, True),
    (2, 300, 0.5, 100, 'invalid'), (2, 8819, 0.7, 1000, True)])
def test_nms_sorted(gen, b, n, thr, max_out, layout):
    args = _nms_case(gen, b, n, layout)
    got = nms_sorted(*args, thr, max_out)
    want = nms_sorted_reference(*args, thr, max_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    if layout == 'chain':
        assert want[2].tolist() == [min(max_out, 1 + n // 2)] * b
    if layout == 'disjoint':
        assert want[2].tolist() == [max_out] * b
    if layout == 'invalid':
        assert want[2].tolist() == [0] * b


def _mlp_case(gen, dtype, r, c, h):
    x = _randn(gen, r, c, dtype=dtype)
    w1 = _randn(gen, h, c, dtype=dtype, scale=c ** -0.5)
    w2 = _randn(gen, c, h, dtype=dtype, scale=h ** -0.5)
    b1, b2 = _randn(gen, h, scale=0.1), _randn(gen, c, scale=0.1)
    return x, w1, b1, w2, b2, _randn(gen, r, c, dtype=dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('r,c,h', [(100, 96, 384), (37, 48, 200),
                                   (130, 384, 1536), (64, 192, 768),
                                   (1037, 96, 384), (333, 192, 768),
                                   (2111, 384, 1536)])
def test_fused_mlp_fwd_and_bwd(gen, dtype, r, c, h):
    """bf16 runs the tensor-core kernels, fp32 the SIMT ones; the last
    three cases are stages 1-3 of Swin-T at row counts that are not
    multiples of the 64-row tile. dx and db2 are held to TOL_SUM of their
    largest entry; the fp32 weight gradients of a bf16 run to the limit
    derived from the plain version's summation-order spread on these
    inputs (fused_mlp_bwd_limits), which the plain version with one
    64-row tile of g zeroed must exceed."""
    x, w1, b1, w2, b2, g = _mlp_case(gen, dtype, r, c, h)
    _close(fused_mlp(x, w1, b1, w2, b2),
           fused_mlp_reference(x, w1, b1, w2, b2), dtype)
    got = fused_mlp_bwd(x, w1, b1, w2, g)
    want = fused_mlp_bwd_reference(x, w1, b1, w2, g)
    _close_summed(got[0], want[0], dtype)
    _close_summed(got[4], want[4], torch.float32)
    if dtype == torch.float32:
        for a, w in zip(got[1:4], want[1:4]):
            _close_summed(a, w, dtype)
        return
    limits = fused_mlp_bwd_limits(x, w1, b1, w2, g, want)
    for a, w, lim in zip(got[1:4], want[1:4], limits):
        assert torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= lim
    if r > 64:
        dropped = g.clone()
        dropped[:64] = 0
        control = fused_mlp_bwd_reference(x, w1, b1, w2, dropped)
        assert all((a - w).abs().max().item() > lim
                   for a, w, lim in zip(control[1:4], want[1:4], limits))


@pytest.mark.parametrize('dtype', DTYPES)
def test_fused_mlp_picks_its_kernel_by_dtype(gen, dtype):
    """bf16 runs the tensor-core kernels (tc_launches rises with
    launches), fp32 the SIMT kernels (tc_launches stays)."""
    x, w1, b1, w2, b2, _ = _mlp_case(gen, dtype, 70, 96, 384)
    reset_launch_counts()
    fused_mlp_op(x.requires_grad_(), w1.requires_grad_(),
                 b1.requires_grad_(), w2.requires_grad_(),
                 b2.requires_grad_()).float().sum().backward()
    tc = int(dtype == torch.bfloat16)
    assert (fused_mlp.launches, fused_mlp_bwd.launches) == (1, 1)
    counts = tc_launch_counts()
    assert (counts['fused_mlp'], counts['fused_mlp_bwd']) == (tc, tc)


def test_bf16_fused_mlp_refuses_what_tma_does_not_take(gen):
    """The tensor-core kernels read through TMA: C, H and Co in multiples
    of 8 and 16-byte aligned bases; nothing falls back to another
    kernel."""
    for c, h in ((36, 192), (48, 196)):
        x, w1, b1, w2, b2, g = _mlp_case(gen, torch.bfloat16, 70, c, h)
        with pytest.raises(ValueError):
            fused_mlp(x, w1, b1, w2, b2)
        with pytest.raises(ValueError):
            fused_mlp_bwd(x, w1, b1, w2, g)
    x, w1, b1, w2, b2, g = _mlp_case(gen, torch.bfloat16, 70, 48, 192)
    flat = _randn(gen, 70 * 48 + 1, dtype=torch.bfloat16)
    xo = flat[1:].view(70, 48)
    assert xo.is_contiguous() and xo.data_ptr() % 16
    reset_launch_counts()
    with pytest.raises(ValueError):
        fused_mlp(xo, w1, b1, w2, b2)
    with pytest.raises(ValueError):
        fused_mlp_bwd(xo, w1, b1, w2, g)
    assert (fused_mlp.launches, fused_mlp_bwd.launches) == (0, 0)


def _v4_params(gen, b_, n, c, dtype):
    """x (B_, N, C) in dtype and the fp32 projections of a v4 call."""
    return (_randn(gen, b_, n, c, dtype=dtype),
            _randn(gen, 3 * c, c, scale=c ** -0.5), _randn(gen, 3 * c,
                                                            scale=0.1),
            _randn(gen, c, c, scale=c ** -0.5), _randn(gen, c, scale=0.1))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('b_,n,c,nh,shift', [
    (12, 49, 96, 3, True), (7, 49, 768, 24, False), (5, 16, 48, 3, False),
    (3, 49, 1024, 32, False), (1392, 49, 96, 3, (203, 336)),
    (360, 49, 192, 6, (105, 168)), (96, 49, 384, 12, (56, 84)),
    (24, 49, 768, 24, (28, 42))])
def test_window_attention_v4_fwd_and_bwd(gen, dtype, b_, n, c, nh, shift):
    """Stage 1 with the shift mask of a 14x21 map; stage-4 width (C 768,
    24 heads) and Swin-B's (C 1,024) at odd window counts; a 4x4 window;
    and the four Swin-T stages of an 800x1344 canvas with their shift
    masks, the forward at a request's windows and the backward at a
    training batch's. bf16 runs the tensor-core kernels (rows 12 and 13),
    fp32 the SIMT ones; the bf16 backward is held to the rounding plain
    version (dx at 1e-2 of its largest entry, the fp32 outputs at the
    derived limits, which a zeroed 64-row tile of g must exceed), fp32 to
    the fp32 plain version at 1e-4."""
    mask, b_bwd = None, b_
    if shift:
        hw = (14, 21) if shift is True else shift
        mask = torch.from_numpy(shifted_window_attn_mask(*hw, 7, 3)).cuda()
        b_bwd = b_ if shift is True else 2 * b_
    x, wqkv, bqkv, wproj, bproj = _v4_params(gen, b_, n, c, dtype)
    bias = _randn(gen, nh, n, n, scale=0.5)
    args = (wqkv, bqkv, bias, mask, wproj)
    reset_launch_counts()
    got = window_attention_v4(x, *args, bproj, nh)
    want = window_attention_v4_reference(x.float(), *args, bproj, nh)
    _close(got, want.to(dtype), dtype)
    x = _randn(gen, b_bwd, n, c, dtype=dtype)
    g = _randn(gen, b_bwd, n, c, dtype=dtype)
    bf16 = dtype == torch.bfloat16
    got = window_attention_v4_bwd(x, *args, g, nh)
    want = window_attention_v4_bwd_reference(x, *args, g, nh,
                                             tc_rounding=bf16)
    tc = int(bf16)
    assert (window_attention_v4.launches, window_attention_v4_bwd.launches,
            window_attention_v4.tc_launches,
            window_attention_v4_bwd.tc_launches) == (1, 1, tc, tc)
    _close_summed(got[0], want[0], dtype)
    if not bf16:
        for a, w in zip(got[1:], want[1:]):
            _close_summed(a, w, torch.float32)
        return
    limits = window_attention_v4_bwd_limits(x, *args, g, nh, want)
    for a, w, lim in zip(got[1:], want[1:], limits):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= lim
    dropped = g.clone()
    dropped.view(-1, c)[:64] = 0
    control = window_attention_v4_bwd_reference(x, *args, dropped, nh,
                                                tc_rounding=True)
    assert all((a - w).abs().max().item() > lim
               for a, w, lim in zip(control[1:], want[1:], limits))


@pytest.mark.parametrize('dtype', DTYPES)
def test_window_attention_v4_picks_its_kernel_by_dtype(gen, dtype):
    """Through the differentiable op, bf16 runs the tensor-core forward
    and backward (tc_launches rises with launches), fp32 the SIMT ones;
    every gradient comes back finite and shaped as its leaf."""
    x, wqkv, bqkv, wproj, bproj = _v4_params(gen, 6, 49, 96, dtype)
    bias = _randn(gen, 3, 49, 49, scale=0.5)
    mask = torch.from_numpy(shifted_window_attn_mask(14, 21, 7, 3)).cuda()
    leaves = [t.requires_grad_() for t in (x, wqkv, bqkv, bias, wproj,
                                           bproj)]
    reset_launch_counts()
    out = window_attention_v4_op(*leaves[:4], mask, *leaves[4:], 3)
    out.float().sum().backward()
    tc = int(dtype == torch.bfloat16)
    assert (window_attention_v4.launches,
            window_attention_v4_bwd.launches) == (1, 1)
    counts = tc_launch_counts()
    assert (counts['window_attention_v4'],
            counts['window_attention_v4_bwd']) == (tc, tc)
    for t in leaves:
        assert t.grad.shape == t.shape and torch.isfinite(t.grad).all()


def test_bf16_window_attention_v4_refuses_misaligned_inputs(gen):
    """The tensor-core kernels copy rows of x and g in 16-byte pieces: a
    bf16 x or g that does not start on a 16-byte boundary is refused, not
    run on the SIMT kernels."""
    x, wqkv, bqkv, wproj, bproj = _v4_params(gen, 2, 49, 96, torch.bfloat16)
    bias = _randn(gen, 3, 49, 49)
    flat = _randn(gen, 2 * 49 * 96 + 1, dtype=torch.bfloat16)
    xo = flat[1:].view(2, 49, 96)
    assert xo.is_contiguous() and xo.data_ptr() % 16
    reset_launch_counts()
    with pytest.raises(ValueError):
        window_attention_v4(xo, wqkv, bqkv, bias, None, wproj, bproj, 3)
    with pytest.raises(ValueError):
        window_attention_v4_bwd(xo, wqkv, bqkv, bias, None, wproj, x, 3)
    with pytest.raises(ValueError):
        window_attention_v4_bwd(x, wqkv, bqkv, bias, None, wproj, xo, 3)
    assert (window_attention_v4.launches,
            window_attention_v4_bwd.launches) == (0, 0)


def test_window_attention_v4_refuses_what_the_kernel_does_not_take(gen):
    for b_, n, c, nh in ((2, 81, 96, 3), (2, 49, 256, 2), (2, 49, 1536, 24)):
        x, wqkv, bqkv, wproj, bproj = _v4_params(gen, b_, n, c,
                                                 torch.float32)
        bias = _randn(gen, nh, n, n)
        with pytest.raises(ValueError):
            window_attention_v4(x, wqkv, bqkv, bias, None, wproj, bproj, nh)
    x, wqkv, bqkv, wproj, bproj = _v4_params(gen, 2, 49, 96, torch.float32)
    bias = _randn(gen, 3, 49, 49)
    with pytest.raises(ValueError):
        window_attention_v4(x, wqkv.bfloat16(), bqkv, bias, None, wproj,
                            bproj, 3)
    with pytest.raises(ValueError):
        window_attention_v4_bwd(x, wqkv, bqkv, bias, None, wproj,
                                x.bfloat16(), 3)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('b_,n,c,nh,nw', [
    (12, 49, 96, 3, 4), (5, 16, 32, 2, None), (3, 49, 768, 24, None),
    (8, 49, 64, 4, 4), (7, 49, 144, 3, None), (6, 36, 96, 2, 2),
    (8, 49, 128, 2, 4), (5, 64, 256, 4, None), (4, 49, 72, 3, None)])
def test_window_attention_v1(gen, dtype, b_, n, c, nh, nw):
    """Row 14 at hd 32, 16, 48 and 64 (the tensor-core kernel in bf16:
    tc_launches rises with launches), masked and unmasked, and at hd 24
    (the SIMT kernel in both dtypes)."""
    qkv = _randn(gen, b_, n, 3 * c, dtype=dtype)
    bias = _randn(gen, nh, n, n, scale=0.5)
    mask = None
    if nw:
        mask = torch.zeros(nw, n, n)
        mask[1, :10, 10:] = mask[1, 10:, :10] = -100.0
        mask = mask.cuda()
    reset_launch_counts()
    _close(window_attention(qkv, bias, mask, nh),
           window_attention_reference(qkv, bias, mask, nh), dtype)
    tc = int(dtype == torch.bfloat16 and c // nh in (16, 32, 48, 64))
    assert window_attention.launches == 1
    assert tc_launch_counts()['window_attention'] == tc


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('b,hp,wp,c,nh,shift', [
    (2, 21, 28, 32, 2, 0), (2, 21, 28, 32, 2, 3), (1, 28, 14, 96, 3, 3),
    (1, 14, 14, 768, 24, 3), (1, 203, 336, 96, 3, 3),
    (1, 105, 168, 192, 6, 3), (1, 56, 84, 384, 12, 3),
    (1, 28, 42, 768, 24, 3), (1, 56, 84, 128, 4, 3), (2, 7, 21, 96, 3, 3),
    (1, 7, 7, 96, 3, 3), (1, 14, 21, 72, 3, 3)])
def test_swin_window_attention(gen, dtype, b, hp, wp, c, nh, shift):
    """Row 15 at small maps, at the four Swin-T stages of an 800x1344
    canvas, at Swin-B's stage-1 width (C 128, 4 heads) and on the edge maps
    Hp = 7 and Hp = Wp = 7, whose every window wraps: in bf16 with hd in
    {16, 32, 48, 64} each launch is the tensor-core kernel's, in fp32 and
    at hd 24 the SIMT kernel's."""
    qkv = _randn(gen, b, hp, wp, 3 * c, dtype=dtype)
    bias = _randn(gen, nh, 49, 49, scale=0.5)
    reset_launch_counts()
    _close(swin_window_attention(qkv, bias, 7, shift, nh),
           swin_attention_reference(qkv, bias, 7, shift, nh), dtype)
    tc = int(dtype == torch.bfloat16 and c // nh in (16, 32, 48, 64))
    assert swin_window_attention.launches == 1
    assert tc_launch_counts()['swin_window_attention'] == tc
    # a map height that is no multiple of the window
    with pytest.raises(ValueError):
        swin_window_attention(qkv[:, :hp - 1].contiguous(), bias, 7, shift,
                              nh)


def test_loader_batch_trains_on_a_portrait_canvas(gen, tmp_path):
    """The port's loader makes one batch on a 320x224 (H x W) portrait
    canvas from PNG files (two samples with different pad shapes), and
    make_train_step trains the flagship Mask R-CNN Swin-T (bf16) on it on
    the card: every logged value is finite and every training kernel of
    the default configuration launches."""
    from chip_smoke import CONFIG, portrait_batch
    from swindet_tpu_torch import init_detector
    from swindet_tpu_torch.engine import (build_lr_schedule,
                                          build_optimizer, make_train_step)
    from swindet_tpu_torch.ops import (KERNEL_WRAPPERS, OP_ONLY_KERNELS,
                                       TRAINING_KERNELS)
    batch = portrait_batch(str(tmp_path))
    model = init_detector(CONFIG, device='cuda', seed=0)
    cfg = model.cfg
    step = make_train_step(
        model, build_optimizer(model, dict(cfg.optimizer)),
        build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'], 100))
    reset_launch_counts()
    log = step({k: torch.from_numpy(v).cuda() for k, v in batch.items()},
               torch.Generator(device='cuda').manual_seed(0))
    assert log and all(torch.isfinite(torch.tensor(v)) for v in log.values())
    counts = launch_counts()
    for fn in TRAINING_KERNELS + (layer_norm, conv3x3, roi_align,
                                  nms_sorted):
        assert counts[fn.__name__] > 0, fn.__name__
    assert all(counts[fn.__name__] == 0 for fn in OP_ONLY_KERNELS)
    assert len(KERNEL_WRAPPERS) == 15


def _tiny_cascade(dtype):
    """The Swin-B cascade config's graph (three 4conv1fc heads with SyncBN
    and GIoU, three mask heads) at narrow widths whose 128-channel FPN,
    RPN and mask-head convs take the conv3x3 kernel."""
    from swindet_tpu_torch.models import build_detector
    from swindet_tpu_torch.utils import Config
    model = Config.fromfile(CASCADE_CONFIG).model
    model.backbone.update(embed_dim=32, depths=[1, 1, 1, 1],
                          num_heads=[1, 2, 4, 8], drop_path_rate=0.0)
    model.neck.update(in_channels=[32, 64, 128, 256], out_channels=128)
    model.rpn_head.update(in_channels=128, feat_channels=128)
    roi = model.roi_head
    roi.bbox_roi_extractor.out_channels = 128
    roi.mask_roi_extractor.out_channels = 128
    for head in roi.bbox_head:
        head.update(in_channels=128, conv_out_channels=128,
                    fc_out_channels=256)
    roi.mask_head.update(in_channels=128, conv_out_channels=128)
    net = build_detector(dict(model, dtype=dtype))
    net.init_weights(0)
    return net


def test_cascade_on_the_card_matches_the_cpu(gen):
    """A narrow CascadeRCNN of the Swin-B config: fp32 simple_test on the
    card (its kernels, each launched as cascade_launches derives) equals
    the CPU's (labels, boxes within 1e-2 px, mask probabilities within
    1e-3); a bf16 training forward on the card gives finite losses and
    moves every BN's running statistics."""
    cpu = _tiny_cascade('float32').eval()
    with torch.no_grad():
        cpu.rpn_head.rpn_cls.weight.mul_(100.0)
        for head in cpu.roi_head.bbox_head:
            head.fc_cls.weight.mul_(100.0)
    card = _tiny_cascade('float32')
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().eval()
    img = torch.randn(1, 224, 320, 3, generator=gen)
    shapes = torch.tensor([[224, 320]], dtype=torch.int32)
    sf = torch.ones(1, 4)
    with torch.no_grad():
        want = cpu.simple_test(img, shapes, sf)
        reset_launch_counts()
        got = card.simple_test(img.cuda(), shapes.cuda(), sf.cuda())
    assert launch_counts() == cascade_launches(card, training=False)
    got = {k: v.cpu() for k, v in got.items()}
    assert int(want['det_valid'].sum()) > 0
    assert torch.equal(got['det_valid'], want['det_valid'])
    assert torch.equal(got['labels'], want['labels'])
    assert (got['dets'] - want['dets']).abs().max() <= 1e-2
    assert (got['mask_probs'] - want['mask_probs']).abs().max() <= 1e-3

    train = _tiny_cascade('bfloat16').cuda().train()
    before = {k: v.clone() for k, v in train.named_buffers()
              if 'running' in k}
    b, h, w = 2, 224, 320
    boxes = torch.tensor([[[20., 30., 120., 150.], [150., 60., 300., 200.]]]
                         * b).cuda()
    masks = torch.zeros(b, 2, h, w, dtype=torch.uint8)
    masks[:, 0, 30:150, 20:120] = 1
    masks[:, 1, 60:200, 150:300] = 1
    shapes = torch.tensor([[h, w]] * b, dtype=torch.int32).cuda()
    reset_launch_counts()
    losses = train.forward_train(
        torch.randn(b, h, w, 3, generator=gen).cuda(), shapes, shapes,
        boxes, torch.ones(b, 2, dtype=torch.bool).cuda(),
        torch.tensor([[1, 7]] * b).cuda(), masks.cuda(),
        gen=torch.Generator(device='cuda').manual_seed(0))
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    assert launch_counts() == cascade_launches(train, training=True)
    assert all(torch.isfinite(v).all() for v in losses.values())
    assert all(not torch.equal(v, before[k])
               for k, v in train.named_buffers() if k in before)


def _tiny_reppoints(dtype):
    """The RepPoints Swin-T config's graph (FPN from start_level 1 with two
    stride-2 extra convs, 3 stacked convs a branch, the moment transform)
    at narrow widths whose 128-channel FPN and head convs take the conv3x3
    kernel."""
    from swindet_tpu_torch.models import build_detector
    from swindet_tpu_torch.utils import Config
    model = Config.fromfile(REPPOINTS_CONFIG).model
    model.pop('pretrained', None)
    model.backbone.update(embed_dim=32, depths=[1, 1, 1, 1],
                          num_heads=[1, 2, 4, 8], drop_path_rate=0.0)
    model.neck.update(in_channels=[32, 64, 128, 256], out_channels=128)
    model.bbox_head.update(in_channels=128, feat_channels=128,
                           point_feat_channels=128)
    net = build_detector(dict(model, dtype=dtype))
    net.init_weights(0)
    return net


def test_reppoints_on_the_card_matches_the_cpu(gen):
    """A narrow RepPointsDetector of the Swin-T config: fp32 simple_test on
    the card (its kernels, each launched as reppoints_launches derives)
    equals the CPU's (labels, boxes within 1e-2 px, scores within 1e-4),
    with the class output set as phase 13 sets it (its logits N(-12, 4^2)
    on the image); a bf16 training forward and
    backward on the card without gt_masks gives finite losses, launches
    as derived."""
    cpu = _tiny_reppoints('float32').eval()
    img = torch.randn(1, 224, 320, 3, generator=gen)
    _set_class_logits(cpu, img)
    card = _tiny_reppoints('float32')
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().eval()
    shapes = torch.tensor([[224, 320]], dtype=torch.int32)
    sf = torch.ones(1, 4)
    with torch.no_grad():
        want = cpu.simple_test(img, shapes, sf)
        reset_launch_counts()
        got = card.simple_test(img.cuda(), shapes.cuda(), sf.cuda())
    assert launch_counts() == reppoints_launches(card, training=False)
    got = {k: v.cpu() for k, v in got.items()}
    assert int(want['det_valid'].sum()) > 0
    assert torch.equal(got['det_valid'], want['det_valid'])
    assert torch.equal(got['labels'], want['labels'])
    assert (got['dets'][..., :4] - want['dets'][..., :4]).abs().max() <= 1e-2
    assert (got['dets'][..., 4] - want['dets'][..., 4]).abs().max() <= 1e-4

    train = _tiny_reppoints('bfloat16').cuda().train()
    b, h, w = 2, 224, 320
    boxes = torch.tensor([[[20.3, 30.1, 120.7, 150.2],
                           [150.4, 60.6, 300.1, 200.9]]] * b).cuda()
    shapes = torch.tensor([[h, w]] * b, dtype=torch.int32).cuda()
    reset_launch_counts()
    losses = train.forward_train(
        torch.randn(b, h, w, 3, generator=gen).cuda(), shapes, shapes,
        boxes, torch.ones(b, 2, dtype=torch.bool).cuda(),
        torch.tensor([[1, 7]] * b).cuda(), None,
        gen=torch.Generator(device='cuda').manual_seed(0))
    assert set(losses) == {'loss_cls', 'loss_pts_init', 'loss_pts_refine'}
    sum(losses.values()).backward()
    assert launch_counts() == reppoints_launches(train, training=True)
    assert all(torch.isfinite(v).all() for v in losses.values())
    assert train.bbox_head.moment_transfer.grad.abs().max() > 0


def _tiny_resnet_detector(which, dtype):
    """Faster R-CNN R-50's or RetinaNet R-50's config graph (frozen BN,
    frozen_stages=1; RetinaNet's FPN from start_level 1 with two stride-2
    extra convs and 4 tower convs a branch) on a ResNet-50 of base width
    16, its FPN and heads at 128 channels, which take the conv3x3
    kernel."""
    from swindet_tpu_torch.models import build_detector
    from swindet_tpu_torch.utils import Config
    model = Config.fromfile(RESNET_CONFIGS[which]).model
    model.pop('pretrained', None)
    model.backbone.update(base_channels=16)
    model.neck.update(in_channels=[64, 128, 256, 512], out_channels=128)
    if which == 'faster':
        model.rpn_head.update(in_channels=128, feat_channels=128)
        model.roi_head.bbox_roi_extractor.update(out_channels=128)
        model.roi_head.bbox_head.update(in_channels=128,
                                        fc_out_channels=256)
    else:
        model.bbox_head.update(in_channels=128, feat_channels=128)
    net = build_detector(dict(model, dtype=dtype))
    net.init_weights(0)
    return net


@pytest.mark.parametrize('which', ['faster', 'retina'])
def test_resnet_detector_on_the_card_matches_the_cpu(gen, which):
    """A narrow Faster R-CNN R-50 or RetinaNet R-50 of its config: fp32
    simple_test on the card (its kernels, each launched as resnet_launches
    derives) equals the CPU's (labels, boxes within 1e-2 px, scores within
    1e-2 for Faster R-CNN's spread heads as phase 5's, 1e-4 for RetinaNet's
    class output set as phase 14 sets it, its logits N(-19, 4^2)); a bf16
    training forward and backward on the card without gt_masks gives
    finite losses, launches as derived, and leaves the frozen BN's buffers
    as they were."""
    cpu = _tiny_resnet_detector(which, 'float32').eval()
    img = torch.randn(1, 224, 320, 3, generator=gen)
    if which == 'faster':
        _spread_heads(cpu)
        score_limit = 1e-2
    else:
        _set_class_logits(cpu, img, mean=-19.0,
                          conv=cpu.bbox_head.retina_cls, candidates=False)
        score_limit = 1e-4
    card = _tiny_resnet_detector(which, 'float32')
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().eval()
    shapes = torch.tensor([[224, 320]], dtype=torch.int32)
    sf = torch.ones(1, 4)
    with torch.no_grad():
        want = cpu.simple_test(img, shapes, sf)
        reset_launch_counts()
        got = card.simple_test(img.cuda(), shapes.cuda(), sf.cuda())
    assert launch_counts() == resnet_launches(card, training=False)
    got = {k: v.cpu() for k, v in got.items()}
    assert int(want['det_valid'].sum()) > 0
    assert torch.equal(got['det_valid'], want['det_valid'])
    assert torch.equal(got['labels'], want['labels'])
    assert (got['dets'][..., :4] - want['dets'][..., :4]).abs().max() <= 1e-2
    assert (got['dets'][..., 4] - want['dets'][..., 4]).abs().max() \
        <= score_limit

    train = _tiny_resnet_detector(which, 'bfloat16').cuda().train()
    before = {k: v.clone() for k, v in train.named_buffers()}
    b, h, w = 2, 224, 320
    boxes = torch.tensor([[[20.3, 30.1, 120.7, 150.2],
                           [150.4, 60.6, 300.1, 200.9]]] * b).cuda()
    shapes = torch.tensor([[h, w]] * b, dtype=torch.int32).cuda()
    reset_launch_counts()
    losses = train.forward_train(
        torch.randn(b, h, w, 3, generator=gen).cuda(), shapes, shapes,
        boxes, torch.ones(b, 2, dtype=torch.bool).cuda(),
        torch.tensor([[1, 7]] * b).cuda(), None,
        gen=torch.Generator(device='cuda').manual_seed(0))
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    assert launch_counts() == resnet_launches(train, training=True)
    assert all(torch.isfinite(v).all() for v in losses.values())
    assert all(torch.equal(v, before[k]) for k, v in train.named_buffers())
    assert train.backbone.layer1[0].conv1.weight.grad is None
    assert train.backbone.layer2[0].conv1.weight.grad.abs().max() > 0


def _tiny_zoo_detector(name, dtype):
    """A zoo config's graph on a ResNet-50 of base width 16 (GN in groups
    of 8), its FPN and heads at 128 channels, which take the conv3x3
    kernel; the C4 and DC5 heads at the narrow backbone's widths (256 and
    512 channels)."""
    from swindet_tpu_torch.models import build_detector
    from swindet_tpu_torch.utils import Config
    model = Config.fromfile(ZOO_CONFIGS[name]).model
    model.pop('pretrained', None)
    model.backbone.update(base_channels=16)
    norms = [model.backbone]
    if model.get('neck'):
        model.neck.update(in_channels=[64, 128, 256, 512], out_channels=128)
        norms.append(model.neck)
        c = 128
    else:
        c = 64 * 2 ** model.backbone.out_indices[-1]
    model.rpn_head.update(in_channels=c, feat_channels=c)
    roi = model.roi_head
    roi.bbox_roi_extractor.update(out_channels=c)
    if roi.bbox_roi_extractor.roi_layer.type != 'RoIAlign':
        roi.bbox_roi_extractor.roi_layer.update(deform_fc_channels=256)
    head_in = c
    if roi.get('shared_head'):
        roi.shared_head.update(base_channels=16)
        head_in = 16 * 2 ** roi.shared_head.stage * 4
    heads = roi.bbox_head if isinstance(roi.bbox_head, list) \
        else [roi.bbox_head]
    for h in heads:
        h.update(in_channels=head_in, fc_out_channels=256)
        norms.append(h)
    if roi.get('mask_head'):
        if roi.get('mask_roi_extractor'):
            roi.mask_roi_extractor.update(out_channels=c)
        roi.mask_head.update(in_channels=head_in, conv_out_channels=128)
        norms.append(roi.mask_head)
    for part in norms:
        if (part.get('norm_cfg') or {}).get('type') == 'GN':
            part.norm_cfg = dict(part.norm_cfg, num_groups=8)
    net = build_detector(dict(model, dtype=dtype))
    net.init_weights(0)
    return net


@pytest.mark.parametrize('name', list(ZOO_CONFIGS))
def test_zoo_detector_on_the_card_matches_the_cpu(gen, name):
    """A narrow detector of each zoo config: fp32 simple_test on the card
    (its kernels, each launched as zoo_launches derives) against the CPU's
    as phase 15's serving check holds them: features within 1e-3 of their
    largest entry, detections equal as sets (labels, the nearest box;
    _matched_errors), boxes within 1e-2 px, scores within 1e-2, rpn_cls
    and fc_cls spread as phase 5's. The narrow GN + ConvWS detector's fp32
    features sit 2.5e-4 apart (its zero-mean filters carry rounding
    far), which moves its detections past these limits: it is held at
    the features' limit, and phase 15 holds the full-width one's
    detections with the CPU's own noise beside them. For the four
    configs that train, a bf16 training forward and backward on the card
    gives finite losses and launches as derived and leaves the frozen
    BN's buffers as they were."""
    cpu = _tiny_zoo_detector(name, 'float32').eval()
    _spread_heads(cpu)
    img = torch.randn(1, 224, 320, 3, generator=gen)
    card = _tiny_zoo_detector(name, 'float32')
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().eval()
    shapes = torch.tensor([[224, 320]], dtype=torch.int32)
    sf = torch.ones(1, 4)

    def outputs(model, dev):
        with torch.no_grad():
            feats = model.extract_feat(img.to(dev))
            reset_launch_counts()
            out = model.simple_test(img.to(dev), shapes.to(dev), sf.to(dev))
        return ([f.cpu().float() for f in feats],
                {k: v.cpu() for k, v in out.items()}, None)
    want = outputs(cpu, 'cpu')
    got = outputs(card, 'cuda')
    assert launch_counts() == zoo_launches(card, training=False)
    assert int(want[1]['det_valid'].sum()) > 0
    feat_err, errs = _matched_errors(want, got)
    assert feat_err <= 1e-3
    if name == 'gn_ws':
        assert torch.isfinite(got[1]['dets']).all()
    else:
        assert errs is not None
        box_err, score_err, n = errs
        assert n > 0 and box_err <= 1e-2 and score_err <= 1e-2
    if name not in ZOO_TRAINED:
        return
    train = _tiny_zoo_detector(name, 'bfloat16').cuda().train()
    before = {k: v.clone() for k, v in train.named_buffers()}
    b, h, w = 2, 224, 320
    boxes = torch.tensor([[[20.3, 30.1, 120.7, 150.2],
                           [150.4, 60.6, 300.1, 200.9]]] * b).cuda()
    masks = torch.zeros(b, 2, h, w, dtype=torch.uint8)
    masks[:, 0, 40:140, 30:110] = 1
    masks[:, 1, 70:190, 160:290] = 1
    shapes = torch.tensor([[h, w]] * b, dtype=torch.int32).cuda()
    reset_launch_counts()
    losses = train.forward_train(
        torch.randn(b, h, w, 3, generator=gen).cuda(), shapes, shapes,
        boxes, torch.ones(b, 2, dtype=torch.bool).cuda(),
        torch.tensor([[1, 7]] * b).cuda(),
        masks.cuda() if train.roi_head.with_mask else None,
        gen=torch.Generator(device='cuda').manual_seed(0))
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    assert launch_counts() == zoo_launches(train, training=True)
    assert all(torch.isfinite(v).all() for v in losses.values())
    assert all(torch.equal(v, before[k]) for k, v in train.named_buffers())
    assert train.backbone.layer2[0].conv1.weight.grad.abs().max() > 0
