"""The port's hand-written kernels against their plain versions on the
card, at small and ragged shapes that the main path does not reach (odd
widths, partial tiles, invalid rois). Marked ``cuda``: they skip without
a CUDA device and run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax, which this file does
not need.)

Tolerances: fp32 at 1e-4 (summation order; RoIAlign 1e-3 for one-ulp
sample coordinates, see chip_smoke.py), bf16 at 2e-2 (one rounding of
the output on each side). The backward kernels sum across blocks by fp32
atomics in a changing order and their entries cancel, so they are held
to a fraction of each output's largest entry (chip_smoke.py TOL_SUM).
The 3x3 conv, its filter gradient and the fused MLP run their
tensor-core kernels in bf16 and their SIMT kernels in fp32, so every case
runs in both. The fused MLP backward's fp32 weight gradients of a bf16 run
are held to a limit derived from the plain version's own summation-order
spread on the same inputs (ops/fused_mlp.py fused_mlp_bwd_limits).
The NMS kernel must equal its plain version exactly. The v4 attention
kernel keeps qkv and the attention output in fp32 where its plain version
rounds them to bf16, so in bf16 it is held to the plain version computed
in fp32 on the same bf16 inputs and rounded once.
"""
import pytest
import torch

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
                                   window_attention_v4_bwd_reference,
                                   window_attention_v4_op,
                                   window_attention_v4_reference)
from swindet_tpu_torch.models.backbones.swin import shifted_window_attn_mask

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


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(3, 5, 7, 33), (1, 1536), (1000, 96)])
def test_layer_norm(gen, dtype, shape):
    x = _randn(gen, *shape, dtype=dtype, scale=3.0)
    w, b = _randn(gen, shape[-1]), _randn(gen, shape[-1])
    _close(layer_norm(x, w, b), layer_norm_reference(x, w, b), dtype)


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
              (4, 14, 14, 256, 256), (2, 7, 37, 64, 64)]


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


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('out_size,ratio', [(7, 0), (14, 0), (7, 2)])
def test_roi_align(gen, dtype, out_size, ratio):
    feats = [_randn(gen, 2, h, w, 48, dtype=dtype)
             for h, w in ((40, 56), (20, 28), (10, 14), (5, 7))]
    rois = torch.tensor([
        [0, 0, 0, 30, 30], [1, 100, 60, 180, 150], [0, 10, 5, 220, 158],
        [1, 200, 140, 260, 200], [0, 50, 0, 52, 160], [1, 3, 3, 3, 3],
        [0, 0, 0, 224, 160], [5, 10, 10, 40, 40]], dtype=torch.float32)
    rois = rois.cuda()
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool).cuda()
    strides = (4, 8, 16, 32)
    got = roi_align(feats, rois, strides, out_size, ratio, roi_valid=valid)
    # the roi with batch index 5 is out of range: the kernel zeroes it
    want = multilevel_roi_align(feats, rois[:7], strides, out_size, ratio,
                                roi_valid=valid[:7])
    _close(got[:7], want, dtype, atol32=1e-3)
    assert got[6].abs().max() == 0 and got[7].abs().max() == 0


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
    shapes = [(2, h, w, 48) for h, w in ((40, 56), (20, 28), (10, 14),
                                          (5, 7))]
    rois = torch.tensor([
        [0, 0, 0, 30, 30], [1, 100, 60, 180, 150], [0, 10, 5, 220, 158],
        [1, 200, 140, 260, 200], [0, 50, 0, 52, 160], [1, 3, 3, 3, 3],
        [0, 0, 0, 224, 160], [0, 12, 8, 40, 36]],
        dtype=torch.float32).cuda()
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool).cuda()
    g = _randn(gen, 8, out_size, out_size, 48, dtype=dtype)
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


def _nms_case(gen, b, n, offset, valid_share=0.9):
    """Score-sorted proposal-like boxes over a 200 x 300 canvas, with
    batched_nms's class offsets where ``offset``."""
    u = torch.rand(b, n, 5, generator=gen)
    wh = 4 + 80 * u[..., 2:4]
    xy = u[..., :2] * torch.tensor([300.0, 200.0])
    boxes = torch.cat([xy, xy + wh], -1)
    if offset:
        boxes = boxes + (torch.randint(0, 80, (b, n, 1), generator=gen)
                         * 385.0)
    valid = torch.rand(b, n, generator=gen) < valid_share
    score = torch.where(valid, u[..., 4], -torch.inf)
    order = torch.sort(-score, dim=1, stable=True).indices
    take = lambda t: torch.gather(t, 1, order if t.ndim == 2 else
                                  order[..., None].expand(-1, -1, 4))
    return [t.cuda().contiguous() for t in (take(boxes), take(score),
                                            take(valid), order)]


@pytest.mark.parametrize('b,n,thr,max_out,offset', [
    (1, 300, 0.5, 100, False), (2, 1000, 0.7, 1000, True),
    (1, 4819, 0.7, 1000, True), (3, 65, 0.3, 8, False), (1, 1, 0.5, 4, False),
    (2, 2048, 0.5, 100, True)])
def test_nms_sorted(gen, b, n, thr, max_out, offset):
    args = _nms_case(gen, b, n, offset)
    got = nms_sorted(*args, thr, max_out)
    want = nms_sorted_reference(*args, thr, max_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


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
    (3, 49, 1024, 32, False)])
def test_window_attention_v4_fwd_and_bwd(gen, dtype, b_, n, c, nh, shift):
    """Stage 1 with the shift mask; stage-4 width (C 768, 24 heads) and
    Swin-B's (C 1,024, the most shared memory) at odd window counts; a
    4x4 window."""
    mask = None
    if shift:
        mask = torch.from_numpy(shifted_window_attn_mask(14, 21, 7, 3)).cuda()
    x, wqkv, bqkv, wproj, bproj = _v4_params(gen, b_, n, c, dtype)
    bias = _randn(gen, nh, n, n, scale=0.5)
    args = (wqkv, bqkv, bias, mask, wproj)
    got = window_attention_v4(x, *args, bproj, nh)
    want = window_attention_v4_reference(x.float(), *args, bproj, nh)
    _close(got, want.to(dtype), dtype)
    g = _randn(gen, b_, n, c, dtype=dtype)
    got = window_attention_v4_bwd(x, *args, g, nh)
    want = window_attention_v4_bwd_reference(x, *args, g, nh)
    for a, w in zip(got, want):
        _close_summed(a, w, w.dtype if w.dtype == dtype else torch.float32)


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
@pytest.mark.parametrize('b_,n,c,nh,nw', [(12, 49, 96, 3, 4),
                                          (5, 16, 32, 2, None),
                                          (3, 49, 768, 24, None)])
def test_window_attention_v1(gen, dtype, b_, n, c, nh, nw):
    qkv = _randn(gen, b_, n, 3 * c, dtype=dtype)
    bias = _randn(gen, nh, n, n, scale=0.5)
    mask = None
    if nw:
        mask = torch.zeros(nw, n, n)
        mask[1, :10, 10:] = mask[1, 10:, :10] = -100.0
        mask = mask.cuda()
    _close(window_attention(qkv, bias, mask, nh),
           window_attention_reference(qkv, bias, mask, nh), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('b,hp,wp,c,nh,shift', [
    (2, 21, 28, 32, 2, 0), (2, 21, 28, 32, 2, 3), (1, 28, 14, 96, 3, 3),
    (1, 14, 14, 768, 24, 3)])
def test_swin_window_attention(gen, dtype, b, hp, wp, c, nh, shift):
    qkv = _randn(gen, b, hp, wp, 3 * c, dtype=dtype)
    bias = _randn(gen, nh, 49, 49, scale=0.5)
    _close(swin_window_attention(qkv, bias, 7, shift, nh),
           swin_attention_reference(qkv, bias, 7, shift, nh), dtype)
    # a map height that is no multiple of the window
    with pytest.raises(ValueError):
        swin_window_attention(qkv[:, :hp - 1].contiguous(), bias, 7, shift,
                              nh)
