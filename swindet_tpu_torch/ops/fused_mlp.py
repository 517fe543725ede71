"""Fused token MLP: fc1 -> exact-erf GELU -> fc2 over rows of tokens.

Counterpart of ``swindet_tpu/ops/fused_mlp.py``. :func:`fused_mlp` runs a
hand-written forward kernel (``csrc/fused_mlp.cu``, replacing the Pallas
``_mlp_kernel``) on a CUDA tensor and the plain version
:func:`fused_mlp_reference` on a CPU tensor; :func:`fused_mlp_bwd` runs the
backward kernels (replacing ``_mlp_bwd_kernel``) or
:func:`fused_mlp_bwd_reference`. On the card each picks its kernels by
dtype alone: bf16 runs the tensor-core kernels (TMA loads and wgmma,
counted in ``wrapper.tc_launches`` as well as ``wrapper.launches``; C, H
and Co multiples of 8, 16-byte aligned bases), fp32 the SIMT kernels.
:func:`fused_mlp_op` is the differentiable entry point
(``_fused_mlp_vjp``, :219-235): it saves x and the weights and recomputes
the hidden in the backward.

Weights take the port's ``nn.Linear`` layout: w1 (H, C), w2 (Co, H), in
x's dtype; biases fp32. Both versions compute what the TPU kernels
compute: h = x w1^T + b1 summed in fp32, GELU in fp32 with XLA's rational
erf (:28-50), the activation rounded to x's dtype before fc2, fc2 summed
in fp32 plus b2 and cast to x's dtype. The plain version's erf rounds
every operation, the kernel's may contract into fused multiply-adds: they
differ by a few fp32 ulps.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_FWD_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4 + (
    ctypes.c_void_p,)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 4 + (
    ctypes.c_void_p,)
# widest C or Co whose fp32 accumulators (SIMT) or resident boxes of x and
# g (tensor cores) fit the kernels' shared memory
MAX_WIDTH = 768
# the bf16 kernels' TMA needs rows and strides in multiples of 16 bytes
TC_MULTIPLE = 8
# A bf16 run's fp32 weight gradients (dw1, db1, dw2) are sums of products
# of a and dh, each rounded to bf16 from an fp32 sum whose order decides
# which way the rounding goes. The plain version against its variant with
# float64 sums (fused_mlp_bwd_reference_f64) shows that spread on the very
# inputs of a check; a kernel, summing in yet another order, is held to
# ORDER_SPREAD_FACTOR times it: each order lies about one spread from the
# float64 sums, so two orders up to twice it apart, and the factor leaves
# as much again for a draw whose largest deviation lands higher. Where
# few rows make flips of the rounding rare, one draw's spread may hold
# none of the larger ones while another order flips one, so the limit is
# never below the largest change one flip can make (fused_mlp_bwd_limits).
ORDER_SPREAD_FACTOR = 4

_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
# XLA's fp32 erf (ErfImpl32): x P(x^2) / Q(x^2) on x clamped to
# +-erfinv(1 - 2^-23)
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145,
              1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)
_ERF_CLAMP = 3.832506856900711


def _erf(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(-_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    p = x2 * _ERF_ALPHA[0] + _ERF_ALPHA[1]
    for c in _ERF_ALPHA[2:]:
        p = p * x2 + c
    q = x2 * _ERF_BETA[0] + _ERF_BETA[1]
    for c in _ERF_BETA[2:]:
        q = q * x2 + c
    return (x * p) / q


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + _erf(h * _SQRT_HALF))


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    cdf = 0.5 * (1.0 + _erf(h * _SQRT_HALF))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * h * h)
    return cdf + h * pdf


def fused_mlp_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: x (R, C) -> (R, Co) in x's dtype."""
    h = x.float() @ w1.float().t() + b1.float()
    a = _gelu(h).to(x.dtype)
    return (a.float() @ w2.float().t() + b2.float()).to(x.dtype)


def fused_mlp_bwd_reference(x: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            g: torch.Tensor):
    """Plain version of the backward (``_mlp_bwd_kernel``): the hidden
    recomputed, dW2 from the activation and g in x's dtype, dh rounded to
    x's dtype, every sum in fp32. Returns dx (R, C) in x's dtype and dw1
    (H, C), db1 (H,), dw2 (Co, H), db2 (Co,) in fp32."""
    xf, gf = x.float(), g.to(x.dtype).float()
    h = xf @ w1.float().t() + b1.float()
    a = _gelu(h).to(x.dtype).float()
    dw2 = gf.t() @ a
    db2 = g.float().sum(0)
    dh = ((gf @ w2.float()) * _gelu_grad(h)).to(x.dtype).float()
    dw1 = dh.t() @ xf
    db1 = dh.sum(0)
    dx = (dh @ w1.float()).to(x.dtype)
    return dx, dw1, db1, dw2, db2


def fused_mlp_bwd_reference_f64(x: torch.Tensor, w1: torch.Tensor,
                                b1: torch.Tensor, w2: torch.Tensor,
                                g: torch.Tensor):
    """:func:`fused_mlp_bwd_reference` with fc1 and g w2 summed in float64
    and rounded once to fp32, everything else the same: the plain version
    under another summation order. Returns dw1, db1, dw2."""
    xf, gf = x.float(), g.to(x.dtype).float()
    h = (x.double() @ w1.double().t()).float() + b1.float()
    a = _gelu(h).to(x.dtype).float()
    dh = ((gf.double() @ w2.double()).float()
          * _gelu_grad(h)).to(x.dtype).float()
    return dh.t() @ xf, dh.sum(0), gf.t() @ a


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each |t| (0 at 0)."""
    _, e = torch.frexp(t.float())
    return torch.where(t == 0, torch.zeros_like(t, dtype=torch.float32),
                       torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                                   e - 8))


def fused_mlp_bwd_limits(x: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         g: torch.Tensor, want, floor: float = 1e-4):
    """Limits on max |kernel - plain| of dw1, db1 and dw2 of a bf16 run,
    given ``want``, the plain version's (dx, dw1, db1, dw2, db2) on the
    same inputs: per output the largest of ``floor`` times its largest
    entry, ORDER_SPREAD_FACTOR times its spread (max |plain -
    fused_mlp_bwd_reference_f64|) and the largest change one rounding
    flip of a or dh can make in an entry (one bf16 step of the term times
    the largest factor it meets in its row)."""
    other = fused_mlp_bwd_reference_f64(x, w1, b1, w2, g)
    xf, gf = x.float(), g.to(x.dtype).float()
    h = xf @ w1.float().t() + b1.float()
    a = _gelu(h).to(x.dtype)
    dh = ((gf @ w2.float()) * _gelu_grad(h)).to(x.dtype)
    dh_ulp = _bf16_ulp(dh).amax(1)
    flip = ((xf.abs().amax(1) * dh_ulp).max().item(), dh_ulp.max().item(),
            (gf.abs().amax(1) * _bf16_ulp(a).amax(1)).max().item())
    return [max(floor * w.abs().max().item(),
                ORDER_SPREAD_FACTOR * (o - w).abs().max().item(), f)
            for w, o, f in zip((want[1], want[2], want[3]), other, flip)]


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The bf16 kernels' TMA reads need 16-byte aligned bases."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f'{name}: bf16 tensors must start on a '
                             f'16-byte boundary')


def _check(name, x, w1, b1, w2, extra):
    code = build.dtype_code(x, name)
    r, c = x.shape
    hid, co = w1.shape[0], w2.shape[0]
    for t_name, t, dtype, shape in (
            ('w1', w1, x.dtype, (hid, c)), ('b1', b1, torch.float32, (hid,)),
            ('w2', w2, x.dtype, (co, hid))) + extra:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f'{name}: {t_name} must be a contiguous {dtype} '
                             f'{shape} tensor on {x.device}')
    if not x.is_contiguous():
        raise ValueError(f'{name}: x must be contiguous')
    if max(c, co) > MAX_WIDTH:
        raise ValueError(f'{name}: widths {c}, {co} over {MAX_WIDTH}')
    if x.dtype == torch.bfloat16 and (c % TC_MULTIPLE or hid % TC_MULTIPLE
                                      or co % TC_MULTIPLE):
        raise ValueError(f'{name}: bf16 takes C, H and Co in multiples of '
                         f'{TC_MULTIPLE}, got {c}, {hid}, {co}')
    return code, r, c, hid, co


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """GELU(x w1^T + b1) w2^T + b2 of x (R, C); the (R, H) hidden never
    leaves the chip. On the card bf16 runs the tensor-core kernel, fp32
    the SIMT kernel."""
    if x.device.type == 'cpu':
        return fused_mlp_reference(x, w1, b1, w2, b2)
    if x.device.type != 'cuda' or x.ndim != 2:
        raise ValueError(f'fused_mlp: x must be (R, C) on a CUDA device, '
                         f'got {tuple(x.shape)} on {x.device}')
    code, r, c, hid, co = _check(
        'fused_mlp', x, w1, b1, w2,
        (('b2', b2, torch.float32, (w2.shape[0],)),))
    out = torch.empty((r, co), dtype=x.dtype, device=x.device)
    tc = code == build.DTYPE_CODES[torch.bfloat16]
    if tc:
        _check_aligned('fused_mlp', x, w1, w2)
    fn = build.bind('fused_mlp', 'swindet_fused_mlp_tc' if tc
                    else 'swindet_fused_mlp', _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), out.data_ptr(), r, c, hid,
                    co, build.stream_ptr(x.device))
    build.check_launch('fused_mlp', status)
    fused_mlp.launches += 1
    fused_mlp.tc_launches += tc
    return out


fused_mlp.launches = 0
fused_mlp.tc_launches = 0


def fused_mlp_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, g: torch.Tensor):
    """dx, dw1, db1, dw2, db2 of :func:`fused_mlp` for the output gradient
    g (R, Co) in x's dtype; dx in x's dtype, the rest fp32."""
    if x.device.type == 'cpu':
        return fused_mlp_bwd_reference(x, w1, b1, w2, g)
    if x.device.type != 'cuda' or x.ndim != 2:
        raise ValueError(f'fused_mlp_bwd: x must be (R, C) on a CUDA '
                         f'device, got {tuple(x.shape)} on {x.device}')
    code, r, c, hid, co = _check(
        'fused_mlp_bwd', x, w1, b1, w2,
        (('g', g, x.dtype, (x.shape[0], w2.shape[0])),))
    dev = x.device
    dx = torch.empty_like(x)
    dw1 = torch.zeros((hid, c), dtype=torch.float32, device=dev)
    db1 = torch.zeros((hid,), dtype=torch.float32, device=dev)
    dw2 = torch.zeros((co, hid), dtype=torch.float32, device=dev)
    db2 = torch.zeros((co,), dtype=torch.float32, device=dev)
    tc = code == build.DTYPE_CODES[torch.bfloat16]
    if tc:
        _check_aligned('fused_mlp_bwd', x, w1, w2, g)
    fn = build.bind('fused_mlp', 'swindet_fused_mlp_bwd_tc' if tc
                    else 'swindet_fused_mlp_bwd', _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), g.data_ptr(), dx.data_ptr(),
                    dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
                    db2.data_ptr(), r, c, hid, co, build.stream_ptr(dev))
    build.check_launch('fused_mlp_bwd', status)
    fused_mlp_bwd.launches += 1
    fused_mlp_bwd.tc_launches += tc
    return dx, dw1, db1, dw2, db2


fused_mlp_bwd.launches = 0
fused_mlp_bwd.tc_launches = 0


class FusedMlpFunction(torch.autograd.Function):
    """``fused_mlp`` with ``_fused_mlp_fwd`` / ``_fused_mlp_bwd``: saves x
    and the weights, and the backward kernel recomputes the hidden. The
    weight gradients come back in the weights' dtype (the bf16 copies),
    and autograd carries them on to the fp32 parameters."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        return fused_mlp(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_mlp_bwd(x, w1, b1, w2,
                                               g.to(x.dtype).contiguous())
        return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2


def fused_mlp_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`fused_mlp`."""
    return FusedMlpFunction.apply(x, w1, b1, w2, b2)
