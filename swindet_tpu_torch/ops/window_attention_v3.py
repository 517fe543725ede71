"""Swin window attention over the packed qkv projection: forward, the
training forward that also saves the softmax, and the backward.

Counterpart of ``swindet_tpu/ops/window_attention_v3.py``. Three kernels
of ``csrc/window_attention.cu``, each with its plain version beside it:

- :func:`window_attention_v3` (replacing the Pallas ``_wattn3_kernel``),
  plain version :func:`window_attention_reference` (counterpart of
  ``swindet_tpu/ops/window_attention.py:167``, kept in the port's
  ``ops/window_attention.py`` and imported here);
- :func:`window_attention_fwd_p` (``_wattn3_kernel_p``), plain version
  :func:`window_attention_fwd_p_reference`;
- :func:`window_attention_bwd` (``_wattn3_bwd_kernel``), plain version
  :func:`window_attention_bwd_reference`.

A wrapper runs its plain version on a CPU tensor and its kernel on a CUDA
tensor. :func:`window_attention_op` is the differentiable entry point
(``_wattn3_vjp``, :78-116): where a gradient is wanted it runs the
training forward and saves ``(qkv, P)``; otherwise the inference kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .window_attention import (apply_probs, attention_probs,
                               check_attention_shapes,
                               window_attention_reference)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P)
_FWD_P_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P)
_BWD_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P)


def window_attention_fwd_p_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                     mask: Optional[torch.Tensor],
                                     num_heads: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: the output of
    :func:`window_attention_reference` and the fp32 softmax laid out
    (nH, B_, N, N)."""
    p, v = attention_probs(qkv, bias, mask, num_heads)
    return apply_probs(p, v, qkv.dtype), p.transpose(0, 1).contiguous()


def window_attention_bwd_reference(qkv: torch.Tensor, p: torch.Tensor,
                                   g: torch.Tensor, num_heads: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward from the saved fp32 softmax p
    (nH, B_, N, N) and the output gradient g (B_, N, C): dqkv (B_, N, 3C)
    in qkv's dtype and dBias (nH, N, N) fp32 summed over the windows."""
    b_, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    scale = hd ** -0.5
    q, k, v = qkv.float().view(b_, n, 3, num_heads, hd) \
        .permute(2, 0, 3, 1, 4)
    q = q * scale
    gh = g.float().view(b_, n, num_heads, hd).transpose(1, 2)
    pw = p.transpose(0, 1)                                 # (B_, nH, N, N)
    dv = pw.transpose(-1, -2) @ gh
    dp = gh @ v.transpose(-1, -2)
    ds = pw * (dp - (dp * pw).sum(-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = ds.transpose(-1, -2) @ q
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4) \
        .reshape(b_, n, c3)
    return dqkv.to(qkv.dtype), ds.sum(0)


def _check(qkv, bias, mask, num_heads, name):
    """Shapes of a kernel call: (B_, N, C, hd, dtype code); raises on
    what the kernels do not take."""
    b_, n, c3 = qkv.shape
    c, hd, code = check_attention_shapes(name, qkv, n, c3, num_heads, bias,
                                         mask, b_)
    return b_, n, c, hd, code


def window_attention_v3(qkv: torch.Tensor, bias: torch.Tensor,
                        mask: Optional[torch.Tensor],
                        num_heads: int) -> torch.Tensor:
    """Fused window attention: qkv (B_, N, 3C), bias (nH, N, N) fp32,
    mask (nW, N, N) fp32 or None with nW dividing B_."""
    if qkv.device.type == 'cpu':
        return window_attention_reference(qkv, bias, mask, num_heads)
    if qkv.device.type != 'cuda':
        raise ValueError(f'window_attention_v3: unsupported device '
                         f'{qkv.device}')
    b_, n, c, hd, code = _check(qkv, bias, mask, num_heads,
                                'window_attention_v3')
    out = torch.empty((b_, n, c), dtype=qkv.dtype, device=qkv.device)
    fn = build.bind('window_attention', 'swindet_window_attention',
                    _ARGTYPES)
    with torch.cuda.device(qkv.device):
        status = fn(qkv.data_ptr(), bias.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), b_, n, c, num_heads,
                    1 if mask is None else mask.shape[0], hd ** -0.5, code,
                    build.stream_ptr(qkv.device))
    build.check_launch('window_attention_v3', status)
    window_attention_v3.launches += 1
    return out


window_attention_v3.launches = 0


def window_attention_fwd_p(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor], num_heads: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of :func:`window_attention_v3`, which also returns the
    fp32 softmax P laid out (nH, B_, N, N)."""
    if qkv.device.type == 'cpu':
        return window_attention_fwd_p_reference(qkv, bias, mask, num_heads)
    if qkv.device.type != 'cuda':
        raise ValueError(f'window_attention_fwd_p: unsupported device '
                         f'{qkv.device}')
    b_, n, c, hd, code = _check(qkv, bias, mask, num_heads,
                                'window_attention_fwd_p')
    out = torch.empty((b_, n, c), dtype=qkv.dtype, device=qkv.device)
    p = torch.empty((num_heads, b_, n, n), dtype=torch.float32,
                    device=qkv.device)
    fn = build.bind('window_attention', 'swindet_window_attention_fwd_p',
                    _FWD_P_ARGTYPES)
    with torch.cuda.device(qkv.device):
        status = fn(qkv.data_ptr(), bias.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), p.data_ptr(), b_, n, c, num_heads,
                    1 if mask is None else mask.shape[0], hd ** -0.5, code,
                    build.stream_ptr(qkv.device))
    build.check_launch('window_attention_fwd_p', status)
    window_attention_fwd_p.launches += 1
    return out, p


window_attention_fwd_p.launches = 0


def window_attention_bwd(qkv: torch.Tensor, p: torch.Tensor,
                         g: torch.Tensor, num_heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward from the saved softmax p (nH, B_, N, N) fp32 and the
    output gradient g (B_, N, C) in qkv's dtype: (dqkv, dBias)."""
    if qkv.device.type == 'cpu':
        return window_attention_bwd_reference(qkv, p, g, num_heads)
    if qkv.device.type != 'cuda':
        raise ValueError(f'window_attention_bwd: unsupported device '
                         f'{qkv.device}')
    b_, n, c, hd, code = _check(qkv, None, None, num_heads,
                                'window_attention_bwd')
    if g.dtype != qkv.dtype or tuple(g.shape) != (b_, n, c) \
            or g.device != qkv.device or not g.is_contiguous():
        raise ValueError(f'window_attention_bwd: g must be a contiguous '
                         f'{qkv.dtype} ({b_}, {n}, {c}) tensor')
    if p.dtype != torch.float32 or tuple(p.shape) != (num_heads, b_, n, n) \
            or p.device != qkv.device or not p.is_contiguous():
        raise ValueError(f'window_attention_bwd: p must be a contiguous fp32 '
                         f'({num_heads}, {b_}, {n}, {n}) tensor')
    dqkv = torch.empty_like(qkv)
    dbias = torch.zeros((num_heads, n, n), dtype=torch.float32,
                        device=qkv.device)
    fn = build.bind('window_attention', 'swindet_window_attention_bwd',
                    _BWD_ARGTYPES)
    with torch.cuda.device(qkv.device):
        status = fn(qkv.data_ptr(), p.data_ptr(), g.data_ptr(),
                    dqkv.data_ptr(), dbias.data_ptr(), b_, n, c, num_heads,
                    hd ** -0.5, code, build.stream_ptr(qkv.device))
    build.check_launch('window_attention_bwd', status)
    window_attention_bwd.launches += 1
    return dqkv, dbias


window_attention_bwd.launches = 0


class WindowAttentionFunction(torch.autograd.Function):
    """``_wattn3_vjp``: the forward saves (qkv, P); the backward returns
    (dqkv, dBias) and no gradient for the shift mask, which is a constant
    of the block geometry (:106-108)."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads):
        out, p = window_attention_fwd_p(qkv, bias, mask, num_heads)
        ctx.save_for_backward(qkv, p)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, p = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, p, g.contiguous(),
                                           ctx.num_heads)
        return dqkv, dbias, None, None


def window_attention_op(qkv: torch.Tensor, bias: torch.Tensor,
                        mask: Optional[torch.Tensor],
                        num_heads: int) -> torch.Tensor:
    """Differentiable window attention: the training forward and the
    backward kernels where a gradient is wanted, the inference kernel
    under ``no_grad`` / ``inference_mode``, so that inference does not
    pay for writing P."""
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return WindowAttentionFunction.apply(qkv, bias, mask, num_heads)
    return window_attention_v3(qkv, bias, mask, num_heads)
