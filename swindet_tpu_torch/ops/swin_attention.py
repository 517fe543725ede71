"""Shifted-window attention over the padded qkv map: roll, window
partition and attention in one kernel.

Counterpart of ``swindet_tpu/ops/swin_attention.py``.
:func:`swin_window_attention` (``swin_attention.py:118``) runs a kernel of
``csrc/window_attention.cu`` (replacing the Pallas ``_swin_attn_kernel``,
:46) on a CUDA tensor, or the plain version :func:`swin_attention_reference`
(:171) on a CPU tensor. On the card it picks as the v3 forward does
(``window_attention_v3.uses_tensor_cores``, ``kernel_symbol('swin', ...)``):
bf16 with hd in {16, 32, 48, 64} runs the tensor-core kernel
``swindet_swin_attention_tc`` (row 2's ``mma.sync`` forward staging each
window's tokens from their wrapped pixels, its grid from
``window_attention_v3.fwd_geometry``; counted in
``swin_window_attention.tc_launches`` as well as
``swin_window_attention.launches``), anything else the SIMT kernel
``swindet_swin_attention``; nothing falls back from one to the other.
:func:`swin_attention_kernel_form` computes the same function the way the
tensor-core kernel does, for the tests. The output is in rolled
coordinates, as the JAX kernel's; the caller un-rolls it. The backward
recomputes through the plain version, as ``_swin_vjp_bwd`` (:197) does.

The block's shift mask, :func:`shifted_window_attn_mask`, lives here, so
that the backbone (``models/backbones/swin.py``) and this op share it
without ``ops`` importing ``models``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import build
from .window_attention import (apply_probs, attention_probs,
                               check_attention_shapes,
                               window_attention_reference)
from .window_attention_v3 import (_sms, fwd_geometry, kernel_symbol,
                                  uses_tensor_cores)

_P = ctypes.c_void_p
_I = ctypes.c_int
# the last int is the SIMT kernel's dtype code or the tensor-core kernel's
# heads a block
_ARGTYPES = (_P,) * 3 + (_I,) * 7 + (ctypes.c_float, _I, _P)


@functools.lru_cache(maxsize=256)
def shifted_window_attn_mask(hp: int, wp: int, ws: int,
                             shift: int) -> Optional[np.ndarray]:
    """Additive (-100 / 0) mask (nW, N, N) for shifted windows, None when
    there is no shift (reference: swin_transformer.py:370-389)."""
    if shift == 0:
        return None
    img_mask = np.zeros((1, hp, wp, 1), np.float32)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    x = img_mask.reshape(1, hp // ws, ws, wp // ws, ws, 1)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = x[:, None, :] - x[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def swin_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                             ws: int, shift: int,
                             num_heads: int) -> torch.Tensor:
    """Plain version: roll by -shift, partition into ws x ws windows,
    :func:`window_attention_reference` with the block's shift mask, and
    reverse the partition. qkv (B, Hp, Wp, 3C) with Hp, Wp multiples of
    ws; returns (B, Hp, Wp, C) in rolled coordinates."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    if shift:
        qkv = torch.roll(qkv, (-shift, -shift), (1, 2))
    x = qkv.reshape(b, hp // ws, ws, wp // ws, ws, c3) \
        .permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c3)
    mask = shifted_window_attn_mask(hp, wp, ws, shift)
    mask = None if mask is None else torch.from_numpy(mask).to(qkv.device)
    out = window_attention_reference(x, bias, mask, num_heads)
    return out.reshape(b, hp // ws, wp // ws, ws, ws, c) \
        .permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)


def _regions(pos: torch.Tensor, extent: int, ws: int,
             shift: int) -> torch.Tensor:
    """Region of each rolled row (or column) ``pos`` of a map ``extent``
    long: 0 below extent - ws, 1 below extent - shift, 2 above (the
    reference's img_mask slices)."""
    return torch.where(pos < extent - ws, 0,
                       torch.where(pos < extent - shift, 1, 2))


def swin_attention_kernel_form(qkv: torch.Tensor, bias: torch.Tensor,
                               ws: int, shift: int,
                               num_heads: int) -> torch.Tensor:
    """Plain version in the form the tensor-core kernel computes it; only
    the tests use it. Window (b, wy, wx)'s token i sits at rolled position
    (y, x) = (ws wy + i // ws, ws wx + i % ws) and reads map pixel
    (y + shift, x + shift), less Hp or Wp where that passes the edge. Only
    a window of the last window row or column mixes shift regions, and
    only with a shift: there the logits get -100 where two tokens' region
    ids differ, 3 ry + rx from :func:`_regions`; every other window gets
    no mask. Each token's output goes to its rolled pixel (y, x). qkv
    (B, Hp, Wp, 3C); returns (B, Hp, Wp, C) in rolled coordinates."""
    b, hp, wp, c3 = qkv.shape
    c, nwy, nwx, n = c3 // 3, hp // ws, wp // ws, ws * ws
    dev = qkv.device
    wy = torch.arange(nwy, device=dev).repeat_interleave(nwx)[:, None]
    wx = torch.arange(nwx, device=dev).repeat(nwy)[:, None]
    i = torch.arange(n, device=dev)
    y, x = wy * ws + i // ws, wx * ws + i % ws           # (nW, N) rolled
    sy, sx = y + shift, x + shift
    sy = torch.where(sy >= hp, sy - hp, sy)
    sx = torch.where(sx >= wp, sx - wp, sx)
    wins = qkv.reshape(b, hp * wp, c3)[:, (sy * wp + sx).reshape(-1)]
    mask = None
    if shift:
        mixed = (wy == nwy - 1) | (wx == nwx - 1)        # (nW, 1)
        reg = 3 * _regions(y, hp, ws, shift) + _regions(x, wp, ws, shift)
        differ = mixed[:, :, None] & (reg[:, :, None] != reg[:, None, :])
        mask = torch.where(differ, -100.0, 0.0)
    p, v = attention_probs(wins.reshape(-1, n, c3), bias, mask, num_heads)
    attn = apply_probs(p, v, qkv.dtype).reshape(b, -1, c)
    out = torch.empty((b, hp * wp, c), dtype=qkv.dtype, device=dev)
    out[:, (y * wp + x).reshape(-1)] = attn
    return out.reshape(b, hp, wp, c)


def _forward(qkv: torch.Tensor, bias: torch.Tensor, ws: int, shift: int,
             num_heads: int) -> torch.Tensor:
    if qkv.device.type == 'cpu':
        return swin_attention_reference(qkv, bias, ws, shift, num_heads)
    if qkv.device.type != 'cuda' or qkv.ndim != 4:
        raise ValueError(f'swin_window_attention: qkv must be (B, Hp, Wp, 3C)'
                         f' on a CUDA device, got {tuple(qkv.shape)} on '
                         f'{qkv.device}')
    b, hp, wp, c3 = qkv.shape
    if hp % ws or wp % ws or not 0 <= shift < ws:
        raise ValueError(f'swin_window_attention: map {hp}x{wp} is not a '
                         f'multiple of ws={ws}, or shift {shift} is not in '
                         f'[0, ws)')
    windows = b * (hp // ws) * (wp // ws)
    c, hd, code = check_attention_shapes('swin_window_attention', qkv,
                                         ws * ws, c3, num_heads, bias, None,
                                         windows)
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    tc = uses_tensor_cores(qkv.dtype, hd)
    if tc:
        build.check_aligned('swin_window_attention', qkv)
    fn = build.bind('window_attention', kernel_symbol('swin', qkv.dtype, hd),
                    _ARGTYPES)
    last = fwd_geometry(windows, num_heads, _sms(qkv.device)) if tc \
        else code
    with torch.cuda.device(qkv.device):
        status = fn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, hp,
                    wp, c, num_heads, ws, shift, hd ** -0.5, last,
                    build.stream_ptr(qkv.device))
    build.check_launch('swin_window_attention', status)
    swin_window_attention.launches += 1
    swin_window_attention.tc_launches += tc
    return out


class _SwinAttentionFunction(torch.autograd.Function):
    """``_swin_attn_vjp``: the kernel forward saves (qkv, bias); the
    backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, qkv, bias, ws, shift, num_heads):
        ctx.save_for_backward(qkv, bias)
        ctx.args = (ws, shift, num_heads)
        return _forward(qkv, bias, ws, shift, num_heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = (qkv.detach().requires_grad_(),
                      bias.detach().requires_grad_())
            out = swin_attention_reference(*leaves, *ctx.args)
            dqkv, dbias = torch.autograd.grad(out, leaves, g)
        return dqkv, dbias, None, None, None


def swin_window_attention(qkv: torch.Tensor, bias: torch.Tensor, ws: int,
                          shift: int, num_heads: int) -> torch.Tensor:
    """Differentiable shifted-window attention over the padded qkv map
    (B, Hp, Wp, 3C); bias (nH, ws^2, ws^2) fp32. Returns (B, Hp, Wp, C) in
    rolled coordinates (un-roll with ``torch.roll(out, (shift, shift),
    (1, 2))``); ``swin_window_attention.launches`` counts the kernels'
    launches, ``swin_window_attention.tc_launches`` the tensor-core
    kernel's."""
    return _SwinAttentionFunction.apply(qkv, bias, ws, shift, num_heads)


swin_window_attention.launches = 0
swin_window_attention.tc_launches = 0
