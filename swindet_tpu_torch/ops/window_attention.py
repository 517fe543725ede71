"""Swin window attention over head-major q, k, v (the v1 kernel), and the
plain window attention that every attention op of the port is held to.

Counterpart of ``swindet_tpu/ops/window_attention.py``.
:func:`window_attention` (``window_attention.py:60``) splits the packed
qkv projection into head-major (B_, nH, N, hd) q, k, v, as
``_window_attention_fwd_impl`` (:123-124) does, and runs a kernel of
``csrc/window_attention.cu`` (replacing the Pallas ``_wattn_kernel``,
:30) on a CUDA tensor, or the plain version
:func:`window_attention_reference` (:167) on a CPU tensor. On the card it
picks as the v3 forward does (``window_attention_v3.uses_tensor_cores``,
``kernel_symbol('heads', ...)``): bf16 with hd in {16, 32, 48, 64} runs
the tensor-core kernel ``swindet_window_attention_heads_tc`` (row 2's
``mma.sync`` forward staging head-major rows, its grid from
``window_attention_v3.fwd_geometry``; counted in
``window_attention.tc_launches`` as well as ``window_attention.launches``),
anything else the SIMT kernel ``swindet_window_attention_heads``.
Its backward recomputes through the plain version, as ``_wattn_vjp_bwd``
(:93) does: the JAX package has no backward kernel here.
"""
from __future__ import annotations

import ctypes
import functools
import importlib
from typing import Optional

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
# the last int is the SIMT kernel's dtype code or the tensor-core
# kernel's heads a block
_ARGTYPES = (_P,) * 6 + (_I,) * 5 + (ctypes.c_float, _I, _P)
MAX_TOKENS = 64
MAX_HEAD_DIM = 64


def attention_probs(qkv: torch.Tensor, bias: torch.Tensor,
                    mask: Optional[torch.Tensor], num_heads: int,
                    dtype: torch.dtype = torch.float32):
    """Softmax (B_, nH, N, N) of the window logits in ``dtype`` (fp32;
    float64 for a check's order spread), and v (B_, nH, N, hd)."""
    b_, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    scale = hd ** -0.5
    q, k, v = qkv.view(b_, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    attn = torch.einsum('bhnd,bhmd->bhnm', q.to(dtype) * scale, k.to(dtype))
    attn = attn + bias.to(dtype)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, num_heads, n, n) \
            + mask.to(dtype)[None, :, None]
        attn = attn.view(b_, num_heads, n, n)
    return torch.softmax(attn, dim=-1), v


def apply_probs(p: torch.Tensor, v: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """P v with P rounded to ``dtype`` and fp32 accumulation; (B_, N, C)
    in ``dtype``."""
    b_, nh, n, hd = v.shape
    out = torch.einsum('bhnm,bhmd->bhnd', p.to(dtype).float(), v.float())
    return out.transpose(1, 2).reshape(b_, n, nh * hd).to(dtype)


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor],
                               num_heads: int) -> torch.Tensor:
    """Plain version. qkv (B_, N, 3C) with [q | k | v] and heads
    contiguous; bias (nH, N, N); mask (nW, N, N) additive or None, window
    w reading mask[w % nW]. Logits and softmax in fp32; the probabilities
    are rounded to qkv's dtype before the product with v, accumulated in
    fp32. Returns (B_, N, C) in qkv's dtype."""
    p, v = attention_probs(qkv, bias, mask, num_heads)
    return apply_probs(p, v, qkv.dtype)


def check_attention_shapes(name: str, qkv: torch.Tensor, n: int, c3: int,
                           num_heads: int, bias: Optional[torch.Tensor],
                           mask: Optional[torch.Tensor], windows: int):
    """(C, hd, dtype code) of a kernel call over ``windows`` windows of
    ``n`` tokens and packed width ``c3``; raises on what the attention
    kernels do not take."""
    code = build.dtype_code(qkv, name)
    c = c3 // 3
    if c3 % 3 or c % num_heads:
        raise ValueError(f'{name}: qkv width {c3} does not split into 3 x '
                         f'{num_heads} heads')
    hd = c // num_heads
    if n > MAX_TOKENS or hd > MAX_HEAD_DIM:
        raise ValueError(f'{name}: N={n}, head dim {hd} over the kernel '
                         f'limits {MAX_TOKENS}, {MAX_HEAD_DIM}')
    if not qkv.is_contiguous():
        raise ValueError(f'{name}: qkv must be contiguous')
    tables = [('bias', bias, (num_heads, n, n))] if bias is not None else []
    if mask is not None:
        tables.append(('mask', mask, (mask.shape[0], n, n)))
        if mask.shape[0] == 0 or windows % mask.shape[0]:
            raise ValueError(f'{name}: {mask.shape[0]} mask windows do not '
                             f'divide B_={windows}')
    for tname, t, shape in tables:
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != qkv.device or not t.is_contiguous():
            raise ValueError(f'{name}: {tname} must be a contiguous fp32 '
                             f'{shape} tensor on {qkv.device}')
    return c, hd, code


@functools.cache
def _v3():
    """The v3 module, whose dispatch and grid the tensor-core kernel
    shares; imported at first use, as it imports this module's plain
    version (by name: the package's ``window_attention_v3`` is the
    function)."""
    return importlib.import_module(f'{__package__}.window_attention_v3')


def _forward(qkv: torch.Tensor, bias: torch.Tensor,
             mask: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    if qkv.device.type == 'cpu':
        return window_attention_reference(qkv, bias, mask, num_heads)
    if qkv.device.type != 'cuda':
        raise ValueError(f'window_attention: unsupported device '
                         f'{qkv.device}')
    v3 = _v3()
    b_, n, c3 = qkv.shape
    c, hd, code = check_attention_shapes('window_attention', qkv, n, c3,
                                         num_heads, bias, mask, b_)
    q, k, v = qkv.view(b_, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4) \
        .contiguous()
    out = torch.empty((b_, n, c), dtype=qkv.dtype, device=qkv.device)
    tc = v3.uses_tensor_cores(qkv.dtype, hd)
    last = v3.fwd_geometry(b_, num_heads, v3._sms(qkv.device)) if tc \
        else code
    fn = build.bind('window_attention',
                    v3.kernel_symbol('heads', qkv.dtype, hd), _ARGTYPES)
    with torch.cuda.device(qkv.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    bias.data_ptr(), None if mask is None else mask.data_ptr(),
                    out.data_ptr(), b_, n, c, num_heads,
                    1 if mask is None else mask.shape[0], hd ** -0.5, last,
                    build.stream_ptr(qkv.device))
    build.check_launch('window_attention', status)
    window_attention.launches += 1
    window_attention.tc_launches += tc
    return out


class _WindowAttentionFunction(torch.autograd.Function):
    """``_window_attention_vjp``: the kernel forward saves (qkv, bias,
    mask); the backward recomputes through the plain version and gives
    (dqkv, dBias), no gradient for the mask."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.num_heads = num_heads
        return _forward(qkv, bias, mask, num_heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = (qkv.detach().requires_grad_(),
                      bias.detach().requires_grad_())
            out = window_attention_reference(*leaves, mask, ctx.num_heads)
            dqkv, dbias = torch.autograd.grad(out, leaves, g)
        return dqkv, dbias, None, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor],
                     num_heads: int) -> torch.Tensor:
    """Differentiable v1 window attention: qkv (B_, N, 3C), bias
    (nH, N, N) fp32, mask (nW, N, N) fp32 or None with nW dividing B_.
    Returns (B_, N, C) in qkv's dtype; ``window_attention.launches``
    counts the kernels' launches, ``window_attention.tc_launches`` the
    tensor-core kernel's."""
    return _WindowAttentionFunction.apply(qkv, bias, mask, num_heads)


window_attention.launches = 0
window_attention.tc_launches = 0
