"""Swin window attention with both projections folded in: the v4
configuration (``SWINDET_WATTN_V4=1``).

Counterpart of ``swindet_tpu/ops/window_attention_v4.py``:

    out = proj(window_attention(x Wqkv^T + bqkv)) + bproj

- :func:`window_attention_v4` runs the forward kernel of
  ``csrc/window_attention_v4.cu`` (replacing the Pallas ``_wattn4_kernel``,
  :74) on a CUDA tensor and the plain version
  :func:`window_attention_v4_reference` (:297, the JAX package's non-TPU
  path) on a CPU tensor;
- :func:`window_attention_v4_bwd` runs the backward kernels (replacing
  ``_wattn4_bwd_kernel``, :141) or :func:`window_attention_v4_bwd_reference`;
- :func:`window_attention_v4_op` is the differentiable entry point
  (``_wattn4_vjp``, :305-337): the forward saves only its inputs and the
  backward recomputes qkv and P.

Weights take the ``nn.Linear`` layout, Wqkv (3C, C) and Wproj (C, C), and
stay fp32 with their biases, as the JAX package passes its fp32
parameters; x, the output and dx are in the compute dtype. The kernels
keep qkv, P and the attention output in fp32 and round once, at the
output; the plain forward rounds qkv and the attention output to x's
dtype as the JAX reference does, so in bf16 the two differ by more than
one output rounding.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .window_attention import (MAX_HEAD_DIM, MAX_TOKENS, attention_probs,
                               window_attention_reference)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD_ARGTYPES = (_P,) * 8 + (_I,) * 5 + (_F, _I, _P)
_BWD_ARGTYPES = (_P,) * 15 + (_I,) * 5 + (_F, _I, _P)
# dynamic shared memory a block may use on the H100 (227 KB), and the
# floats of the staging tiles that share the logits' region
# (csrc/tile_gemm.cuh: 2 x 16 x 65)
SMEM_LIMIT = 232448
_STAGE_FLOATS = 2 * 16 * 65


def _forward_smem_bytes(n: int, c: int, num_heads: int) -> int:
    """Shared memory of the forward kernel's block: the N x C fp32
    attention output, one head's q, k, v and the logits."""
    hd = c // num_heads
    return 4 * (n * c + 3 * n * (hd + 1) + max(n * (n + 1), _STAGE_FLOATS))


def window_attention_v4_reference(x: torch.Tensor, wqkv: torch.Tensor,
                                  bqkv: torch.Tensor, bias: torch.Tensor,
                                  mask: Optional[torch.Tensor],
                                  wproj: torch.Tensor, bproj: torch.Tensor,
                                  num_heads: int) -> torch.Tensor:
    """Plain version, the unfused chain in x's dtype: qkv = x Wqkv^T +
    bqkv, :func:`window_attention_reference`, then the projection."""
    d = x.dtype
    qkv = F.linear(x, wqkv.to(d), bqkv.to(d))
    out = window_attention_reference(qkv, bias, mask, num_heads)
    return F.linear(out, wproj.to(d), bproj.to(d))


def window_attention_v4_bwd_reference(x: torch.Tensor, wqkv: torch.Tensor,
                                      bqkv: torch.Tensor, bias: torch.Tensor,
                                      mask: Optional[torch.Tensor],
                                      wproj: torch.Tensor, g: torch.Tensor,
                                      num_heads: int):
    """Plain version of the backward (``_wattn4_bwd_kernel``), written out
    in fp32 from x and the output gradient g as the kernels compute it:
    qkv and P recomputed, dx rounded to x's dtype. Returns dx (B_, N, C)
    and, fp32, dWqkv (3C, C), dbqkv (3C,), dBias (nH, N, N) summed over
    the windows, dWproj (C, C), dbproj (C,)."""
    b_, n, c = x.shape
    hd = c // num_heads
    scale = hd ** -0.5
    xf, gf = x.float(), g.float()
    qkv = F.linear(xf, wqkv.float(), bqkv.float())
    p, v = attention_probs(qkv, bias, mask, num_heads)
    attn = (p @ v).transpose(1, 2).reshape(b_ * n, c)
    g2 = gf.reshape(b_ * n, c)
    dwproj = g2.t() @ attn
    dbproj = g2.sum(0)
    da = (g2 @ wproj.float()).view(b_, n, num_heads, hd).transpose(1, 2)
    q, k = qkv.view(b_, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)[:2]
    q = q * scale
    dv = p.transpose(-1, -2) @ da
    dp = da @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = ds.transpose(-1, -2) @ q
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4) \
        .reshape(b_ * n, 3 * c)
    dwqkv = dqkv.t() @ xf.reshape(b_ * n, c)
    dx = (dqkv @ wqkv.float()).view(b_, n, c).to(x.dtype)
    return dx, dwqkv, dqkv.sum(0), ds.sum(0), dwproj, dbproj


def _check(name, x, wqkv, bqkv, bias, mask, wproj, num_heads, last):
    """Shapes of a kernel call: (B_, N, C, hd, dtype code); raises on
    what the kernels do not take. ``last``: (name, tensor, dtype, shape)
    of the final argument, bproj or g."""
    code = build.dtype_code(x, name)
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f'{name}: x must be a contiguous (B_, N, C) tensor')
    b_, n, c = x.shape
    if c % num_heads:
        raise ValueError(f'{name}: C={c} does not split into {num_heads} '
                         f'heads')
    hd = c // num_heads
    if n > MAX_TOKENS or hd > MAX_HEAD_DIM:
        raise ValueError(f'{name}: N={n}, head dim {hd} over the kernel '
                         f'limits {MAX_TOKENS}, {MAX_HEAD_DIM}')
    smem = _forward_smem_bytes(n, c, num_heads)
    if smem > SMEM_LIMIT:
        raise ValueError(f'{name}: N={n}, C={c}, head dim {hd} need {smem} '
                         f'bytes of shared memory, over a block\'s '
                         f'{SMEM_LIMIT}')
    f32 = torch.float32
    tables = [('wqkv', wqkv, f32, (3 * c, c)), ('bqkv', bqkv, f32, (3 * c,)),
              ('bias', bias, f32, (num_heads, n, n)),
              ('wproj', wproj, f32, (c, c)), last]
    if mask is not None:
        tables.append(('mask', mask, f32, (mask.shape[0], n, n)))
        if mask.shape[0] == 0 or b_ % mask.shape[0]:
            raise ValueError(f'{name}: {mask.shape[0]} mask windows do not '
                             f'divide B_={b_}')
    for tname, t, dtype, shape in tables:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f'{name}: {tname} must be a contiguous {dtype} '
                             f'{shape} tensor on {x.device}')
    return b_, n, c, hd, code


def window_attention_v4(x: torch.Tensor, wqkv: torch.Tensor,
                        bqkv: torch.Tensor, bias: torch.Tensor,
                        mask: Optional[torch.Tensor], wproj: torch.Tensor,
                        bproj: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The fused forward: x (B_, N, C); Wqkv (3C, C), bqkv (3C,), bias
    (nH, N, N), Wproj (C, C), bproj (C,) fp32; mask (nW, N, N) fp32 or
    None with nW dividing B_. Returns (B_, N, C) in x's dtype."""
    if x.device.type == 'cpu':
        return window_attention_v4_reference(x, wqkv, bqkv, bias, mask,
                                             wproj, bproj, num_heads)
    if x.device.type != 'cuda':
        raise ValueError(f'window_attention_v4: unsupported device '
                         f'{x.device}')
    b_, n, c, hd, code = _check(
        'window_attention_v4', x, wqkv, bqkv, bias, mask, wproj, num_heads,
        ('bproj', bproj, torch.float32, (x.shape[-1],)))
    out = torch.empty_like(x)
    fn = build.bind('window_attention_v4', 'swindet_window_attention_v4',
                    _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                    bias.data_ptr(), None if mask is None else mask.data_ptr(),
                    wproj.data_ptr(), bproj.data_ptr(), out.data_ptr(), b_, n,
                    c, num_heads, 1 if mask is None else mask.shape[0],
                    hd ** -0.5, code, build.stream_ptr(x.device))
    build.check_launch('window_attention_v4', status)
    window_attention_v4.launches += 1
    return out


window_attention_v4.launches = 0


def window_attention_v4_bwd(x: torch.Tensor, wqkv: torch.Tensor,
                            bqkv: torch.Tensor, bias: torch.Tensor,
                            mask: Optional[torch.Tensor], wproj: torch.Tensor,
                            g: torch.Tensor, num_heads: int):
    """dx, dWqkv, dbqkv, dBias, dWproj, dbproj of :func:`window_attention_v4`
    for the output gradient g (B_, N, C) in x's dtype; dx in x's dtype,
    the rest fp32."""
    if x.device.type == 'cpu':
        return window_attention_v4_bwd_reference(x, wqkv, bqkv, bias, mask,
                                                 wproj, g, num_heads)
    if x.device.type != 'cuda':
        raise ValueError(f'window_attention_v4_bwd: unsupported device '
                         f'{x.device}')
    b_, n, c, hd, code = _check(
        'window_attention_v4_bwd', x, wqkv, bqkv, bias, mask, wproj,
        num_heads, ('g', g, x.dtype, tuple(x.shape)))
    dev, f32 = x.device, torch.float32
    attn = torch.empty((b_, n, c), dtype=f32, device=dev)
    dqkv = torch.empty((b_, n, 3 * c), dtype=f32, device=dev)
    dx = torch.empty_like(x)
    dwqkv = torch.zeros((3 * c, c), dtype=f32, device=dev)
    dbqkv = torch.zeros((3 * c,), dtype=f32, device=dev)
    dbias = torch.zeros((num_heads, n, n), dtype=f32, device=dev)
    dwproj = torch.zeros((c, c), dtype=f32, device=dev)
    dbproj = torch.zeros((c,), dtype=f32, device=dev)
    fn = build.bind('window_attention_v4', 'swindet_window_attention_v4_bwd',
                    _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                    bias.data_ptr(), None if mask is None else mask.data_ptr(),
                    wproj.data_ptr(), g.data_ptr(), attn.data_ptr(),
                    dqkv.data_ptr(), dx.data_ptr(), dwqkv.data_ptr(),
                    dbqkv.data_ptr(), dbias.data_ptr(), dwproj.data_ptr(),
                    dbproj.data_ptr(), b_, n, c, num_heads,
                    1 if mask is None else mask.shape[0], hd ** -0.5, code,
                    build.stream_ptr(dev))
    build.check_launch('window_attention_v4_bwd', status)
    window_attention_v4_bwd.launches += 1
    return dx, dwqkv, dbqkv, dbias, dwproj, dbproj


window_attention_v4_bwd.launches = 0


class WindowAttentionV4Function(torch.autograd.Function):
    """``_wattn4_vjp``: the forward saves only its inputs; the backward
    kernels recompute qkv and P. The shift mask is a constant of the block
    geometry and gets no gradient (:325-328)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, bias, mask, wproj, bproj, num_heads):
        ctx.save_for_backward(x, wqkv, bqkv, bias, mask, wproj)
        ctx.num_heads = num_heads
        return window_attention_v4(x, wqkv, bqkv, bias, mask, wproj, bproj,
                                   num_heads)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, bias, mask, wproj = ctx.saved_tensors
        dx, dwqkv, dbqkv, dbias, dwproj, dbproj = window_attention_v4_bwd(
            x, wqkv, bqkv, bias, mask, wproj, g.to(x.dtype).contiguous(),
            ctx.num_heads)
        return dx, dwqkv, dbqkv, dbias, None, dwproj, dbproj, None


def window_attention_v4_op(x: torch.Tensor, wqkv: torch.Tensor,
                           bqkv: Optional[torch.Tensor], bias: torch.Tensor,
                           mask: Optional[torch.Tensor], wproj: torch.Tensor,
                           bproj: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Differentiable :func:`window_attention_v4`; a missing qkv bias is
    zeros (``swin.py:250-251``)."""
    if bqkv is None:
        bqkv = torch.zeros(wqkv.shape[0], dtype=torch.float32,
                           device=wqkv.device)
    return WindowAttentionV4Function.apply(x, wqkv, bqkv, bias, mask, wproj,
                                           bproj, num_heads)
