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
tensor. On the card each of the three picks its kernel by dtype and head
width before the launch (:func:`uses_tensor_cores`, :func:`kernel_symbol`):
bf16 with hd a multiple of 16 up to 64 (every stage of Swin-T/S/B) runs
the tensor-core kernels (``mma.sync`` on 64-row tiles, counted in
``wrapper.tc_launches`` as well as ``wrapper.launches``; 16-byte aligned
qkv and g, else ValueError), anything else the SIMT kernels; nothing
falls back from one to the other. The training forward's tensor-core
kernel is the inference forward's with an epilogue that stores the fp32
P. :func:`fwd_geometry` sets both forwards' grids, :func:`bwd_geometry`
the backward's.
:func:`window_attention_op` is the differentiable entry point
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
# the SIMT kernels' last int is the dtype code, the tensor-core
# forwards' their heads a block and the tensor-core backward's its windows
# a block
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P)
_FWD_P_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P)
_BWD_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P)
# the tensor-core kernels (csrc/window_attention.cu): each head's tokens
# padded to one 64-row tile with four warps, one a 16-row tile; a forward
# block takes up to FWD_MAX_HEADS heads of one window, a backward block
# up to BWD_MAX_WINDOWS windows of one head
TC_ROWS = 64
TC_HEAD_DIMS = (16, 32, 48, 64)
FWD_MAX_HEADS = 3
BWD_MAX_WINDOWS = 8
# blocks a grid should have for each SM of the card: the forward kernel
# holds two blocks an SM (its launch bounds), and the backward's grid
# should make more than one wave of its three
FWD_BLOCKS_PER_SM = 2
BWD_BLOCKS_PER_SM = 4
# shared memory a block may take on an H100
SMEM_LIMIT = 232448


def uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the card runs the tensor-core kernels of rows 2, 6, 7, 14
    and 15 for inputs of ``dtype`` and head width ``head_dim`` (N <= 64
    holds for every input the wrappers take)."""
    return dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS


# C entry points of csrc/window_attention.cu: (SIMT, tensor-core) for the
# inference forward (row 2), the training forward (row 6), the backward
# (row 7), the v1 forward over head-major q, k, v (row 14,
# ops/window_attention.py) and the full-map shifted attention (row 15,
# ops/swin_attention.py)
_SYMBOLS = {
    'fwd': ('swindet_window_attention', 'swindet_window_attention_tc'),
    'fwd_p': ('swindet_window_attention_fwd_p',
              'swindet_window_attention_fwd_p_tc'),
    'bwd': ('swindet_window_attention_bwd',
            'swindet_window_attention_bwd_tc'),
    'heads': ('swindet_window_attention_heads',
              'swindet_window_attention_heads_tc'),
    'swin': ('swindet_swin_attention', 'swindet_swin_attention_tc')}


def kernel_symbol(kind: str, dtype: torch.dtype, head_dim: int) -> str:
    """The entry point that the wrapper of ``kind`` ('fwd', 'fwd_p',
    'bwd', 'heads' or 'swin') launches for inputs of ``dtype`` and head
    width ``head_dim``."""
    return _SYMBOLS[kind][uses_tensor_cores(dtype, head_dim)]


def fwd_geometry(windows: int, num_heads: int, sms: int) -> int:
    """Heads a block of the tensor-core forwards (rows 2 and 6): the
    largest divisor of nH up to FWD_MAX_HEADS (so the window's mask is
    read once for the most heads) whose grid of windows x nH / heads
    blocks fills ``sms`` SMs FWD_BLOCKS_PER_SM times over; 1 where none
    does."""
    for heads in range(min(num_heads, FWD_MAX_HEADS), 0, -1):
        if num_heads % heads == 0 \
                and windows * (num_heads // heads) >= FWD_BLOCKS_PER_SM * sms:
            return heads
    return 1


def bwd_geometry(windows: int, num_heads: int, sms: int) -> int:
    """Windows a block of the tensor-core backward: the most, up to
    BWD_MAX_WINDOWS, whose grid of ceil(B_ / windows) x nH blocks fills
    ``sms`` SMs BWD_BLOCKS_PER_SM times over (each block adds its partial
    dBias with one atomic per entry, so fewer blocks, fewer atomics); 1
    where none does."""
    for per in (BWD_MAX_WINDOWS, 4, 2):
        if -(-windows // per) * num_heads >= BWD_BLOCKS_PER_SM * sms:
            return per
    return 1


def tc_fwd_smem(head_dim: int, heads: int, n: int, masked: bool,
                save_p: bool = False, regions: bool = False) -> int:
    """Shared memory of a tensor-core forward block (csrc tc_fwd_smem): a
    64-row tile of hd + 8 bf16 values for each head's q, k and v, each
    head's fp32 bias and the window's fp32 mask, or with ``regions`` (row
    15, which has no mask input) the window's n region ids, a byte each.
    With ``save_p`` (row 6) each of the block's warps (four a head) stages
    its 16 rows of the fp32 P, n floats each, from the start of the k
    tiles (ordered q, v, k) on, over the k tiles, the bias and the mask:
    the block is the larger of the two."""
    tiles = 2 * 3 * heads * TC_ROWS * (head_dim + 8)
    base = tiles + 4 * (heads + masked) * n * n + (n if regions else 0)
    if not save_p:
        return base
    return max(base, tiles // 3 * 2 + 4 * heads * 4 * 16 * n)


def tc_bwd_smem(head_dim: int) -> int:
    """Shared memory of a tensor-core backward block (csrc tc_bwd_smem):
    two buffers of q, k, v and g tiles, P and dS in bf16, and one 16-row
    staging tile for each of the four warps."""
    return 2 * (2 * 4 * TC_ROWS * (head_dim + 8) + 2 * TC_ROWS * (TC_ROWS + 8)
                + 4 * 16 * (head_dim + 8))


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


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    tc = uses_tensor_cores(qkv.dtype, hd)
    if tc:
        build.check_aligned('window_attention_v3', qkv)
    fn = build.bind('window_attention',
                    kernel_symbol('fwd', qkv.dtype, hd), _ARGTYPES)
    last = fwd_geometry(b_, num_heads, _sms(qkv.device)) if tc else code
    with torch.cuda.device(qkv.device):
        status = fn(qkv.data_ptr(), bias.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), b_, n, c, num_heads,
                    1 if mask is None else mask.shape[0], hd ** -0.5, last,
                    build.stream_ptr(qkv.device))
    build.check_launch('window_attention_v3', status)
    window_attention_v3.launches += 1
    window_attention_v3.tc_launches += tc
    return out


window_attention_v3.launches = 0
window_attention_v3.tc_launches = 0


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
    tc = uses_tensor_cores(qkv.dtype, hd)
    if tc:
        build.check_aligned('window_attention_fwd_p', qkv)
    fn = build.bind('window_attention',
                    kernel_symbol('fwd_p', qkv.dtype, hd), _FWD_P_ARGTYPES)
    last = fwd_geometry(b_, num_heads, _sms(qkv.device)) if tc else code
    with torch.cuda.device(qkv.device):
        status = fn(qkv.data_ptr(), bias.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), p.data_ptr(), b_, n, c, num_heads,
                    1 if mask is None else mask.shape[0], hd ** -0.5, last,
                    build.stream_ptr(qkv.device))
    build.check_launch('window_attention_fwd_p', status)
    window_attention_fwd_p.launches += 1
    window_attention_fwd_p.tc_launches += tc
    return out, p


window_attention_fwd_p.launches = 0
window_attention_fwd_p.tc_launches = 0


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
    tc = uses_tensor_cores(qkv.dtype, hd)
    if tc:
        build.check_aligned('window_attention_bwd', qkv, g)
    fn = build.bind('window_attention', kernel_symbol('bwd', qkv.dtype, hd),
                    _BWD_ARGTYPES)
    last = bwd_geometry(b_, num_heads, _sms(qkv.device)) if tc else code
    with torch.cuda.device(qkv.device):
        status = fn(qkv.data_ptr(), p.data_ptr(), g.data_ptr(),
                    dqkv.data_ptr(), dbias.data_ptr(), b_, n, c, num_heads,
                    hd ** -0.5, last, build.stream_ptr(qkv.device))
    build.check_launch('window_attention_bwd', status)
    window_attention_bwd.launches += 1
    window_attention_bwd.tc_launches += tc
    return dqkv, dbias


window_attention_bwd.launches = 0
window_attention_bwd.tc_launches = 0


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
