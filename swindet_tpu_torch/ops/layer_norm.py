"""LayerNorm over the last axis with fp32 statistics and fp32 affine.

Counterpart of ``swindet_tpu/ops/layer_norm.py``. :func:`layer_norm` runs
a hand-written kernel (``csrc/layer_norm.cu``, replacing the Pallas
``_ln_kernel``) on a CUDA tensor and the plain version
:func:`layer_norm_reference` on a CPU tensor. On the card
:func:`ln_geometry` picks the kernel before the launch: where C is a
multiple of the 16-byte vector (8 bf16 or 4 fp32 values; every Swin
width) and x, weight and bias start on 16 bytes, the vector kernel, which
holds each row in registers; otherwise the first kernel, one warp a row
with scalar loads. :func:`layer_norm_op` is the
differentiable entry point: the forward is :func:`layer_norm`, and the
backward recomputes through :func:`layer_norm_reference` in plain torch,
as ``_ln_vjp_bwd`` (:58) does in lax; the JAX package has no Pallas
LayerNorm backward.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# the vector kernel (csrc/layer_norm.cu layer_norm_vec_kernel): 256
# threads a block, at most two blocks an SM (its launch bounds); K, the
# 16-byte chunks a lane holds, is one of LN_PER_LANE[dtype], the K that
# the widths of the Swin configs reach (instantiated there): Swin-T and
# Swin-S's 96 ... 1536 give bf16 K 3 and 6 and fp32 K 3, 6 and 12,
# Swin-B's 128 ... 2048 bf16 K 1, 2, 4 and 8 and fp32 K 1, 2, 4, 8 and 16
LN_THREADS = 256
LN_BLOCKS_PER_SM = 2
LN_PER_LANE = {torch.bfloat16: (1, 2, 3, 4, 6, 8),
               torch.float32: (1, 2, 3, 4, 6, 8, 12, 16)}


class LnPlan(NamedTuple):
    """Launch of the vector kernel: ``group`` lanes a row (a power of two
    up to 32), ``per_lane`` 16-byte chunks a lane, ``rows_per_thread``
    rows a lane, ``blocks`` blocks of LN_THREADS threads. Warp w of block
    b takes row tiles t = b + w blocks, t + 8 blocks, ..; lane l of tile t
    holds chunks (l mod group) + k group, k < per_lane, of rows
    t tile_rows + r (32 / group) + l // group, r < rows_per_thread, where
    tile_rows = (32 / group) rows_per_thread."""
    group: int
    per_lane: int
    rows_per_thread: int
    blocks: int

    @property
    def tile_rows(self) -> int:
        return 32 // self.group * self.rows_per_thread


def ln_rows_per_thread(per_lane: int) -> int:
    """Rows a lane takes for ``per_lane`` chunks (csrc
    ln_rows_per_thread): at most 8 chunks of x in flight a lane, or one
    row where that has more."""
    return 4 if per_lane <= 2 else (2 if per_lane <= 4 else 1)


def ln_geometry(rows: int, cols: int, dtype: torch.dtype,
                sms: int) -> Optional[LnPlan]:
    """The vector kernel's launch for ``rows`` rows of ``cols`` values of
    ``dtype`` on a card of ``sms`` SMs, or None where the first kernel
    runs (cols no multiple of the vector, or a lane would hold a chunk
    count not in LN_PER_LANE[dtype]). The group is the largest power of two up
    to 32 that divides the row's chunks, so that no lane idles. The grid
    is one block for every 8 row tiles (a tile a warp), but at least one
    block an SM while there are tiles (a small launch spreads its tiles
    over the card, a few warps a block) and at most LN_BLOCKS_PER_SM
    blocks an SM (a large one strides over its rows)."""
    vec = 16 // dtype.itemsize
    if cols <= 0 or cols % vec:
        return None
    chunks = cols // vec
    group = min(32, chunks & -chunks)
    per_lane = chunks // group
    if per_lane not in LN_PER_LANE.get(dtype, ()):
        return None
    r = ln_rows_per_thread(per_lane)
    tiles = -(-rows // (32 // group * r))
    warps = LN_THREADS // 32
    blocks = min(max(-(-tiles // warps), min(tiles, sms)),
                 LN_BLOCKS_PER_SM * sms)
    return LnPlan(group, per_lane, r, blocks)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5
                         ) -> torch.Tensor:
    """Plain version: statistics and affine in fp32, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of any-rank ``x`` over its last axis. ``weight`` and
    ``bias`` are fp32 of shape (C,)."""
    if x.device.type == 'cpu':
        return layer_norm_reference(x, weight, bias, eps)
    if x.device.type != 'cuda':
        raise ValueError(f'layer_norm: unsupported device {x.device}')
    c = x.shape[-1]
    code = build.dtype_code(x, 'layer_norm')
    for name, t in (('weight', weight), ('bias', bias)):
        if t.dtype != torch.float32 or t.shape != (c,) \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f'layer_norm: {name} must be a contiguous fp32 '
                             f'({c},) tensor on {x.device}')
    if not x.is_contiguous():
        raise ValueError('layer_norm: x must be contiguous')
    out = torch.empty_like(x)
    rows = x.numel() // max(c, 1)
    plan = None
    if all(t.data_ptr() % 16 == 0 for t in (x, weight, bias)):
        plan = ln_geometry(rows, c, x.dtype, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    fn = build.bind('layer_norm', 'swindet_layer_norm', _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), rows, c, eps, code,
                    0 if plan is None else plan.group,
                    0 if plan is None else plan.blocks,
                    build.stream_ptr(x.device))
    build.check_launch('layer_norm', status)
    layer_norm.launches += 1
    return out


layer_norm.launches = 0


class LayerNormFunction(torch.autograd.Function):
    """``_ln_vjp``: the kernel forward; the backward differentiates the
    plain version at the saved inputs."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return layer_norm(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = layer_norm_reference(*saved, ctx.eps)
        return (*torch.autograd.grad(y, saved, g), None)


def layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Differentiable :func:`layer_norm`."""
    return LayerNormFunction.apply(x, weight, bias, eps)
