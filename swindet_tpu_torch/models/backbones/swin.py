"""Swin Transformer backbone (counterpart of
``swindet_tpu/models/backbones/swin.py``; reference
mmdet/models/backbones/swin_transformer.py:449).

NHWC throughout. Every norm goes through the LayerNorm kernel and every
block's attention through the window-attention kernels (plain versions on
the CPU), forward and, in training, backward; with ``SWINDET_WATTN_V4=1``
through the kernels that fold in the qkv and output projections. Pad +
cyclic shift + window partition is one index gather with the table of
:func:`window_gather_indices`, and its inverse another, as in the JAX
package; plain autograd differentiates both gathers. In training mode
(``model.train()``) the blocks drop their residual branches per sample
(stochastic depth) with draws from the generator passed to ``forward``.
The ``state_dict`` uses the reference's key names
(``layers.0.blocks.1.attn.qkv.weight``, ...).
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import (DropPath, Linear, Mlp, lecun_normal_, resolve_dtype,
                      trunc_normal_)
from ...ops.layer_norm import layer_norm_op
from ...ops.swin_attention import shifted_window_attn_mask
from ...ops.window_attention_v3 import window_attention_op
from ...ops.window_attention_v4 import window_attention_v4_op
from ...registries import BACKBONES


@functools.lru_cache(maxsize=128)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww, wh*ww) lookup into the (2wh-1)*(2ww-1) bias table
    (reference: swin_transformer.py:97-111)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing='ij'))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=256)
def window_gather_indices(h: int, w: int, ws: int, shift: int):
    """Pad + cyclic roll + window partition as one gather.

    Returns numpy (idx, valid, inv_idx): idx (nW*N,) flat source pixel of
    every window token (0 in the pad region), valid (nW*N,) 0/1 for pad
    tokens, inv_idx (H*W,) the window token that lands back on every
    pixel (window reverse + unshift + unpad)."""
    hp = (h + ws - 1) // ws * ws
    wp = (w + ws - 1) // ws * ws
    r = (np.arange(hp) + shift) % hp
    c = (np.arange(wp) + shift) % wp
    rr, cc = np.meshgrid(r, c, indexing='ij')
    valid = (rr < h) & (cc < w)
    flat = np.where(valid, rr * w + cc, 0)
    t = flat.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    idx = t.reshape(-1).astype(np.int64)
    v = valid.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    valid_flat = v.reshape(-1).astype(np.float32)
    ri = (np.arange(h) - shift) % hp
    cj = (np.arange(w) - shift) % wp
    rri, ccj = np.meshgrid(ri, cj, indexing='ij')
    wi = (rri // ws) * (wp // ws) + ccj // ws
    tok = (rri % ws) * ws + ccj % ws
    inv_idx = (wi * (ws * ws) + tok).reshape(-1).astype(np.int64)
    return idx, valid_flat, inv_idx


@functools.lru_cache(maxsize=64)
def _window_tables(h: int, w: int, ws: int, shift: int,
                   device: torch.device):
    """Device copies of the gather tables and shift mask of one block
    geometry: (idx, valid or None, inv_idx, mask or None). Made outside
    inference mode, so that a training step may reuse tables first made
    while serving."""
    idx, valid, inv_idx = window_gather_indices(h, w, ws, shift)
    hp = (h + ws - 1) // ws * ws
    wp = (w + ws - 1) // ws * ws
    mask = shifted_window_attn_mask(hp, wp, ws, shift)
    with torch.inference_mode(False):
        return (torch.from_numpy(idx).to(device),
                None if valid.all() else torch.from_numpy(valid).to(device),
                torch.from_numpy(inv_idx).to(device),
                None if mask is None else torch.from_numpy(mask).to(device))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm whose forward is the LayerNorm kernel: statistics in
    fp32, output in the compute ``dtype``."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__(dim, eps=1e-5)
        self.compute_dtype = resolve_dtype(dtype)

    def forward(self, x):
        return layer_norm_op(x.to(self.compute_dtype).contiguous(),
                             self.weight, self.bias, self.eps)


class PatchEmbed(nn.Module):
    """4x4 stride-4 patchify conv (+ LayerNorm); reference PatchEmbed
    :405, JAX ``PatchifyDense`` :182."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 patch_norm: bool, dtype):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        self.norm = LayerNorm(embed_dim, dtype) if patch_norm else None
        self.compute_dtype = resolve_dtype(dtype)

    def forward(self, x):
        d = self.compute_dtype
        y = F.conv2d(x.to(d).permute(0, 3, 1, 2), self.proj.weight.to(d),
                     self.proj.bias.to(d), stride=self.patch_size)
        y = y.permute(0, 2, 3, 1)
        return self.norm(y) if self.norm is not None else y.contiguous()

    def init_weights(self, gen):
        lecun_normal_(self.proj.weight,
                      self.proj.in_channels * self.patch_size ** 2, gen)
        nn.init.zeros_(self.proj.bias)


class WindowAttention(nn.Module):
    """W-MSA with relative position bias (reference :73) over (B_, N, C)
    windows: qkv projection, the window-attention kernel, projection.

    With the JAX package's switch ``SWINDET_WATTN_V4=1``, read once here,
    the three run as one op that keeps qkv and the attention output on
    chip (``ops/window_attention_v4.py``), as
    ``swindet_tpu/models/backbones/swin.py:238-259`` does. The JAX guard
    (no attention or projection dropout, no qk_scale) always holds: the
    port's attention has neither dropout and SwinTransformer refuses
    qk_scale. The parameters and the ``state_dict`` are the same either
    way."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.v4 = os.environ.get('SWINDET_WATTN_V4') == '1'
        self.num_heads = num_heads
        self.window_size = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        idx = relative_position_index(window_size, window_size)
        self.register_buffer('relative_position_index',
                             torch.from_numpy(idx.reshape(-1)),
                             persistent=False)
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x, mask: Optional[torch.Tensor]):
        n = x.shape[1]
        bias = self.relative_position_bias_table[
            self.relative_position_index].view(n, n, self.num_heads)
        bias = bias.permute(2, 0, 1).float().contiguous()
        if self.v4:
            return window_attention_v4_op(
                x.to(self.qkv.compute_dtype).contiguous(), self.qkv.weight,
                self.qkv.bias, bias, mask, self.proj.weight, self.proj.bias,
                self.num_heads)
        qkv = self.qkv(x).contiguous()
        out = window_attention_op(qkv, bias, mask, self.num_heads)
        return self.proj(out)

    def init_weights(self, gen):
        trunc_normal_(self.relative_position_bias_table, 0.02, gen)
        self.qkv.init_trunc_normal(gen)
        self.proj.init_trunc_normal(gen)


class SwinBlock(nn.Module):
    """LN -> (pad, shift, W-MSA, unshift, unpad) -> residual -> LN -> MLP
    -> residual (reference :156-250)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float, qkv_bias: bool,
                 drop_path: float, dtype):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias,
                                    dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        b, h, w, c = x.shape
        ws = self.window_size
        idx, valid, inv_idx, mask = _window_tables(h, w, ws, self.shift_size,
                                                   x.device)
        y = self.norm1(x).reshape(b, h * w, c)[:, idx]
        if valid is not None:
            y = y * valid.to(y.dtype)[None, :, None]
        attn = self.attn(y.reshape(-1, ws * ws, c), mask).reshape(b, -1, c)
        y = attn[:, inv_idx].reshape(b, h, w, c)
        x = x + self.drop_path(y, gen)
        return x + self.drop_path(self.mlp(self.norm2(x)), gen)

    def init_weights(self, gen):
        self.attn.init_weights(gen)
        self.mlp.init_weights(gen)


class PatchMerging(nn.Module):
    """2x2 space-to-depth + LN + Linear 4C -> 2C (reference :258)."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x):
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))

    def init_weights(self, gen):
        self.reduction.init_trunc_normal(gen)


class BasicLayer(nn.Module):
    """One stage: blocks with alternating shift 0 / ws // 2, then an
    optional PatchMerging (reference :301)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float, qkv_bias: bool,
                 drop_path: Sequence[float], downsample: bool, dtype):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size,
                      0 if j % 2 == 0 else window_size // 2, mlp_ratio,
                      qkv_bias, drop_path[j], dtype)
            for j in range(depth)])
        self.downsample = PatchMerging(dim, dtype) if downsample else None

    def forward(self, x, gen: Optional[torch.Generator] = None):
        for blk in self.blocks:
            x = blk(x, gen)
        out = x
        if self.downsample is not None:
            x = self.downsample(x)
        return out, x


@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """Hierarchical Swin backbone, strides 4 / 8 / 16 / 32. Returns the
    NHWC stage features of ``out_indices``, each through its own
    LayerNorm (reference :550-553)."""

    def __init__(self, pretrain_img_size: int = 224, patch_size: int = 4,
                 in_chans: int = 3, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.2, ape: bool = False,
                 patch_norm: bool = True,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, use_checkpoint: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if ape or qk_scale is not None:
            raise NotImplementedError('SwinTransformer: ape and qk_scale '
                                      'are not ported yet')
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim,
                                      patch_norm, dtype)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            start = sum(depths[:i])
            self.layers.append(BasicLayer(
                int(embed_dim * 2 ** i), depth, num_heads[i], window_size,
                mlp_ratio, qkv_bias, dpr[start:start + depth],
                i < len(depths) - 1, dtype))
        for i in self.out_indices:
            self.add_module(f'norm{i}',
                            LayerNorm(int(embed_dim * 2 ** i), dtype))

    def forward(self, x, gen: Optional[torch.Generator] = None):
        """x: (B, H, W, 3) -> tuple of NHWC stage features. ``gen`` draws
        the stochastic-depth masks in training mode."""
        ps = self.patch_size
        _, h, w, _ = x.shape
        if h % ps or w % ps:
            x = F.pad(x, (0, 0, 0, (ps - w % ps) % ps, 0, (ps - h % ps) % ps))
        x = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            out, x = layer(x, gen)
            if i in self.out_indices:
                outs.append(getattr(self, f'norm{i}')(out))
        return tuple(outs)

    def init_weights(self, gen: torch.Generator):
        """The JAX package's init: lecun-normal patchify, trunc-normal
        (0.02) Linears and bias table, unit / zero norms."""
        self.patch_embed.init_weights(gen)
        for layer in self.layers:
            for blk in layer.blocks:
                blk.init_weights(gen)
            if layer.downsample is not None:
                layer.downsample.init_weights(gen)
