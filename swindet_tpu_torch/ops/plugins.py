"""The ResNet's plugins (counterpart of ``swindet_tpu/ops/plugins.py``:
``ContextBlock`` :28, ``_sine_position_embedding`` :72,
``GeneralizedAttention`` :85, ``build_plugin`` :208; reference mmcv's
ContextBlock (GCNet, arXiv:1904.11492) and GeneralizedAttention
(arXiv:1904.05873), placed by mmdet/models/backbones/resnet.py:263).

The JAX package computes both in XLA (flax einsums and 1x1 convs), outside
any Pallas kernel, so here they are plain torch. NHWC in, NHWC out, in the
input's dtype; everything between runs in fp32, as the JAX modules cast
their input to fp32 first. Parameters carry mmcv's names and shapes, so
that a released ``.pth`` loads as it is: ContextBlock's LayerNorm is
mmcv's ``LayerNorm([planes, 1, 1])`` (weight (planes, 1, 1)), and
GeneralizedAttention's ``appr_bias`` / ``geom_bias`` are (out_c,) vectors,
head-major, which the JAX package keeps as (heads, qk_dim).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv on the last axis of fp32 ``x``: ``nn.Conv`` of the JAX
    package on (..., C)."""
    b = None if conv.bias is None else conv.bias.float()
    return F.linear(x, conv.weight[:, :, 0, 0].float(), b)


class ContextBlock(nn.Module):
    """GCNet's global-context block. ``'att'`` pooling weights the pixels
    by a softmax over H * W of a 1x1 ``conv_mask``; ``'avg'`` takes their
    mean. Each fusion transform is conv -> LayerNorm over ``planes`` ->
    ReLU -> conv, its last conv zero at init, so a new block is the
    identity: ``channel_mul`` scales x by the sigmoid of it, then
    ``channel_add`` adds it."""
    _abbr_ = 'context_block'

    def __init__(self, in_channels: int, ratio: float = 1. / 16,
                 pooling_type: str = 'att',
                 fusion_types: Sequence[str] = ('channel_add',),
                 dtype=torch.float32):
        super().__init__()
        if pooling_type not in ('att', 'avg'):
            raise ValueError(f'ContextBlock: pooling_type {pooling_type!r}')
        if not fusion_types or not set(fusion_types) <= {'channel_add',
                                                         'channel_mul'}:
            raise ValueError(f'ContextBlock: fusion_types {fusion_types!r}')
        planes = int(in_channels * ratio)
        self.pooling_type = pooling_type
        self.conv_mask = nn.Conv2d(in_channels, 1, 1) \
            if pooling_type == 'att' else None
        for kind in ('channel_add', 'channel_mul'):
            setattr(self, f'{kind}_conv', nn.Sequential(
                nn.Conv2d(in_channels, planes, 1),
                nn.LayerNorm([planes, 1, 1]), nn.ReLU(),
                nn.Conv2d(planes, in_channels, 1))
                if kind in fusion_types else None)

    @staticmethod
    def _transform(seq: nn.Sequential, context: torch.Tensor):
        """(B, C) -> (B, C): conv, LayerNorm (F.layer_norm on (B, planes),
        as flax's ``nn.LayerNorm`` on the (B, 1, 1, planes) map), ReLU,
        conv."""
        t = _conv1x1(context, seq[0])
        norm = seq[1]
        t = F.layer_norm(t, t.shape[-1:], norm.weight.flatten().float(),
                         norm.bias.flatten().float(), norm.eps)
        return _conv1x1(torch.relu(t), seq[3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        xf = x.float()
        if self.conv_mask is not None:
            mask = torch.softmax(_conv1x1(xf, self.conv_mask)
                                 .reshape(b, h * w), dim=1)
            context = torch.einsum('bnc,bn->bc', xf.reshape(b, h * w, c),
                                   mask)
        else:
            context = xf.mean(dim=(1, 2))
        out = xf
        if self.channel_mul_conv is not None:
            out = out * torch.sigmoid(self._transform(
                self.channel_mul_conv, context))[:, None, None, :]
        if self.channel_add_conv is not None:
            out = out + self._transform(self.channel_add_conv,
                                        context)[:, None, None, :]
        return out.to(x.dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's init: flax's lecun-normal 1x1 convs with zero
        bias, the LayerNorm at 1 and 0, each transform's last conv zero."""
        from ..models.layers import init_conv
        if self.conv_mask is not None:
            init_conv(self.conv_mask, gen)
        for seq in (self.channel_add_conv, self.channel_mul_conv):
            if seq is None:
                continue
            init_conv(seq[0], gen)
            nn.init.ones_(seq[1].weight)
            nn.init.zeros_(seq[1].bias)
            nn.init.zeros_(seq[3].weight)
            nn.init.zeros_(seq[3].bias)


def sine_position_embedding(idxs_q: np.ndarray, idxs_kv: np.ndarray,
                            feat_dim: int, magnitude: float) -> np.ndarray:
    """The separable relative sine embedding (Nq, Nkv, 2 * (feat_dim // 2))
    between two 1-D coordinate grids, fp32 from float64 as the JAX
    package's ``_sine_position_embedding``: the offsets over
    ``magnitude``, at frequencies ``100 ** (i / half)``."""
    rel = (idxs_q[:, None] - idxs_kv[None, :]) / magnitude
    half = feat_dim // 2
    freq = 100.0 ** (np.arange(half, dtype=np.float64) / half)
    ang = rel[..., None] / freq
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1) \
        .astype(np.float32)


# The embedding and the range mask depend only on the grids' sizes and
# strides: each is made once per shape and device, on the host in float64
# as the JAX package makes its trace-time constants, and copied to the
# device once (a step would otherwise wait on a host copy per plugin and
# axis). They are made outside inference mode, so that a table first made
# while serving can be saved for a training step's backward.
@functools.lru_cache(maxsize=64)
def _sine_table(nq: int, nk: int, q_stride: int, kv_stride: int,
                feat_dim: int, magnitude: float, device) -> torch.Tensor:
    """sine_position_embedding of the query and key grids of one axis."""
    with torch.inference_mode(False):
        return torch.from_numpy(sine_position_embedding(
            np.arange(nq) * q_stride, np.arange(nk) * kv_stride, feat_dim,
            magnitude)).to(device)


@functools.lru_cache(maxsize=64)
def _keep_mask(hq: int, wq: int, hk: int, wk: int, q_stride: int,
               kv_stride: int, spatial_range: int, device) -> torch.Tensor:
    """(hq * wq, hk * wk): keys within ``spatial_range`` per axis."""
    yy_q = np.repeat(np.arange(hq) * q_stride, wq)
    xx_q = np.tile(np.arange(wq) * q_stride, hq)
    yy_k = np.repeat(np.arange(hk) * kv_stride, wk)
    xx_k = np.tile(np.arange(wk) * kv_stride, hk)
    with torch.inference_mode(False):
        return torch.from_numpy(
            (np.abs(yy_q[:, None] - yy_k[None, :]) <= spatial_range)
            & (np.abs(xx_q[:, None] - xx_k[None, :]) <= spatial_range)) \
            .to(device)


def resize_nearest_half_pixel(x: torch.Tensor,
                              shape: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC to (H, W) as ``jax.image.resize(...,
    'nearest')`` indexes: source floor((i + 0.5) * in / out), in fp32."""
    for axis, n in ((1, shape[0]), (2, shape[1])):
        m = x.shape[axis]
        idx = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5)
               * m / n).floor().long()
        x = x.index_select(axis, idx)
    return x


class GeneralizedAttention(nn.Module):
    """Empirical attention over a ``kv_stride``-subsampled key grid, the
    queries ``q_stride``-subsampled. ``attention_type`` picks the energy
    terms: [0] query . key, [1] query . geometry, [2] appr_bias . key,
    [3] geom_bias . geometry; the geometry is the separable sine embedding
    of the y and x offsets, projected per head by ``appr_geom_fc_y`` /
    ``_x``. ``spatial_range > 0`` masks keys farther than it (in pixels,
    per axis) with -1e9. The heads' output goes through ``proj_conv``,
    scaled by ``gamma`` (zero at init) and added to x."""
    _abbr_ = 'gen_attention_block'

    def __init__(self, in_channels: int, spatial_range: int = -1,
                 num_heads: int = 9, position_embedding_dim: int = -1,
                 position_magnitude: float = 1.0, kv_stride: int = 2,
                 q_stride: int = 1, attention_type: str = '1111',
                 dtype=torch.float32):
        super().__init__()
        if len(attention_type) != 4 or set(attention_type) - {'0', '1'}:
            raise ValueError(f'GeneralizedAttention: attention_type '
                             f'{attention_type!r}')
        self.bits = [c == '1' for c in attention_type]
        self.in_channels = in_channels
        self.spatial_range = spatial_range
        self.num_heads = num_heads
        self.qk_dim = in_channels // num_heads
        self.pos_dim = position_embedding_dim \
            if position_embedding_dim > 0 else in_channels
        self.position_magnitude = position_magnitude
        self.kv_stride = kv_stride
        self.q_stride = q_stride
        out_c = self.qk_dim * num_heads
        bits = self.bits

        def conv(cin, cout, bias=False):
            return nn.Conv2d(cin, cout, 1, bias=bias)
        self.query_conv = conv(in_channels, out_c) \
            if bits[0] or bits[1] else None
        self.key_conv = conv(in_channels, out_c) \
            if bits[0] or bits[2] else None
        self.value_conv = conv(in_channels, out_c)
        emb = 2 * (self.pos_dim // 2 // 2)
        geom = bits[1] or bits[3]
        # the JAX package's nn.Dense: with a bias (mmcv's Linear has none)
        self.appr_geom_fc_x = nn.Linear(emb, out_c) if geom else None
        self.appr_geom_fc_y = nn.Linear(emb, out_c) if geom else None
        self.appr_bias = nn.Parameter(torch.zeros(out_c)) if bits[2] \
            else None
        self.geom_bias = nn.Parameter(torch.zeros(out_c)) if bits[3] \
            else None
        self.proj_conv = conv(out_c, in_channels, bias=True)
        self.gamma = nn.Parameter(torch.zeros(1))

    def _embedding(self, nq: int, nk: int, fc: nn.Linear,
                   device) -> torch.Tensor:
        """(nq, nk, heads, qk_dim): one axis' sine embedding projected."""
        emb = _sine_table(nq, nk, self.q_stride, self.kv_stride,
                          self.pos_dim // 2, self.position_magnitude, device)
        return F.linear(emb, fc.weight.float(), fc.bias.float()) \
            .reshape(nq, nk, self.num_heads, self.qk_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bits, heads, d = self.bits, self.num_heads, self.qk_dim
        b, h, w, c = x.shape
        xf = x.float()
        x_q = xf[:, ::self.q_stride, ::self.q_stride]
        x_kv = xf[:, ::self.kv_stride, ::self.kv_stride]
        hq, wq = x_q.shape[1:3]
        hk, wk = x_kv.shape[1:3]
        nq, nk = hq * wq, hk * wk
        if self.query_conv is not None:
            q = _conv1x1(x_q, self.query_conv).reshape(b, nq, heads, d) \
                * (1.0 / math.sqrt(d))
        if self.key_conv is not None:
            k = _conv1x1(x_kv, self.key_conv).reshape(b, nk, heads, d)
        v = _conv1x1(x_kv, self.value_conv).reshape(b, nk, heads, d)
        # the terms in the JAX package's order of summation
        energy: Optional[torch.Tensor] = None

        def add(t):
            return t if energy is None else energy + t
        if bits[0]:
            energy = add(torch.einsum('bnhd,bmhd->bhnm', q, k))
        if bits[2]:
            appr = self.appr_bias.float().reshape(heads, d)
            energy = add(torch.einsum('hd,bmhd->bhm', appr, k)[:, :, None])
        if bits[1] or bits[3]:
            py = self._embedding(hq, hk, self.appr_geom_fc_y, x.device)
            px = self._embedding(wq, wk, self.appr_geom_fc_x, x.device)
            ey = ex = None
            if bits[1]:
                qg = q.reshape(b, hq, wq, heads, d)
                ey = torch.einsum('byxhd,yuhd->bhyxu', qg, py)
                ex = torch.einsum('byxhd,xvhd->bhyxv', qg, px)
            if bits[3]:
                geom = self.geom_bias.float().reshape(heads, d)
                gy = torch.einsum('yuhd,hd->hyu', py, geom)[None, :, :, None]
                gx = torch.einsum('xvhd,hd->hxv', px, geom)[None, :, None]
                ey = gy if ey is None else ey + gy
                ex = gx if ex is None else ex + gx
            # e[b, h, (y, x), (u, v)] = ey[b, h, y, x, u] + ex[b, h, y, x, v]
            e = (ey[..., :, None] + ex[..., None, :]).expand(
                b, heads, hq, wq, hk, wk).reshape(b, heads, nq, nk)
            energy = add(e)
        if energy is None:
            energy = xf.new_zeros((b, heads, nq, nk))
        energy = energy.expand(b, heads, nq, nk)
        if self.spatial_range > 0:
            keep = _keep_mask(hq, wq, hk, wk, self.q_stride, self.kv_stride,
                              self.spatial_range, x.device)
            energy = energy.masked_fill(~keep, -1e9)
        attn = torch.softmax(energy, dim=-1)
        out = torch.einsum('bhnm,bmhd->bnhd', attn, v) \
            .reshape(b, hq, wq, heads * d)
        if self.q_stride > 1:
            out = resize_nearest_half_pixel(out, (h, w))
        out = _conv1x1(out, self.proj_conv)
        return (xf + self.gamma.float() * out).to(x.dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's init: lecun-normal convs and geometry FCs with
        zero biases, ``appr_bias`` N(0, 1 / (2 qk_dim)), ``geom_bias``
        N(0, 1 / pos_dim), ``gamma`` zero."""
        from ..models.layers import init_conv, lecun_normal_, normal_
        for conv in (self.query_conv, self.key_conv, self.value_conv,
                     self.proj_conv):
            if conv is not None:
                init_conv(conv, gen)
        for fc in (self.appr_geom_fc_x, self.appr_geom_fc_y):
            if fc is not None:
                lecun_normal_(fc.weight, fc.in_features, gen)
                nn.init.zeros_(fc.bias)
        if self.appr_bias is not None:
            normal_(self.appr_bias, 1.0 / math.sqrt(self.qk_dim * 2), gen)
        if self.geom_bias is not None:
            normal_(self.geom_bias, 1.0 / math.sqrt(self.pos_dim), gen)
        nn.init.zeros_(self.gamma)


PLUGIN_TYPES = {'ContextBlock': ContextBlock,
                'GeneralizedAttention': GeneralizedAttention}


def build_plugin(cfg: dict, in_channels: int,
                 dtype=torch.float32) -> Tuple[str, nn.Module]:
    """(name, module) of a plugin config, as mmcv's ``build_plugin_layer``
    names it: the type's abbreviation plus the config's ``postfix``."""
    cfg = dict(cfg)
    cls = PLUGIN_TYPES[cfg.pop('type')]
    postfix = cfg.pop('postfix', '')
    return f'{cls._abbr_}{postfix}', cls(in_channels=in_channels,
                                           dtype=dtype, **cfg)
