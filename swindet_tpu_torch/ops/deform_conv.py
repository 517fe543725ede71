"""Deformable convolution by bilinear gathers and one product (counterpart
of ``swindet_tpu/ops/deform_conv.py``: ``deform_sample`` :21,
``DeformConv2d`` :61; reference usage mmdet/models/dense_heads/
reppoints_head.py:283-287, mmcv's DeformConv2d).

The JAX package computes it in XLA, outside any Pallas kernel: per output
pixel, K = kh * kw taps are sampled at (base grid + predicted offset) by
four bilinear corner gathers, then contracted with the weight,
out[b, i, j, f] = sum_k sum_c w[k, c, f] * x~[b, i + dy_k, j + dx_k, c].
Here the same in plain torch: the gathers, then one
(B * Ho * Wo, K * C) x (K * C, F) product through ``torch.matmul``.
Autograd turns the gathers into scatter-adds.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn


def deform_sample(x: torch.Tensor, sample_y: torch.Tensor,
                  sample_x: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of x (B, H, W, C) at fractional positions
    (B, Ho, Wo, K): (B, Ho, Wo, K, C), zero outside.

    Borders follow the JAX package, not mmcv: a sample is valid where it
    lies in (-1, H) x (-1, W), and its coordinates are then clipped into
    [0, H - 1] x [0, W - 1] before the bilinear weights are taken. mmcv
    instead weights the corners that fall outside by zero, so the two
    differ on the one-cell band around the map."""
    b, h, w, c = x.shape
    ho, wo, k = sample_y.shape[1:]
    flat = x.reshape(b * h * w, c)
    valid = ((sample_y > -1.0) & (sample_y < h)
             & (sample_x > -1.0) & (sample_x < w))
    y = sample_y.clamp(0.0, h - 1.0)
    xs = sample_x.clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(y), torch.floor(xs)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    ly, lx = y - y0, xs - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    base = (torch.arange(b, device=x.device) * (h * w)).view(b, 1, 1, 1)

    def take(yy, xx):
        idx = base + (yy * w + xx).long()
        return torch.index_select(flat, 0, idx.reshape(-1)).reshape(
            b, ho, wo, k, c)

    out = (take(y0, x0) * (hy * hx)[..., None]
           + take(y0, x1) * (hy * lx)[..., None]
           + take(y1, x0) * (ly * hx)[..., None]
           + take(y1, x1) * (ly * lx)[..., None])
    return torch.where(valid[..., None], out, 0.0)


class DeformConv2d(nn.Module):
    """mmcv-compatible deformable conv, no bias: kernel kh x kw, stride s,
    padding (kh // 2, kw // 2). ``weight`` is mmcv's (F, C, kh, kw); the
    JAX package keeps it tap-major as (K, C, F). ``offset`` is
    (B, Ho, Wo, G * 2 * K): (dy, dx) pairs per tap in torch channel
    order, the tap grid y-first, one offset set per deform group (the
    input channels split into ``deform_groups`` consecutive slices).

    Sampling is in fp32; the samples are cast to ``dtype`` for the
    product, which accumulates in fp32 and is cast back."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=(3, 3), stride: int = 1,
                 deform_groups: int = 1, dtype=torch.float32):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        if in_channels % deform_groups:
            raise ValueError(f'DeformConv2d: {in_channels} channels in '
                             f'{deform_groups} deform groups')
        self.kernel_size = (kh, kw)
        self.stride = stride
        self.deform_groups = deform_groups
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kh, kw))
        base = np.stack(np.meshgrid(np.arange(kh) - kh // 2,
                                    np.arange(kw) - kw // 2, indexing='ij'),
                        -1).reshape(kh * kw, 2)
        self.register_buffer('base', torch.from_numpy(base.astype(
            np.float32)), persistent=False)

    def forward(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C), offset (B, Ho, Wo, G * 2 * K) -> (B, Ho, Wo, F)
        in ``dtype``."""
        b, h, w, c = x.shape
        kh, kw = self.kernel_size
        k, dg, s = kh * kw, self.deform_groups, self.stride
        dev = x.device
        grid_y = torch.arange(0, h, s, device=dev, dtype=torch.float32)
        grid_x = torch.arange(0, w, s, device=dev, dtype=torch.float32)
        ho, wo = grid_y.numel(), grid_x.numel()
        off = offset.float().reshape(b, ho, wo, dg, k, 2)
        sy = grid_y.view(1, ho, 1, 1, 1) + self.base[:, 0] + off[..., 0]
        sx = grid_x.view(1, 1, wo, 1, 1) + self.base[:, 1] + off[..., 1]
        xg = x.float().reshape(b, h, w, dg, c // dg)
        samples = torch.cat([deform_sample(xg[:, :, :, g], sy[:, :, :, g],
                                           sx[:, :, :, g])
                             for g in range(dg)], dim=-1)  # (B,Ho,Wo,K,C)
        d = self.compute_dtype
        wt = self.weight.permute(2, 3, 1, 0).reshape(k * c, -1)
        out = torch.matmul(samples.reshape(b * ho * wo, k * c).to(d),
                           wt.to(d))
        return out.reshape(b, ho, wo, -1)
