"""Res2Net (counterpart of ``swindet_tpu/models/backbones/res2net.py``:
``Bottle2neck`` :27, ``Res2Net`` :111; reference
mmdet/models/backbones/res2net.py:17, :238).

A Bottle2neck splits conv1's output into ``scales`` slices of ``width``
channels. Each slice but the last goes through its own 3x3 conv
(``convs.{i}``, ``bns.{i}``); in a ``'normal'`` block each conv also
takes the previous conv's output (cumulative), in the first block of a
stage (``'stage'``) each takes its slice alone, and there, with a stride,
the last slice is average-pooled 3x3 with ``count_include_pad=False``.
The downsample is an average pool (stride x stride, VALID, where the
stride is not 1) then a 1x1 conv at stride 1 and its norm, mmdet's
``downsample.1`` / ``.2`` behind the pool at index 0. The deep stem is
three 3x3 convs (``stem.{0,3,6}``, their norms ``stem.{1,4,7}``), then a
3x3 / stride-2 max pool over a -inf pad.

Where mmdet differs, the port follows the JAX package: mmdet's 'stage'
block pools the last slice at stride 1 too, with ``count_include_pad``
True, and its downsample pool has ``ceil_mode``. NHWC, frozen BN and
``frozen_stages`` as the port's ResNet (``resnet.py``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import conv_nhwc, resolve_dtype
from ...registries import BACKBONES
from .resnet import frozen_bn, init_resnet_modules


def avg_pool_nhwc(x: torch.Tensor, k: int, stride: int, padding: int = 0,
                  count_include_pad: bool = True) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride, padding,
                        count_include_pad=count_include_pad) \
        .permute(0, 2, 3, 1)


class AvgDown(nn.Module):
    """The average pool at index 0 of an avg-down shortcut: stride x
    stride, VALID; nothing at stride 1."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        if self.stride == 1:
            return x
        return avg_pool_nhwc(x, self.stride, self.stride)


def avg_down_shortcut(inplanes: int, channels: int,
                      stride: int) -> nn.Sequential:
    """mmdet's avg-down shortcut: the pool, a 1x1 conv, its norm."""
    return nn.Sequential(AvgDown(stride),
                         nn.Conv2d(inplanes, channels, 1, bias=False),
                         frozen_bn(channels))


def run_shortcut(x, downsample: nn.Sequential, dtype):
    return downsample[2](conv_nhwc(downsample[0](x), downsample[1], False,
                                   dtype, False))


def make_deep_stem(in_channels: int, channels: int) -> nn.Sequential:
    """Three 3x3 convs (``channels // 2`` at stride 2, ``channels // 2``,
    ``channels``), each with its norm and a ReLU, as mmdet's Sequential."""
    layers = []
    for cin, cout, stride in ((in_channels, channels // 2, 2),
                              (channels // 2, channels // 2, 1),
                              (channels // 2, channels, 1)):
        layers += [nn.Conv2d(cin, cout, 3, stride=stride, padding=1,
                             bias=False), frozen_bn(cout), nn.ReLU()]
    return nn.Sequential(*layers)


def run_deep_stem(x, stem: nn.Sequential, dtype):
    for i in range(0, len(stem), 3):
        x = torch.relu(stem[i + 1](conv_nhwc(x, stem[i], False, dtype,
                                             False))).to(dtype)
    return x


class Bottle2neck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1,
                 scales: int = 4, base_width: int = 26,
                 base_channels: int = 64, stage_type: str = 'normal',
                 dtype=torch.float32):
        super().__init__()
        if scales < 2:
            raise ValueError(f'Bottle2neck: scales {scales}')
        width = int(math.floor(planes * (base_width / base_channels)))
        self.width, self.scales = width, scales
        self.stride, self.stage_type = stride, stage_type
        self.conv1 = nn.Conv2d(inplanes, width * scales, 1, bias=False)
        self.bn1 = frozen_bn(width * scales)
        self.convs = nn.ModuleList([
            nn.Conv2d(width, width, 3, stride=stride, padding=dilation,
                      dilation=dilation, bias=False)
            for _ in range(scales - 1)])
        self.bns = nn.ModuleList([frozen_bn(width) for _ in range(scales - 1)])
        self.conv3 = nn.Conv2d(width * scales, planes * self.expansion, 1,
                               bias=False)
        self.bn3 = frozen_bn(planes * self.expansion)
        self.downsample = avg_down_shortcut(
            inplanes, planes * self.expansion, stride) if downsample \
            else None
        self.compute_dtype = resolve_dtype(dtype)

    def forward(self, x):
        d = self.compute_dtype
        out = torch.relu(self.bn1(conv_nhwc(x, self.conv1, False, d,
                                            False))).to(d)
        spx = torch.split(out, self.width, dim=-1)
        outs = []
        sp = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = spx[i] if i == 0 or self.stage_type == 'stage' \
                else sp + spx[i]
            sp = torch.relu(bn(conv_nhwc(sp, conv, False, d, False))).to(d)
            outs.append(sp)
        last = spx[-1]
        if self.stage_type == 'stage' and self.stride != 1:
            last = avg_pool_nhwc(last, 3, self.stride, 1,
                                 count_include_pad=False)
        out = self.bn3(conv_nhwc(torch.cat(outs + [last], dim=-1),
                                 self.conv3, False, d, False))
        identity = x if self.downsample is None \
            else run_shortcut(x, self.downsample, d)
        return torch.relu(out + identity).to(d)


ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


@BACKBONES.register_module()
class Res2Net(nn.Module):
    """Returns the NHWC features of the stages in ``out_indices``, in the
    compute dtype (res2net50_26w_4s family; ``deep_stem`` False: a 7x7
    ``conv1`` / ``bn1`` stem)."""

    def __init__(self, depth: int = 50, scales: int = 4,
                 base_width: int = 26, base_channels: int = 64,
                 num_stages: int = 4, strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 deep_stem: bool = True, dtype=torch.float32):
        super().__init__()
        if depth not in ARCH:
            raise KeyError(f'Res2Net: invalid depth {depth}')
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.compute_dtype = resolve_dtype(dtype)
        c = base_channels
        self.deep_stem = deep_stem
        if deep_stem:
            self.stem = make_deep_stem(3, c)
        else:
            self.conv1 = nn.Conv2d(3, c, 7, stride=2, padding=3, bias=False)
            self.bn1 = frozen_bn(c)
        self.res_layers = []
        inplanes, planes = c, c
        for i, n in enumerate(ARCH[depth][:num_stages]):
            layer = []
            for j in range(n):
                layer.append(Bottle2neck(
                    inplanes, planes, stride=strides[i] if j == 0 else 1,
                    downsample=j == 0, dilation=dilations[i], scales=scales,
                    base_width=base_width, base_channels=base_channels,
                    stage_type='stage' if j == 0 else 'normal', dtype=dtype))
                inplanes = planes * Bottle2neck.expansion
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*layer))
            self.res_layers.append(name)
            planes *= 2

    def forward(self, x: torch.Tensor, gen=None):
        """x (B, H, W, 3) -> tuple of (B, H_i, W_i, C_i); ``gen`` unused."""
        d = self.compute_dtype
        if self.deep_stem:
            x = run_deep_stem(x, self.stem, d)
        else:
            x = torch.relu(self.bn1(conv_nhwc(x, self.conv1, False, d,
                                              False))).to(d)
        # max pool 3x3 / 2 over a -inf pad of 1, as the JAX package's
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                         padding=1).permute(0, 2, 3, 1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i + 1 <= self.frozen_stages:
                x = x.detach()
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)

    def init_weights(self, gen: torch.Generator):
        """flax's lecun-normal convs; BN at 1, 0 with statistics 0, 1."""
        init_resnet_modules(self, gen)
