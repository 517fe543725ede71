"""ResNeSt (counterpart of ``swindet_tpu/models/backbones/resnest.py``:
``SplitAttentionConv2d`` :26, ``SplitBottleneck`` :83, ``ResNeSt`` :137;
reference mmdet/models/backbones/resnest.py:39, :149, :273,
arXiv:2004.08955).

The split-attention conv is a grouped conv of ``groups * radix`` groups
giving ``radix`` splits of C channels, channel-major (``[split0 | split1
| ...]``), its norm ``bn0`` and a ReLU. The splits' sum, averaged over
the map, goes through ``fc1`` (grouped 1x1 with bias) -> ``bn1`` -> ReLU
-> ``fc2``, then a softmax over the radix (the JAX layout: ``fc2``'s
output read as (radix, groups, C / groups); mmcv's RSoftmax reads it as
(groups, radix, C / groups), the same where groups is 1, as in every
config) weights the splits; at radix 1 a sigmoid scales the one.

``SplitBottleneck``: with ``avg_down_stride`` and a stride, the
split-attention conv runs at stride 1 and a 3x3 average pool (padding 1,
the padding counted, as flax's and mmdet's ``avd_layer``) strides after
it. Its shortcut is mmdet's avg-down one: an average pool (stride x
stride, VALID, where the stride is not 1) at index 0, then ``.1`` the 1x1
conv and ``.2`` its norm. The deep stem is three 3x3 convs
(``stem.{0,3,6}``, norms ``stem.{1,4,7}``), then a padded 3x3 / stride-2
max pool. NHWC, frozen BN (``norm_cfg`` is taken and unused, as in the
JAX package) and ``frozen_stages`` as the port's ResNet.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import conv_nhwc, resolve_dtype
from ...registries import BACKBONES
from .res2net import (avg_down_shortcut, avg_pool_nhwc, make_deep_stem,
                      run_deep_stem, run_shortcut)
from .resnet import frozen_bn, init_resnet_modules


class SplitAttentionConv2d(nn.Module):

    def __init__(self, in_channels: int, channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 groups: int = 1, radix: int = 2, reduction_factor: int = 4,
                 dtype=torch.float32):
        super().__init__()
        inter = max(in_channels * radix // reduction_factor, 32)
        self.radix, self.groups, self.channels = radix, groups, channels
        self.conv = nn.Conv2d(in_channels, channels * radix, kernel_size,
                              stride=stride,
                              padding=dilation * (kernel_size // 2),
                              dilation=dilation, groups=groups * radix,
                              bias=False)
        self.bn0 = frozen_bn(channels * radix)
        self.fc1 = nn.Conv2d(channels, inter, 1, groups=groups)
        self.bn1 = frozen_bn(inter)
        self.fc2 = nn.Conv2d(inter, channels * radix, 1, groups=groups)
        self.compute_dtype = resolve_dtype(dtype)

    def forward(self, x):
        d, r, c = self.compute_dtype, self.radix, self.channels
        out = torch.relu(self.bn0(conv_nhwc(x, self.conv, False, d,
                                            False)).to(d))
        b, h, w, _ = out.shape
        splits = out.reshape(b, h, w, r, c) if r > 1 else None
        gap = (splits.sum(dim=3) if r > 1 else out).mean(dim=(1, 2))
        gap = torch.relu(self.bn1(conv_nhwc(gap[:, None, None], self.fc1,
                                            False, d, False)).to(d))
        atten = conv_nhwc(gap, self.fc2, False, d, False)[:, 0, 0]
        if r > 1:
            a = torch.softmax(atten.float().reshape(b, r, self.groups, -1),
                              dim=1).reshape(b, r, c).to(d)
            return torch.einsum('bhwrc,brc->bhwc', splits, a)
        a = torch.sigmoid(atten.float()).to(d)
        return out * a[:, None, None, :]


class SplitBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 4, base_channels: int = 64,
                 radix: int = 2, reduction_factor: int = 4,
                 avg_down_stride: bool = True, dtype=torch.float32):
        super().__init__()
        width = planes if groups == 1 else int(math.floor(
            planes * (base_width / base_channels)) * groups)
        self.avd = avg_down_stride and stride > 1
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = frozen_bn(width)
        self.conv2 = SplitAttentionConv2d(
            width, width, 3, stride=1 if self.avd else stride, groups=groups,
            radix=radix, reduction_factor=reduction_factor, dtype=dtype)
        self.conv3 = nn.Conv2d(width, planes * self.expansion, 1, bias=False)
        self.bn3 = frozen_bn(planes * self.expansion)
        self.downsample = avg_down_shortcut(
            inplanes, planes * self.expansion, stride) if downsample \
            else None
        self.compute_dtype = resolve_dtype(dtype)

    def forward(self, x):
        d = self.compute_dtype
        out = torch.relu(self.bn1(conv_nhwc(x, self.conv1, False, d,
                                            False)).to(d))
        out = self.conv2(out)
        if self.avd:
            out = avg_pool_nhwc(out, 3, self.stride, 1)
        out = self.bn3(conv_nhwc(out, self.conv3, False, d, False)).to(d)
        identity = x if self.downsample is None \
            else run_shortcut(x, self.downsample, d).to(d)
        return torch.relu(out + identity)


@BACKBONES.register_module()
class ResNeSt(nn.Module):
    """Returns the NHWC features of the stages in ``out_indices``, in the
    compute dtype; the first stage at stride 1, the others at 2."""
    ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3),
            200: (3, 24, 36, 3)}

    def __init__(self, depth: int = 50, groups: int = 1,
                 base_width: int = 4, radix: int = 2,
                 reduction_factor: int = 4, avg_down_stride: bool = True,
                 base_channels: int = 64, stem_channels: int = 64,
                 num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_cfg: Optional[dict] = None,
                 norm_eval: bool = True, dtype=torch.float32):
        super().__init__()
        if depth not in self.ARCH:
            raise KeyError(f'ResNeSt: invalid depth {depth}')
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.compute_dtype = resolve_dtype(dtype)
        self.stem = make_deep_stem(3, stem_channels)
        self.res_layers = []
        inplanes, planes = stem_channels, base_channels
        for i, n in enumerate(self.ARCH[depth][:num_stages]):
            stride = 1 if i == 0 else 2
            layer = []
            for j in range(n):
                layer.append(SplitBottleneck(
                    inplanes, planes, stride=stride if j == 0 else 1,
                    downsample=j == 0, groups=groups, base_width=base_width,
                    base_channels=base_channels, radix=radix,
                    reduction_factor=reduction_factor,
                    avg_down_stride=avg_down_stride, dtype=dtype))
                inplanes = planes * SplitBottleneck.expansion
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*layer))
            self.res_layers.append(name)
            planes *= 2

    def forward(self, x: torch.Tensor, gen=None):
        """x (B, H, W, 3) -> tuple of (B, H_i, W_i, C_i); ``gen`` unused."""
        d = self.compute_dtype
        x = run_deep_stem(x, self.stem, d)
        if self.frozen_stages >= 0:
            x = x.detach()
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                         padding=1).permute(0, 2, 3, 1)
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i + 1 <= self.frozen_stages:
                x = x.detach()
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)

    def init_weights(self, gen: torch.Generator):
        """flax's lecun-normal convs (a grouped one's fan-in its group's
        inputs) with zero biases; BN at 1, 0 with statistics 0, 1."""
        init_resnet_modules(self, gen)
