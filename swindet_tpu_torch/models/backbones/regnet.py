"""RegNetX (counterpart of ``swindet_tpu/models/backbones/regnet.py``:
``ARCH_SETTINGS`` :19, ``generate_regnet`` :38, ``_quantize`` :48,
``adjust_width_group`` :52, ``stages_from_blocks`` :61, ``RegBottleneck``
:74, ``RegNet`` :107; reference mmdet/models/backbones/regnet.py:11).

The widths come from the quantised linear rule w = w0 + wa * i, snapped
to powers of wm and to multiples of 8, then to whole groups. Each stage is
a run of bottlenecks with a grouped 3x3 ``conv2`` (groups = bw //
group_width), the first strided, with a strided 1x1 downsample; the stem
is a 3x3 / stride-2 conv. NHWC, frozen BN and ``frozen_stages`` as the
port's ResNet (``resnet.py``). The arguments are the JAX RegNet's: like
it, the port takes no ``norm_cfg`` or ``dcn`` (a TypeError), so the
configs/regnet files that set them build in neither package. The
``state_dict`` carries mmdet's names (``conv1``, ``bn1``,
``layer1.0.conv2``, ``layer1.0.downsample.0`` / ``.1``).
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from ..layers import conv_nhwc, resolve_dtype
from ...registries import BACKBONES
from .resnet import frozen_bn, init_resnet_modules

ARCH_SETTINGS = {
    'regnetx_400mf':
    dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22, bot_mul=1.0),
    'regnetx_800mf':
    dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16, bot_mul=1.0),
    'regnetx_1.6gf':
    dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18, bot_mul=1.0),
    'regnetx_3.2gf':
    dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25, bot_mul=1.0),
    'regnetx_4.0gf':
    dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23, bot_mul=1.0),
    'regnetx_6.4gf':
    dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17, bot_mul=1.0),
    'regnetx_8.0gf':
    dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23, bot_mul=1.0),
    'regnetx_12gf':
    dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19, bot_mul=1.0),
}


def generate_regnet(w0, wa, wm, depth, divisor=8):
    """(block widths, number of stages) of the linear rule (reference
    :221)."""
    widths_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, ks)
    widths = (np.round(widths / divisor) * divisor).astype(int).tolist()
    return widths, len(set(widths))


def _quantize(n, divisor):
    return int(round(n / divisor) * divisor)


def adjust_width_group(widths, bot_muls, groups):
    """Widths and group widths made compatible (reference :266)."""
    bw = [int(w * b) for w, b in zip(widths, bot_muls)]
    groups = [min(g, w) for g, w in zip(groups, bw)]
    bw = [_quantize(w, g) for w, g in zip(bw, groups)]
    widths = [int(w / b) for w, b in zip(bw, bot_muls)]
    return widths, groups


def stages_from_blocks(widths):
    """(stage widths, blocks per stage) of the block widths (reference
    :291)."""
    diff = [w != wp for w, wp in zip(widths + [0], [0] + widths)]
    stage_widths = [w for w, d in zip(widths, diff[:-1]) if d]
    stage_blocks = np.diff(
        [i for i, d in enumerate(diff) if d]).tolist()
    return stage_widths, stage_blocks


def regnet_stages(arch: Union[str, dict]):
    """(stage widths, blocks, group widths, bottleneck multipliers) of an
    arch string of ``ARCH_SETTINGS`` or an arch dict, as ``RegNet``
    derives them."""
    arch = ARCH_SETTINGS[arch] if isinstance(arch, str) else dict(arch)
    widths, num_stages = generate_regnet(arch['w0'], arch['wa'], arch['wm'],
                                         arch['depth'])
    stage_widths, stage_blocks = stages_from_blocks(widths)
    bot_muls = [arch['bot_mul']] * num_stages
    group_ws = [arch['group_w']] * num_stages
    stage_widths, group_ws = adjust_width_group(stage_widths, bot_muls,
                                                group_ws)
    return stage_widths, stage_blocks, group_ws, bot_muls


class RegBottleneck(nn.Module):

    def __init__(self, inplanes: int, width: int, stride: int = 1,
                 downsample: bool = False, group_width: int = 8,
                 bot_mul: float = 1.0, dtype=torch.float32):
        super().__init__()
        bw = int(round(width * bot_mul))
        self.conv1 = nn.Conv2d(inplanes, bw, 1, bias=False)
        self.bn1 = frozen_bn(bw)
        self.conv2 = nn.Conv2d(bw, bw, 3, stride=stride, padding=1,
                               groups=max(bw // group_width, 1), bias=False)
        self.bn2 = frozen_bn(bw)
        self.conv3 = nn.Conv2d(bw, width, 1, bias=False)
        self.bn3 = frozen_bn(width)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, width, 1, stride=stride, bias=False),
            frozen_bn(width)) if downsample else None
        self.compute_dtype = resolve_dtype(dtype)

    def forward(self, x):
        d = self.compute_dtype
        out = torch.relu(self.bn1(conv_nhwc(x, self.conv1, False, d,
                                            False))).to(d)
        out = torch.relu(self.bn2(conv_nhwc(out, self.conv2, False, d,
                                            False))).to(d)
        out = self.bn3(conv_nhwc(out, self.conv3, False, d, False))
        identity = x if self.downsample is None else self.downsample[1](
            conv_nhwc(x, self.downsample[0], False, d, False))
        return torch.relu(out + identity).to(d)


@BACKBONES.register_module()
class RegNet(nn.Module):
    """Returns the NHWC features of the stages in ``out_indices``, in the
    compute dtype. ``arch`` is an arch string (``regnetx_400mf`` ...
    ``regnetx_12gf``) or a dict of w0, wa, wm, group_w, depth, bot_mul.
    ``dilations`` is taken and unused, as in the JAX package."""

    def __init__(self, arch: Union[str, dict] = 'regnetx_3.2gf',
                 stem_channels: int = 32,
                 strides: Sequence[int] = (2, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 dtype=torch.float32):
        super().__init__()
        widths, blocks, group_ws, bot_muls = regnet_stages(arch)
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.compute_dtype = resolve_dtype(dtype)
        self.conv1 = nn.Conv2d(3, stem_channels, 3, stride=2, padding=1,
                               bias=False)
        self.bn1 = frozen_bn(stem_channels)
        self.res_layers = []
        inplanes = stem_channels
        for i, n in enumerate(blocks):
            layer = [RegBottleneck(
                inplanes if j == 0 else widths[i], widths[i],
                stride=strides[i] if j == 0 else 1, downsample=j == 0,
                group_width=group_ws[i], bot_mul=bot_muls[i], dtype=dtype)
                for j in range(n)]
            inplanes = widths[i]
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*layer))
            self.res_layers.append(name)

    def forward(self, x: torch.Tensor, gen=None):
        """x (B, H, W, 3) -> tuple of (B, H_i, W_i, C_i); ``gen`` unused."""
        d = self.compute_dtype
        x = torch.relu(self.bn1(conv_nhwc(x, self.conv1, False, d,
                                          False))).to(d)
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
