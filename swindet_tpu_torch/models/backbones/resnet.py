"""ResNet / ResNeXt backbones (counterpart of
``swindet_tpu/models/backbones/resnet.py``: ``make_conv`` :40,
``make_norm`` :57, ``BasicBlock`` :67, ``Bottleneck`` :100,
``ARCH_SETTINGS`` :185, ``ResNet`` :195, ``ResNeXt`` :281; reference
mmdet/models/backbones/resnet.py:663, resnext.py).

NHWC between blocks. Every conv is a plain ``F.conv2d`` in the compute
dtype (the JAX package's are XLA convs, no Pallas kernel); every norm is a
frozen BN (``Norm(frozen=True)``): it reads its running statistics in
training too and never updates them, its scale and bias trainable, its
output fp32, then ReLU and the cast to the compute dtype. ``frozen_stages``
cuts the gradient after the stem and after each frozen stage, as the JAX
package's ``stop_gradient``: those parameters get no gradient, and the
training step gives them a zero one so that weight decay and momentum
still move them, as the JAX package's optimizer chain does. The
``state_dict`` carries mmdet's names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0`` / ``.1``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Norm, conv_nhwc, init_conv, resolve_dtype
from ...registries import BACKBONES


def _check_options(norm_cfg, conv_cfg, dcn, plugins):
    """The options of the JAX ResNet that the port does not carry yet."""
    if norm_cfg is not None and norm_cfg.get('type') not in (
            'BN', 'BN2d', 'SyncBN'):
        raise NotImplementedError(f'ResNet: norm {norm_cfg.get("type")} is '
                                  f'not ported yet (frozen BN only)')
    if conv_cfg is not None:
        raise NotImplementedError(f'ResNet: conv_cfg {conv_cfg} (ConvWS) '
                                  f'is not ported yet')
    if dcn is not None:
        raise NotImplementedError('ResNet: dcn (DCN / DCNv2 bottlenecks) '
                                  'is not ported yet')
    if plugins:
        raise NotImplementedError('ResNet: plugins (ContextBlock, '
                                  'GeneralizedAttention) are not ported yet')


def _bn(channels: int) -> Norm:
    return Norm('bn', channels, eps=1e-5, frozen=True)


def _conv(cin, cout, k, stride=1, padding=0, dilation=1, groups=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, groups=groups, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation, dilation)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, padding=1)
        self.bn2 = _bn(planes)
        self.downsample = nn.Sequential(
            _conv(inplanes, planes, 1, stride), _bn(planes)) \
            if downsample else None
        self.compute_dtype = resolve_dtype(dtype)

    def forward(self, x):
        d = self.compute_dtype
        out = torch.relu(self.bn1(conv_nhwc(x, self.conv1, False, d,
                                            False))).to(d)
        out = self.bn2(conv_nhwc(out, self.conv2, False, d, False))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv_nhwc(
                x, self.downsample[0], False, d, False))
        return torch.relu(out + identity).to(d)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1,
                 style: str = 'pytorch', groups: int = 1,
                 base_width: int = 64, dtype=torch.float32):
        super().__init__()
        if style not in ('pytorch', 'caffe'):
            raise ValueError(f'Bottleneck: style {style!r}')
        width = int(planes * (base_width / 64.0)) * groups
        # caffe puts the stride on conv1 (reference resnet.py:185)
        s1, s2 = (stride, 1) if style == 'caffe' else (1, stride)
        self.conv1 = _conv(inplanes, width, 1, s1)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3, s2, dilation, dilation, groups)
        self.bn2 = _bn(width)
        self.conv3 = _conv(width, planes * self.expansion, 1)
        self.bn3 = _bn(planes * self.expansion)
        self.downsample = nn.Sequential(
            _conv(inplanes, planes * self.expansion, 1, stride),
            _bn(planes * self.expansion)) if downsample else None
        self.compute_dtype = resolve_dtype(dtype)

    def forward(self, x):
        d = self.compute_dtype
        out = torch.relu(self.bn1(conv_nhwc(x, self.conv1, False, d,
                                            False))).to(d)
        out = torch.relu(self.bn2(conv_nhwc(out, self.conv2, False, d,
                                            False))).to(d)
        out = self.bn3(conv_nhwc(out, self.conv3, False, d, False))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv_nhwc(
                x, self.downsample[0], False, d, False))
        return torch.relu(out + identity).to(d)


ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet(nn.Module):
    """Returns the NHWC features of the stages in ``out_indices``, in the
    compute dtype."""

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 base_channels: int = 64, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, groups: int = 1,
                 base_width: int = 64, style: str = 'pytorch',
                 norm_cfg: Optional[dict] = None,
                 conv_cfg: Optional[dict] = None, dcn: Optional[dict] = None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 plugins: Optional[Sequence[dict]] = None,
                 norm_eval: bool = True, zero_init_residual: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'ResNet: invalid depth {depth}')
        _check_options(norm_cfg, conv_cfg, dcn, plugins)
        block, stage_blocks = ARCH_SETTINGS[depth]
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.compute_dtype = resolve_dtype(dtype)
        self.conv1 = _conv(in_channels, base_channels, 7, 2, 3)
        self.bn1 = _bn(base_channels)
        self.res_layers = []
        inplanes, planes = base_channels, base_channels
        for i, blocks in enumerate(stage_blocks[:num_stages]):
            stride, dilation = strides[i], dilations[i]
            extra = dict(groups=groups, base_width=base_width, style=style) \
                if block is Bottleneck else {}
            layer = []
            for j in range(blocks):
                need_ds = j == 0 and (stride != 1 or
                                      inplanes != planes * block.expansion)
                layer.append(block(inplanes, planes,
                                   stride=stride if j == 0 else 1,
                                   downsample=need_ds, dilation=dilation,
                                   dtype=dtype, **extra))
                inplanes = planes * block.expansion
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*layer))
            self.res_layers.append(name)
            planes *= 2

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None):
        """x (B, H, W, C) -> tuple of (B, H_i, W_i, C_i). ``gen`` is taken
        and unused: the ResNet draws nothing."""
        d = self.compute_dtype
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
        """The JAX package's init: flax's lecun-normal convs, BN with
        scale 1, bias 0 and running statistics 0 and 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv(m, gen)
            elif isinstance(m, Norm):
                m.reset_parameters()


@BACKBONES.register_module()
class ResNeXt(ResNet):
    """Grouped bottlenecks (reference resnext.py), ResNeXt-101 32x4d as
    groups=32, base_width=4 by default."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        super().__init__(groups=groups, base_width=base_width, **kwargs)
