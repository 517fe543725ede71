"""ResNet / ResNeXt backbones (counterpart of
``swindet_tpu/models/backbones/resnet.py``: ``make_conv`` :40,
``make_norm`` :57, ``BasicBlock`` :67, ``Bottleneck`` :100,
``ARCH_SETTINGS`` :185, ``ResNet`` :195, ``ResNeXt`` :281; reference
mmdet/models/backbones/resnet.py:663, resnext.py).

NHWC between blocks. Every conv is a plain ``F.conv2d`` in the compute
dtype (the JAX package's are XLA convs, no Pallas kernel). By default every
norm is a frozen BN (``Norm(frozen=True)``): it reads its running
statistics in training too and never updates them, its scale and bias
trainable, its output fp32, then ReLU and the cast to the compute dtype.
``frozen_stages`` cuts the gradient after the stem and after each frozen
stage, as the JAX package's ``stop_gradient``: those parameters get no
gradient, and the training step gives them a zero one so that weight decay
and momentum still move them, as the JAX package's optimizer chain does.

The options of the JAX ResNet (``make_conv`` :40, ``make_norm`` :57, the
Bottleneck's DCN :137-158):

- ``norm_cfg=dict(type='GN', num_groups=32)``: every norm a trainable GN
  (fp32 statistics, no running state), which mmdet names ``gn1`` ... (the
  JAX package ``bn1`` ... whatever the norm);
- ``conv_cfg=dict(type='ConvWS')`` (or 'ConvAWS', taken alike): every conv
  weight-standardised (``WSConv2d``), he-normal at init;
- ``dcn=dict(type='DCN' | 'DCNv2', deform_groups=g)`` with
  ``stage_with_dcn``: the Bottleneck's ``conv2`` in those stages a
  ``ModulatedDeformConvPack`` without bias (``conv2.weight`` and
  ``conv2.conv_offset.*``, as mmcv's), stride ``conv2_stride``; its groups
  and dilation are not taken, nor ``fallback_on_stride``, as in the JAX
  package;
- ``plugins=[dict(cfg=dict(type='ContextBlock' | 'GeneralizedAttention',
  ...), stages=(...), position='after_conv1' | 'after_conv2' |
  'after_conv3')]`` (the JAX ResNet's ``_stage_plugins`` :115 and the
  Bottleneck's ``_plugins_at`` :136): each plugin of a stage (all stages
  where ``stages`` is None; ``position`` 'after_conv3' by default) in
  every Bottleneck of it, on that conv's output (``after_conv3`` after
  ``bn3``, before the residual add), with that output's channels
  (``ops/plugins.py``). A BasicBlock ResNet (depth 18, 34) with plugins
  raises ValueError, as mmdet's BasicBlock asserts; the JAX ResNet drops
  them there.

The ``state_dict`` carries mmdet's names (``conv1``, ``bn1`` or ``gn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0`` / ``.1``, a plugin as
``layer2.0.context_block`` or ``.gen_attention_block``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import (Norm, WSConv2d, build_conv, conv_nhwc, he_normal_,
                      init_conv, resolve_dtype)
from ...ops.deform_conv import ModulatedDeformConvPack
from ...ops.plugins import PLUGIN_TYPES, build_plugin
from ...registries import BACKBONES


def _is_gn(norm_cfg: Optional[dict]) -> bool:
    return norm_cfg is not None and norm_cfg.get('type') == 'GN'


def frozen_bn(channels: int) -> Norm:
    """The JAX backbones' BN: ``use_running_average=True``, eps 1e-5."""
    return Norm('bn', channels, eps=1e-5, frozen=True)


def _norm(norm_cfg: Optional[dict], channels: int) -> Norm:
    """A GN for ``type='GN'``, else a frozen BN (``make_norm``)."""
    if _is_gn(norm_cfg):
        return Norm('gn', channels, eps=norm_cfg.get('eps', 1e-5),
                    num_groups=norm_cfg.get('num_groups', 32))
    return frozen_bn(channels)


def _conv(conv_cfg, cin, cout, k, stride=1, padding=0, dilation=1,
          groups=1):
    return build_conv(conv_cfg, cin, cout, k, stride=stride, padding=padding,
                      dilation=dilation, groups=groups, bias=False)


class _Block(nn.Module):
    """Norms under mmdet's names: ``bn{i}`` or, for GN, ``gn{i}``."""

    def _add_norm(self, i: int, norm_cfg, channels: int) -> None:
        name = f'{"gn" if _is_gn(norm_cfg) else "bn"}{i}'
        setattr(self, f'norm{i}_name', name)
        self.add_module(name, _norm(norm_cfg, channels))

    def _downsample(self, x):
        d = self.compute_dtype
        return self.downsample[1](conv_nhwc(x, self.downsample[0], False, d,
                                            False))


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1,
                 norm_cfg: Optional[dict] = None,
                 conv_cfg: Optional[dict] = None, dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(conv_cfg, inplanes, planes, 3, stride, dilation,
                           dilation)
        self._add_norm(1, norm_cfg, planes)
        self.conv2 = _conv(conv_cfg, planes, planes, 3, padding=1)
        self._add_norm(2, norm_cfg, planes)
        self.downsample = nn.Sequential(
            _conv(conv_cfg, inplanes, planes, 1, stride),
            _norm(norm_cfg, planes)) if downsample else None
        self.compute_dtype = resolve_dtype(dtype)

    def forward(self, x):
        d = self.compute_dtype
        norm1, norm2 = getattr(self, self.norm1_name), \
            getattr(self, self.norm2_name)
        out = torch.relu(norm1(conv_nhwc(x, self.conv1, False, d,
                                         False))).to(d)
        out = norm2(conv_nhwc(out, self.conv2, False, d, False))
        identity = x if self.downsample is None else self._downsample(x)
        return torch.relu(out + identity).to(d)


PLUGIN_POSITIONS = ('after_conv1', 'after_conv2', 'after_conv3')


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1,
                 style: str = 'pytorch', groups: int = 1,
                 base_width: int = 64, norm_cfg: Optional[dict] = None,
                 conv_cfg: Optional[dict] = None, dcn: Optional[dict] = None,
                 plugins: Sequence[Tuple[dict, str]] = (),
                 dtype=torch.float32):
        super().__init__()
        if style not in ('pytorch', 'caffe'):
            raise ValueError(f'Bottleneck: style {style!r}')
        width = int(planes * (base_width / 64.0)) * groups
        # caffe puts the stride on conv1 (reference resnet.py:185)
        s1, s2 = (stride, 1) if style == 'caffe' else (1, stride)
        self.conv1 = _conv(conv_cfg, inplanes, width, 1, s1)
        self._add_norm(1, norm_cfg, width)
        if dcn is not None:
            self.conv2 = ModulatedDeformConvPack(
                width, width, 3, stride=s2,
                deform_groups=dcn.get('deform_groups', 1), bias=False,
                modulated=dcn.get('type') == 'DCNv2', dtype=dtype)
        else:
            self.conv2 = _conv(conv_cfg, width, width, 3, s2, dilation,
                               dilation, groups)
        self._add_norm(2, norm_cfg, width)
        self.conv3 = _conv(conv_cfg, width, planes * self.expansion, 1)
        self._add_norm(3, norm_cfg, planes * self.expansion)
        self.downsample = nn.Sequential(
            _conv(conv_cfg, inplanes, planes * self.expansion, 1, stride),
            _norm(norm_cfg, planes * self.expansion)) if downsample else None
        self.compute_dtype = resolve_dtype(dtype)
        # each position's plugins by name, in the config's order
        self.plugin_names = {pos: [] for pos in PLUGIN_POSITIONS}
        channels = dict(after_conv1=width, after_conv2=width,
                        after_conv3=planes * self.expansion)
        for cfg, pos in plugins:
            if pos not in self.plugin_names:
                raise ValueError(f'Bottleneck: plugin position {pos!r}')
            name, plugin = build_plugin(cfg, channels[pos], dtype=dtype)
            if hasattr(self, name):
                raise ValueError(f'Bottleneck: duplicate plugin {name}')
            self.add_module(name, plugin)
            self.plugin_names[pos].append(name)

    def _plugins(self, x, position):
        for name in self.plugin_names[position]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x):
        d = self.compute_dtype
        norm1, norm2, norm3 = (getattr(self, getattr(self, f'norm{i}_name'))
                               for i in (1, 2, 3))
        out = torch.relu(norm1(conv_nhwc(x, self.conv1, False, d,
                                         False))).to(d)
        out = self._plugins(out, 'after_conv1')
        if isinstance(self.conv2, ModulatedDeformConvPack):
            out = self.conv2(out)
        else:
            out = conv_nhwc(out, self.conv2, False, d, False)
        out = self._plugins(torch.relu(norm2(out)).to(d), 'after_conv2')
        out = self._plugins(norm3(conv_nhwc(out, self.conv3, False, d,
                                            False)), 'after_conv3')
        identity = x if self.downsample is None else self._downsample(x)
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
        block, stage_blocks = ARCH_SETTINGS[depth]
        if plugins and block is not Bottleneck:
            raise ValueError(f'ResNet: plugins need Bottleneck blocks, '
                             f'depth {depth} has BasicBlocks')
        if any(p.get('stages') is not None
               and len(p['stages']) != num_stages for p in plugins or ()):
            raise ValueError('ResNet: a plugin\'s stages must name each of '
                             f'the {num_stages} stages')
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.compute_dtype = resolve_dtype(dtype)
        self.conv1 = _conv(conv_cfg, in_channels, base_channels, 7, 2, 3)
        self.norm1_name = 'gn1' if _is_gn(norm_cfg) else 'bn1'
        self.add_module(self.norm1_name, _norm(norm_cfg, base_channels))
        self.res_layers = []
        inplanes, planes = base_channels, base_channels
        for i, blocks in enumerate(stage_blocks[:num_stages]):
            stride, dilation = strides[i], dilations[i]
            extra = dict(groups=groups, base_width=base_width, style=style,
                         dcn=dcn if stage_with_dcn[i] else None,
                         plugins=_stage_plugins(plugins, i)) \
                if block is Bottleneck else {}
            layer = []
            for j in range(blocks):
                need_ds = j == 0 and (stride != 1 or
                                      inplanes != planes * block.expansion)
                layer.append(block(inplanes, planes,
                                   stride=stride if j == 0 else 1,
                                   downsample=need_ds, dilation=dilation,
                                   norm_cfg=norm_cfg, conv_cfg=conv_cfg,
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
        x = torch.relu(getattr(self, self.norm1_name)(conv_nhwc(
            x, self.conv1, False, d, False))).to(d)
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
        """The JAX package's init: flax's lecun-normal convs (he-normal
        where weight-standardised, ``make_conv``), a deformable conv2's
        pack as the JAX pack (offsets zero), norms with scale 1, bias 0
        and running statistics 0 and 1."""
        init_resnet_modules(self, gen)


def _stage_plugins(plugins: Optional[Sequence[dict]],
                  stage: int) -> Tuple[Tuple[dict, str], ...]:
    """The (cfg, position) pairs of the plugins of ``stage`` (the JAX
    ResNet's ``_stage_plugins``; reference resnet.py:334
    make_stage_plugins)."""
    return tuple((p['cfg'], p.get('position', 'after_conv3'))
                 for p in plugins or ()
                 if p.get('stages') is None or p['stages'][stage])


def init_resnet_modules(module: nn.Module, gen: torch.Generator) -> None:
    """``ResNet.init_weights`` of any module of ResNet blocks; a plugin
    by its own ``init_weights``."""
    packs = [m for m in module.modules()
             if isinstance(m, ModulatedDeformConvPack)]
    offsets = {id(p.conv_offset) for p in packs}
    plugins = [m for m in module.modules()
               if isinstance(m, tuple(PLUGIN_TYPES.values()))]
    inside = {id(m) for p in plugins for m in p.modules()}
    for p in plugins:
        p.init_weights(gen)
    for m in module.modules():
        if id(m) in inside:
            continue
        if isinstance(m, ModulatedDeformConvPack):
            m.init_weights(gen)
        elif isinstance(m, WSConv2d):
            he_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.Conv2d) and id(m) not in offsets:
            init_conv(m, gen)
        elif isinstance(m, Norm):
            m.reset_parameters()


@BACKBONES.register_module()
class ResNeXt(ResNet):
    """Grouped bottlenecks (reference resnext.py), ResNeXt-101 32x4d as
    groups=32, base_width=4 by default."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        super().__init__(groups=groups, base_width=base_width, **kwargs)
