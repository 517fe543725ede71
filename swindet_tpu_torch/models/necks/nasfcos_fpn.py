"""NAS-FCOS's searched FPN (counterpart of
``swindet_tpu/models/necks/nasfcos_fpn.py``: ``_resize_to`` :29,
``ConcatCell`` :43, ``NASFCOS_FPN`` :88; reference
mmdet/models/necks/nasfcos_fpn.py:10, mmcv's ConcatCell; arXiv:1906.04423).

NHWC. C3-C5 adapted by 1x1 conv, BN and ReLU (``adapt_convs.{i}``); seven
``ConcatCell``s (``fpn.<cell>``, cell 'cXY' fuses features X and Y): each
input through its 3x3 conv (a DCNv2 with ``conv_cfg`` DCNv2, with a bias)
and BN, the smaller resized to the larger (nearest, as
``jax.image.resize``: half-pixel centres), concatenated, then BN, ReLU and
a depthwise 1x1 conv of the 2C channels into C (``out_conv``, mmcv's
('norm', 'act', 'conv') order). P3-P5 each add cell f5, resized
bilinearly, to a chosen cell and resize the sum bilinearly to the C level's
size (antialiased where it shrinks, as ``jax.image.resize``); stride-2
3x3 convs (``extra_downsamples.{i}``, ReLU before all but the first) give
the extra levels. Every BN reads its running statistics, in training too,
as the JAX package's (``use_running_average=True``). No conv here reaches
the conv3x3 kernel: the JAX package's are flax ``nn.Conv``s, not
ConvModules; they are held in ConvModules only for mmdet's names.

Where the JAX package departs from mmcv, the port follows it: a cell's
input conv has no ReLU (mmcv's ConvModule has one), and only
``conv_cfg`` DCNv2 makes it deformable.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvModule, Norm, conv_nhwc, init_conv
from ...registries import NECKS


def resize_nearest_half_pixel(x: torch.Tensor,
                              shape: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC to ``shape`` (H, W) as
    ``jax.image.resize(..., 'nearest')`` indexes: output i reads source
    floor((i + 0.5) * in / out), computed in fp32 as there (torch's
    'nearest' takes floor(i * in / out): at 13 -> 25 rows, output row 23
    reads row 12 here and row 11 there)."""
    out = x
    for dim, n in ((1, shape[0]), (2, shape[1])):
        m = x.shape[dim]
        if m == n:
            continue
        idx = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5)
               * m / n).floor().long()
        out = out.index_select(dim, idx)
    return out


def resize_bilinear_aa(x: torch.Tensor, shape: Tuple[int, int]
                       ) -> torch.Tensor:
    """``jax.image.resize(..., 'bilinear')`` of NHWC to ``shape`` (H, W):
    half-pixel centres, a triangle filter widened by the scale where the
    map shrinks (antialias)."""
    if tuple(x.shape[1:3]) == tuple(shape):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(shape),
                         mode='bilinear', align_corners=False,
                         antialias=True).permute(0, 2, 3, 1)


def _resize_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """mmcv BaseMergeCell._resize as the JAX package has it, for a cell's
    smaller input (a cell resizes both inputs to the larger's size, so
    its max-pool branch never runs here): nearest up."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return resize_nearest_half_pixel(x, hw)


class _NormActConv(nn.Module):
    """A ConcatCell's output conv: BN (frozen) of the 2C concatenated
    channels, ReLU, then a depthwise 1x1 conv into C, ``groups`` C, no
    bias (mmcv's names ``bn``, ``conv``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.bn = Norm('bn', in_channels, frozen=True)
        self.conv = nn.Conv2d(in_channels, out_channels, 1,
                              groups=out_channels, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return conv_nhwc(torch.relu(self.bn(x).to(d)), self.conv, False, d,
                         False)

    def init_weights(self, gen):
        init_conv(self.conv, gen)
        self.bn.reset_parameters()


class ConcatCell(nn.Module):
    """(mmcv.ops.merge_cells.ConcatCell, as the JAX package builds it)."""

    def __init__(self, channels: int, with_input1_conv: bool = False,
                 with_input2_conv: bool = False,
                 input_conv_cfg: Optional[dict] = None,
                 input_norm_cfg: Optional[dict] = None,
                 dtype=torch.float32):
        super().__init__()
        dcn = input_conv_cfg is not None \
            and input_conv_cfg.get('type') == 'DCNv2'

        def input_conv():
            m = ConvModule(channels, channels, 3, padding=1,
                           conv_cfg=dict(input_conv_cfg) if dcn else None,
                           norm_cfg=None if input_norm_cfg is None
                           else dict(type='BN'), bias=True, dtype=dtype)
            m.use_kernel = False
            if m.norm_name is not None:
                m.bn.frozen = True
            return m
        self.with_input1_conv = with_input1_conv
        self.with_input2_conv = with_input2_conv
        if with_input1_conv:
            self.input1_conv = input_conv()
        if with_input2_conv:
            self.input2_conv = input_conv()
        self.out_conv = _NormActConv(2 * channels, channels, dtype)

    def forward(self, x1, x2):
        if self.with_input1_conv:
            x1 = self.input1_conv(x1)
        if self.with_input2_conv:
            x2 = self.input2_conv(x2)
        hw = (max(x1.shape[1], x2.shape[1]), max(x1.shape[2], x2.shape[2]))
        return self.out_conv(torch.cat([_resize_to(x1, hw),
                                        _resize_to(x2, hw)], dim=-1))

    def init_weights(self, gen):
        for name in ('input1_conv', 'input2_conv', 'out_conv'):
            if hasattr(self, name):
                getattr(self, name).init_weights(gen)


@NECKS.register_module()
class NASFCOS_FPN(nn.Module):

    # the searched wiring: cell 'cXY' fuses features X and Y, with or
    # without its first and second input conv
    CELLS = (('c22_1', True, True), ('c22_2', True, True),
             ('c32', True, False), ('c02', True, False),
             ('c42', True, True), ('c36', True, True),
             ('c61', True, True))

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 1, end_level: int = -1,
                 add_extra_convs=False, conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None, dtype=torch.float32):
        super().__init__()
        self.start_level = start_level
        self.compute_dtype = dtype
        self.adapt_convs = nn.ModuleList()
        for i in range(start_level, len(in_channels)):
            m = ConvModule(in_channels[i], out_channels, 1,
                           norm_cfg=dict(type='BN'),
                           act_cfg=dict(type='ReLU'), dtype=dtype)
            m.bn.frozen = True
            self.adapt_convs.append(m)
        self.fpn = nn.ModuleDict({
            name: ConcatCell(out_channels, with_input1_conv=in1,
                             with_input2_conv=in2, input_conv_cfg=conv_cfg,
                             input_norm_cfg=norm_cfg, dtype=dtype)
            for name, in1, in2 in self.CELLS})
        self.extra_downsamples = nn.ModuleList([
            ConvModule(out_channels, out_channels, 3, stride=2, padding=1,
                       dtype=dtype) for _ in range(num_outs - 3)])

    def forward(self, inputs):
        d = self.compute_dtype
        feats = [conv(inputs[i + self.start_level])
                 for i, conv in enumerate(self.adapt_convs)]
        for name, _, _ in self.CELLS:
            feats.append(self.fpn[name](feats[int(name[1])],
                                        feats[int(name[2])]))
        ret = []
        for idx, input_idx in zip((9, 8, 7), (1, 2, 3)):
            f1, f2 = feats[idx], feats[5]
            s = f1 + resize_bilinear_aa(f2.float(), f1.shape[1:3]).to(
                f2.dtype)
            ret.append(resize_bilinear_aa(
                s.float(), inputs[input_idx].shape[1:3]).to(d))
        x = ret[-1]
        for i, conv in enumerate(self.extra_downsamples):
            if i > 0:
                x = torch.relu(x)
            x = conv(x)
            ret.append(x)
        return tuple(ret)

    def init_weights(self, gen: torch.Generator):
        """flax's defaults: lecun-normal convs, zero biases, he-normal
        deformable convs with zero offset convs, BN at scale 1 and
        statistics 0 and 1."""
        for m in (*self.adapt_convs, *self.fpn.values(),
                  *self.extra_downsamples):
            m.init_weights(gen)
