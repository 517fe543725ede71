"""FPN neck (counterpart of ``swindet_tpu/models/necks/fpn.py``; reference
mmdet/models/necks/fpn.py:12).

NHWC: lateral 1x1 convs from ``start_level``, top-down nearest-upsample
adds, 3x3 output convs (the conv3x3 kernel at 256 channels), then the
extra levels: 1x1 / stride-2 subsampling, or with ``add_extra_convs``
3x3 stride-2 convs (``F.conv2d``: the kernel takes stride 1 only, as the
JAX package's) on the last backbone input ('on_input', or True), the last
lateral ('on_lateral') or the last output ('on_output'), named
``fpn_convs.{i}`` after the output convs as in mmdet. Only nearest
upsampling is ported.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from ..layers import ConvModule, max_pool_1x1_s2, resize_nearest
from ...registries import NECKS


@NECKS.register_module()
class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (96, 192, 384, 768),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs: Union[bool, str] = False,
                 relu_before_extra_convs: bool = False,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 upsample_cfg: Optional[dict] = None, dtype=torch.float32):
        super().__init__()
        if (upsample_cfg or {}).get('mode', 'nearest') != 'nearest':
            raise NotImplementedError('FPN: non-nearest upsampling is not '
                                      'ported yet')
        if add_extra_convs is True:
            add_extra_convs = 'on_input'
        if add_extra_convs not in (False, 'on_input', 'on_lateral',
                                   'on_output'):
            raise ValueError(f'FPN: add_extra_convs={add_extra_convs!r}')
        num_ins = len(in_channels)
        self.start_level = start_level
        self.end_level = num_ins - 1 if end_level in (-1, num_ins - 1) \
            else end_level
        self.num_outs = num_outs
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        levels = range(start_level, self.end_level + 1)
        self.lateral_convs = nn.ModuleList([
            ConvModule(in_channels[i], out_channels, 1, norm_cfg=norm_cfg,
                       act_cfg=act_cfg, dtype=dtype) for i in levels])
        self.fpn_convs = nn.ModuleList([
            ConvModule(out_channels, out_channels, 3, padding=1,
                       norm_cfg=norm_cfg, act_cfg=act_cfg, dtype=dtype)
            for _ in levels])
        if add_extra_convs:
            for i in range(len(levels), num_outs):
                cin = in_channels[self.end_level] \
                    if i == len(levels) and add_extra_convs == 'on_input' \
                    else out_channels
                self.fpn_convs.append(ConvModule(
                    cin, out_channels, 3, stride=2, padding=1,
                    norm_cfg=norm_cfg, act_cfg=act_cfg, dtype=dtype))

    def forward(self, inputs):
        laterals = [conv(inputs[i + self.start_level])
                    for i, conv in enumerate(self.lateral_convs)]
        used = len(laterals)
        for i in range(used - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[1:3])
        outs = [self.fpn_convs[i](laterals[i]) for i in range(used)]
        if not self.add_extra_convs:
            while len(outs) < self.num_outs:
                outs.append(max_pool_1x1_s2(outs[-1]))
            return tuple(outs)
        src = {'on_input': inputs[self.end_level], 'on_lateral': laterals[-1],
               'on_output': outs[-1]}[self.add_extra_convs]
        for i in range(used, self.num_outs):
            if i > used and self.relu_before_extra_convs:
                src = torch.relu(src)
            src = self.fpn_convs[i](src)
            outs.append(src)
        return tuple(outs)

    def init_weights(self, gen: torch.Generator):
        for m in (*self.lateral_convs, *self.fpn_convs):
            m.init_weights(gen)
