"""HRFPN neck (counterpart of ``swindet_tpu/models/necks/hrfpn.py``:
``HRFPN`` :23; reference mmdet/models/necks/hrfpn.py:11).

Every HRNet branch is resized bilinearly to branch 0's size
(``F.interpolate`` with ``align_corners=False``, the half-pixel sampling
of ``jax.image.resize``), concatenated, reduced by a 1x1
``reduction_conv`` with bias, then average- or max-pooled (``pooling_type``
'AVG' / 'MAX', kernel and stride 2^i, VALID) into ``num_outs`` levels,
each through its 3x3 ``fpn_convs.{i}`` with bias at ``stride``. The JAX
package's convs here are flax ``nn.Conv``, not ConvModules, so none
reaches its Pallas conv: every conv here is an ``F.conv2d``, the conv3x3
kernel is not used. The convs are held in ConvModules only for mmdet's
names (``reduction_conv.conv``, ``fpn_convs.{i}.conv``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvModule
from ...registries import NECKS


def resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear resize of NHWC to ``shape`` (H, W), half-pixel centres."""
    if tuple(x.shape[1:3]) == tuple(shape):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(shape),
                         mode='bilinear', align_corners=False) \
        .permute(0, 2, 3, 1)


@NECKS.register_module()
class HRFPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 256),
                 out_channels: int = 256, num_outs: int = 5,
                 pooling_type: str = 'AVG', stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        if pooling_type not in ('AVG', 'MAX'):
            raise ValueError(f'HRFPN: pooling_type {pooling_type!r}')
        self.in_channels = tuple(in_channels)
        self.num_outs = num_outs
        self.pool = F.max_pool2d if pooling_type == 'MAX' else F.avg_pool2d
        self.reduction_conv = ConvModule(sum(in_channels), out_channels, 1,
                                         dtype=dtype)
        self.fpn_convs = nn.ModuleList([
            ConvModule(out_channels, out_channels, 3, stride=stride,
                       padding=1, dtype=dtype) for _ in range(num_outs)])
        for conv in self.fpn_convs:
            conv.use_kernel = False

    def forward(self, inputs):
        if len(inputs) != len(self.in_channels):
            raise ValueError(f'HRFPN: {len(inputs)} inputs, '
                             f'{len(self.in_channels)} in_channels')
        size = inputs[0].shape[1:3]
        out = torch.cat([inputs[0]] + [resize_bilinear(x, size)
                                       for x in inputs[1:]], dim=-1)
        out = self.reduction_conv(out)
        outs = [out]
        for i in range(1, self.num_outs):
            k = 2 ** i
            outs.append(self.pool(out.permute(0, 3, 1, 2), k, k)
                        .permute(0, 2, 3, 1))
        return tuple(conv(o) for conv, o in zip(self.fpn_convs, outs))

    def init_weights(self, gen: torch.Generator):
        """flax nn.Conv's defaults: lecun-normal kernels, zero biases."""
        for m in (self.reduction_conv, *self.fpn_convs):
            m.init_weights(gen)
