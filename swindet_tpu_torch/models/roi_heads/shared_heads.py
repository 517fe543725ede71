"""Shared RoI heads (counterpart of
``swindet_tpu/models/roi_heads/shared_heads.py:21`` ``ResLayer``; reference
mmdet/models/roi_heads/shared_heads/res_layer.py:12).

The C4 detectors pool 14 x 14 roi features from the stride-16 C4 map and
run them through the ResNet's next stage (layer4), shared by the bbox and
the mask branch, before the bbox head's average pool.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..backbones.resnet import ARCH_SETTINGS, Bottleneck, init_resnet_modules
from ...registries import SHARED_HEADS


@SHARED_HEADS.register_module()
class ResLayer(nn.Module):
    """Stage ``stage + 1`` of a ResNet-50/101/152 on (R, s, s, C) roi
    features: Bottlenecks with the ResNet's norms (a frozen BN by default),
    the stride on block 0 and a downsample where it changes the shape.
    The state_dict is mmdet's, ``layer{stage + 1}.{j}.*``.

    The blocks take pytorch style whatever ``style`` says, as the JAX
    ResLayer, which does not pass its ``style`` on (its stride sits on
    conv2; mmdet's caffe style puts it on conv1)."""

    def __init__(self, depth: int = 50, stage: int = 3, stride: int = 2,
                 dilation: int = 1, style: str = 'pytorch',
                 norm_cfg: Optional[dict] = None, norm_eval: bool = True,
                 base_channels: int = 64, in_channels: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        block, stage_blocks = ARCH_SETTINGS[depth]
        if block is not Bottleneck:
            raise ValueError('ResLayer: R-50, R-101 and R-152 only')
        planes = base_channels * 2 ** stage
        inplanes = in_channels or planes * 2   # the previous stage's output
        blocks = []
        for j in range(stage_blocks[stage]):
            blocks.append(Bottleneck(
                inplanes, planes, stride=stride if j == 0 else 1,
                downsample=j == 0 and (stride != 1
                                       or inplanes != planes * 4),
                dilation=dilation, norm_cfg=norm_cfg, dtype=dtype))
            inplanes = planes * 4
        self.layer_name = f'layer{stage + 1}'
        self.add_module(self.layer_name, nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.layer_name)(x)

    def init_weights(self, gen: torch.Generator) -> None:
        init_resnet_modules(self, gen)
