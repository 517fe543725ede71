"""RetinaHead (counterpart of
``swindet_tpu/models/dense_heads/retina_head.py:17``; reference
mmdet/models/dense_heads/retina_head.py): ``stacked_convs`` 3x3 ReLU
``ConvModule``s per tower (the conv3x3 kernel at 256 channels), a plain
3x3 class conv over the octave anchors (A x classes outputs, its bias at
the 0.01 focal prior) and a plain 3x3 box conv. Targets, losses and boxes
are ``AnchorHead``'s.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..layers import ConvModule, conv_nhwc, init_conv
from ...registries import HEADS
from .anchor_head import AnchorHead


@HEADS.register_module()
class RetinaHead(AnchorHead):

    def __init__(self, num_classes: int, in_channels: int,
                 stacked_convs: int = 4, conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None, **kwargs):
        if conv_cfg is not None:
            raise NotImplementedError('RetinaHead: conv_cfg is not ported')
        self.stacked_convs = stacked_convs
        self.norm_cfg = norm_cfg
        super().__init__(num_classes=num_classes, in_channels=in_channels,
                         **kwargs)

    def _init_layers(self):
        d = self.compute_dtype

        def tower():
            return nn.ModuleList([ConvModule(
                self.in_channels if i == 0 else self.feat_channels,
                self.feat_channels, 3, padding=1, norm_cfg=self.norm_cfg,
                act_cfg=dict(type='ReLU'), dtype=d)
                for i in range(self.stacked_convs)])
        self.cls_convs = tower()
        self.reg_convs = tower()
        a = self.num_base_priors
        self.retina_cls = nn.Conv2d(self.feat_channels,
                                    a * self.cls_out_channels, 3, padding=1)
        self.retina_reg = nn.Conv2d(self.feat_channels, a * 4, 3, padding=1)

    def init_weights(self, gen: torch.Generator):
        # reference retina_head.py init_weights: normal_init(std=0.01) on
        # the towers and the outputs, the class bias at the focal prior
        for conv in (*self.cls_convs, *self.reg_convs):
            conv.init_weights(gen, std=0.01)
        init_conv(self.retina_cls, gen, std=0.01)
        init_conv(self.retina_reg, gen, std=0.01)
        with torch.no_grad():
            self.retina_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward_single(self, x):
        d = self.compute_dtype
        cls_feat = reg_feat = x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        return (conv_nhwc(cls_feat, self.retina_cls, False, d, False),
                conv_nhwc(reg_feat, self.retina_reg, False, d, False))
