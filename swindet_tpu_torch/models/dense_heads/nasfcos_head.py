"""NAS-FCOS head (counterpart of
``swindet_tpu/models/dense_heads/nasfcos_head.py``: ``_NASTowerOp`` :21,
``NASFCOSHead`` :48; reference mmdet/models/dense_heads/nasfcos_head.py:11;
arXiv:1906.04423).

``FCOSHead`` with the searched towers: DCNv2 3x3 (2 deform groups, a
bias), 3x3 conv, DCNv2 3x3, 1x1 conv, each followed by GN and ReLU
(``cls_convs.{i}`` / ``reg_convs.{i}`` with mmcv's ``conv`` and ``gn``).
The GN's epsilon is flax's default, 1e-6, as the JAX package builds it
(mmcv's is 1e-5). Targets, losses and boxes are ``FCOSHead``'s.
"""
from __future__ import annotations

import torch.nn as nn

from ..layers import ConvModule
from ...registries import HEADS
from .fcos_head import FCOSHead


@HEADS.register_module()
class NASFCOSHead(FCOSHead):

    ARCH = ('dconv3', 'conv3', 'dconv3', 'conv1')

    def _build_towers(self):
        ng = (self.norm_cfg or {}).get('num_groups', 32)
        d = self.compute_dtype

        def op(i, kind):
            return ConvModule(
                self.in_channels if i == 0 else self.feat_channels,
                self.feat_channels, 1 if kind == 'conv1' else 3,
                padding=0 if kind == 'conv1' else 1,
                conv_cfg=dict(type='DCNv2', deform_groups=2)
                if kind == 'dconv3' else None,
                norm_cfg=dict(type='GN', num_groups=ng, eps=1e-6),
                act_cfg=dict(type='ReLU'), bias=kind == 'dconv3', dtype=d)

        def tower():
            return nn.ModuleList([op(i, k) for i, k in enumerate(self.ARCH)])
        return tower(), tower()
