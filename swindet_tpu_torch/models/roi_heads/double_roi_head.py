"""Double-Head R-CNN (counterpart of
``swindet_tpu/models/roi_heads/double_roi_head.py``: ``_BasicResBlock``
:22, ``_Bottleneck`` :43, ``DoubleConvFCBBoxHead`` :61,
``DoubleHeadRoIHead`` :96; reference mmdet/models/roi_heads/
double_roi_head.py:6, bbox_heads/double_bbox_head.py:72,
arXiv:1904.06493).

Classification through an fc branch on the roi features; regression
through a conv branch (a residual block to ``conv_out_channels``, then
bottlenecks and a spatial mean) on the features of the same rois
enlarged by ``reg_roi_scale_factor`` about their centres. The conv
branch's BNs normalise with the batch's statistics in training, over
every sampled slot, valid or not, as the JAX package's do, and update
their running statistics as flax's ``nn.BatchNorm`` does
(``models/layers.py`` ``Norm``); they read the running statistics when
serving. mmdet's names: ``res_block.{conv1,conv2,conv_identity}`` as
ConvModules, ``conv_branch.{i}.conv{1,2,3}`` / ``bn{1,2,3}`` as a ResNet
Bottleneck's, ``fc_branch.{i}``; ``fc_branch.0`` reads the roi features
flattened channel-first.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import (ConvModule, Linear, Norm, conv_nhwc, init_conv,
                      lecun_normal_, normal_)
from ...registries import HEADS
from .bbox_heads import ConvFCBBoxHead
from .standard_roi_head import StandardRoIHead

_BN = dict(type='BN')
_RELU = dict(type='ReLU')


class _BasicResBlock(nn.Module):
    """relu(conv2(conv1(x)) + conv_identity(x)): a 3x3 ConvModule with BN
    and ReLU at the input width, then 1x1 ConvModules with BN to
    ``out_channels`` on both paths."""

    def __init__(self, in_channels: int, out_channels: int, dtype):
        super().__init__()
        self.conv1 = ConvModule(in_channels, in_channels, 3, padding=1,
                                norm_cfg=_BN, act_cfg=_RELU, dtype=dtype)
        self.conv2 = ConvModule(in_channels, out_channels, 1, norm_cfg=_BN,
                                dtype=dtype)
        self.conv_identity = ConvModule(in_channels, out_channels, 1,
                                        norm_cfg=_BN, dtype=dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        for conv in (self.conv1, self.conv2, self.conv_identity):
            conv.init_weights(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv2(self.conv1(x)) + self.conv_identity(x))


class _Bottleneck(nn.Module):
    """relu(x + bn3(conv3(relu(bn2(conv2(relu(bn1(conv1(x))))))))): 1x1 to
    ``planes``, 3x3, 1x1 back to the input width; each conv computes in
    ``dtype``, each BN in fp32 with its output cast to ``dtype``."""

    def __init__(self, inplanes: int, planes: int, dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = Norm('bn', planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = Norm('bn', planes)
        self.conv3 = nn.Conv2d(planes, inplanes, 1, bias=False)
        self.bn3 = Norm('bn', inplanes)

    def init_weights(self, gen: torch.Generator) -> None:
        for i in (1, 2, 3):
            init_conv(getattr(self, f'conv{i}'), gen)
            getattr(self, f'bn{i}').reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        out = x
        for i in (1, 2, 3):
            out = conv_nhwc(out, getattr(self, f'conv{i}'), False, d, False)
            out = getattr(self, f'bn{i}')(out).to(d)
            if i < 3:
                out = torch.relu(out)
        return torch.relu(out + x)


@HEADS.register_module()
class DoubleConvFCBBoxHead(ConvFCBBoxHead):
    """cls from ``num_fcs`` fcs on x_cls; reg from the residual block,
    ``num_convs`` bottlenecks (``conv_out_channels`` wide, a quarter inside)
    and the mean over the roi grid, on x_reg (x_cls where none is
    given)."""

    def __init__(self, num_convs: int = 0, num_fcs: int = 0,
                 conv_out_channels: int = 1024, fc_out_channels: int = 1024,
                 with_avg_pool: bool = True, **kwargs):
        # the JAX head takes the mean whatever with_avg_pool says
        super().__init__(conv_out_channels=conv_out_channels,
                         fc_out_channels=fc_out_channels, **kwargs)
        in_channels = kwargs.get('in_channels', 256)
        roi_feat_size = kwargs.get('roi_feat_size', 7)
        d = self.compute_dtype
        self.res_block = _BasicResBlock(in_channels, conv_out_channels, d)
        self.conv_branch = nn.ModuleList([
            _Bottleneck(conv_out_channels, conv_out_channels // 4, d)
            for _ in range(num_convs)])
        self.fc_branch = nn.ModuleList([
            Linear(in_channels * roi_feat_size ** 2 if i == 0
                   else fc_out_channels, fc_out_channels, dtype=d)
            for i in range(num_fcs)])
        self.fc_cls = Linear(fc_out_channels, self.num_classes + 1, dtype=d)
        self.fc_reg = Linear(conv_out_channels, self.fc_reg.out_features,
                             dtype=d)

    def init_weights(self, gen: torch.Generator):
        """The JAX head's: the ConvModule and BN defaults, lecun-normal
        fc_branch (flax's Dense default), fc_cls normal(0.01), fc_reg
        normal(0.001), zero biases."""
        self.res_block.init_weights(gen)
        for block in self.conv_branch:
            block.init_weights(gen)
        for fc in self.fc_branch:
            lecun_normal_(fc.weight, fc.in_features, gen)
            nn.init.zeros_(fc.bias)
        for fc, std in ((self.fc_cls, 0.01), (self.fc_reg, 0.001)):
            normal_(fc.weight, std, gen)
            nn.init.zeros_(fc.bias)

    def forward(self, x_cls: torch.Tensor, x_reg=None):
        """x_cls, x_reg: (R, s, s, C) -> (cls (R, K+1), reg (R, 4K))."""
        x = self.res_block(x_cls if x_reg is None else x_reg)
        for block in self.conv_branch:
            x = block(x)
        bbox_pred = self.fc_reg(x.float().mean((1, 2)).to(x.dtype))
        x = x_cls.permute(0, 3, 1, 2).reshape(x_cls.shape[0], -1)
        for fc in self.fc_branch:
            x = torch.relu(fc(x))
        return self.fc_cls(x), bbox_pred


@HEADS.register_module()
class DoubleHeadRoIHead(StandardRoIHead):
    """The bbox head fed twice by the bbox extractor: the rois as they
    are (classification) and scaled by ``reg_roi_scale_factor``
    (regression)."""

    def __init__(self, reg_roi_scale_factor: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.reg_roi_scale_factor = reg_roi_scale_factor

    def _bbox_forward(self, feats, rois):
        cls_feats = self.bbox_roi_extractor(feats, rois)
        reg_feats = self.bbox_roi_extractor(
            feats, rois, roi_scale_factor=self.reg_roi_scale_factor)
        return self.bbox_head(cls_feats, reg_feats)
