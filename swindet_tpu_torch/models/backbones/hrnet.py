"""HRNet (counterpart of ``swindet_tpu/models/backbones/hrnet.py``:
``HRModule`` :29, ``HRNet`` :96; reference
mmdet/models/backbones/hrnet.py:14, :187).

Parallel branches at strides 4, 8, 16, 32, built from ``extra``'s
``stage1`` ... ``stage4`` (num_modules, num_branches, block 'BASIC' or
'BOTTLENECK', num_blocks, num_channels), with the port's ResNet
``BasicBlock`` and ``Bottleneck``. An ``HRModule`` runs each branch's
blocks, then fuses every output from every branch: from a lower
resolution a 1x1 conv, its norm and a nearest upsample, from a higher one
a chain of 3x3 / stride-2 convs with their norms, a ReLU after each but
the last; the sum goes through a ReLU. Between stages a transition gives a
branch whose width changes a 3x3 conv and the new branch a 3x3 / stride-2
conv of the last one, each with its norm and a ReLU. The stem is two 3x3
/ stride-2 convs. ``frozen_stages`` is taken and ignored, as in the JAX
package (every parameter trains).

The ``state_dict`` carries mmdet's names: ``stage2.0.branches.{b}.{k}``,
``stage2.0.fuse_layers.{i}.{j}.0`` / ``.1`` (from a lower resolution) or
``.{k}.0`` / ``.{k}.1`` (a chain's k-th conv), ``transition1.{i}.0`` /
``.1`` (a branch whose width changes) or ``transition1.{i}.0.0`` /
``.0.1`` (a new branch).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from ..layers import conv_nhwc, resize_nearest, resolve_dtype
from ...registries import BACKBONES
from .resnet import (BasicBlock, Bottleneck, frozen_bn,
                     init_resnet_modules)

BLOCKS = {'BASIC': BasicBlock, 'BOTTLENECK': Bottleneck}


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1,
             relu: bool = False) -> nn.Sequential:
    """conv, norm (and a ReLU): mmdet's Sequential of them."""
    layers = [nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                        bias=False), frozen_bn(cout)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


def _run(x, seq: nn.Sequential, dtype):
    """conv -> norm -> cast to ``dtype`` (-> ReLU) of a ``_conv_bn``."""
    x = seq[1](conv_nhwc(x, seq[0], False, dtype, False)).to(dtype)
    return torch.relu(x) if len(seq) > 2 else x


class HRModule(nn.Module):
    """One multi-branch module; ``in_channels`` per branch, after the
    block's expansion."""

    def __init__(self, num_branches: int, block: str,
                 num_blocks: Sequence[int], in_channels: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        cls = BLOCKS[block]
        self.compute_dtype = resolve_dtype(dtype)
        self.branches = nn.ModuleList([nn.Sequential(*[
            cls(in_channels[b], in_channels[b] // cls.expansion,
                dtype=dtype) for _ in range(num_blocks[b])])
            for b in range(num_branches)])
        self.fuse_layers = None
        if num_branches == 1:
            return
        fuse = nn.ModuleList()
        for i in range(num_branches):
            row = nn.ModuleList()
            for j in range(num_branches):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(_conv_bn(in_channels[j], in_channels[i], 1))
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn(in_channels[j],
                                 in_channels[i] if k == i - j - 1
                                 else in_channels[j], 3, stride=2,
                                 relu=k < i - j - 1)
                        for k in range(i - j)]))
            fuse.append(row)
        self.fuse_layers = fuse

    def forward(self, xs):
        d = self.compute_dtype
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return outs
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    t = outs[j]
                elif j > i:
                    t = _run(outs[j], layer, d)
                    t = resize_nearest(t, (t.shape[1] * 2 ** (j - i),
                                           t.shape[2] * 2 ** (j - i)))
                else:
                    t = outs[j]
                    for seq in layer:
                        t = _run(t, seq, d)
                y = t if y is None else y + t
            fused.append(torch.relu(y).to(d))
        return fused


@BACKBONES.register_module()
class HRNet(nn.Module):
    """Returns every branch's NHWC features of the last stage, highest
    resolution first, in the compute dtype."""

    def __init__(self, extra: Dict = None, in_channels: int = 3,
                 frozen_stages: int = -1, norm_eval: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = resolve_dtype(dtype)
        self.conv1 = nn.Conv2d(in_channels, 64, 3, stride=2, padding=1,
                               bias=False)
        self.bn1 = frozen_bn(64)
        self.conv2 = nn.Conv2d(64, 64, 3, stride=2, padding=1, bias=False)
        self.bn2 = frozen_bn(64)
        s1 = extra['stage1']
        cls = BLOCKS[s1['block']]
        planes = s1['num_channels'][0]
        self.layer1 = nn.Sequential(*[
            cls(64 if k == 0 else planes * cls.expansion, planes,
                downsample=k == 0, dtype=dtype)
            for k in range(s1['num_blocks'][0])])
        pre = [planes * cls.expansion]
        for si in (2, 3, 4):
            cfg = extra[f'stage{si}']
            cur = [c * BLOCKS[cfg['block']].expansion
                   for c in cfg['num_channels']]
            nb = cfg['num_branches']
            transition = nn.ModuleList()
            for i in range(nb):
                if i >= len(pre):
                    transition.append(nn.Sequential(_conv_bn(
                        pre[-1], cur[i], 3, stride=2, relu=True)))
                elif cur[i] != pre[i]:
                    transition.append(_conv_bn(pre[i], cur[i], 3,
                                               relu=True))
                else:
                    transition.append(None)
            self.add_module(f'transition{si - 1}', transition)
            self.add_module(f'stage{si}', nn.Sequential(*[
                HRModule(nb, cfg['block'], cfg['num_blocks'], cur,
                         dtype=dtype)
                for _ in range(cfg['num_modules'])]))
            pre = cur

    def forward(self, x: torch.Tensor, gen=None):
        """x (B, H, W, 3) -> tuple of (B, H_b, W_b, C_b); ``gen`` unused."""
        d = self.compute_dtype
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = torch.relu(bn(conv_nhwc(x, conv, False, d, False))).to(d)
        xs = [self.layer1(x)]
        for si in (2, 3, 4):
            new = []
            for i, layer in enumerate(getattr(self, f'transition{si - 1}')):
                if i >= len(xs):
                    new.append(_run(xs[-1], layer[0], d))
                elif layer is not None:
                    new.append(_run(xs[i], layer, d))
                else:
                    new.append(xs[i])
            xs = getattr(self, f'stage{si}')(new)
        return tuple(xs)

    def init_weights(self, gen: torch.Generator):
        """flax's lecun-normal convs; BN at 1, 0 with statistics 0, 1."""
        init_resnet_modules(self, gen)
