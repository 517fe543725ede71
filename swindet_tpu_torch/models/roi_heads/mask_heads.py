"""FCN mask head (counterpart of
``swindet_tpu/models/roi_heads/mask_heads.py``: ``FCNMaskHead`` :25,
``get_targets`` :95, ``loss`` :161, ``get_mask_probs`` :176; reference
fcn_mask_head.py:20, mmdet/core/mask/mask_target.py:6).

Convs (the conv3x3 kernel with fused ReLU at 256 channels) -> 2x2
stride-2 deconv + ReLU -> 1x1 logits, NHWC. The deconv keeps the torch
``ConvTranspose2d`` weight (in, out, kh, kw) and runs as one matmul, since
its kernel and stride are equal and no two taps overlap.

Mask targets crop the gt bitmaps at the positive boxes with RoIAlign's
adaptive sampling, as the separable product A_y . mask . A_x^T of
per-roi interpolation matrices (the JAX package's default path), then
threshold at 0.5.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import build_loss
from ..layers import (ConvModule, conv_nhwc, init_conv, lecun_normal_,
                      resolve_dtype)
from ...ops.roi_align import SR0_GMAX, adaptive_grid
from ...registries import HEADS


def interp_matrices(coords: torch.Tensor, n_pix: torch.Tensor,
                    origin: torch.Tensor, s: int, r: int, out_size: int,
                    count: torch.Tensor) -> torch.Tensor:
    """Averaged linear-interpolation weights A (R, out_size, s) of the
    samples ``coords`` (R, r, out_size), -2 marking unused or outside
    samples, over the cells origin .. origin + s - 1 of an axis of
    ``n_pix`` cells, divided by the per-roi sample counts ``count``
    (the port's copy of ``swindet_tpu/ops/roi_align_pallas.py:63``)."""
    org = origin.float()[:, None, None]
    cells = torch.arange(s, dtype=torch.float32,
                         device=coords.device)[None, None, :] + org
    npx = n_pix.float()[:, None, None]
    acc = coords.new_zeros((coords.shape[0], out_size, s))
    for j in range(r):
        y = coords[:, j, :, None]
        yc = torch.minimum(y.clamp(min=0.0), npx - 1.0)
        yc = torch.minimum(torch.maximum(yc, org), org + s - 1.0)
        w = (1.0 - (yc - cells).abs()).clamp(min=0.0)
        acc = acc + torch.where(y >= -1.5, w, 0.0)
    return acc / count[:, None, None]


@HEADS.register_module()
class FCNMaskHead(nn.Module):

    def __init__(self, num_convs: int = 4, roi_feat_size: int = 14,
                 in_channels: int = 256, conv_kernel_size: int = 3,
                 conv_out_channels: int = 256, num_classes: int = 80,
                 class_agnostic: bool = False,
                 upsample_cfg: Optional[dict] = None,
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None, loss_mask=None,
                 dtype=torch.float32):
        # conv_cfg is taken and not applied: the JAX head builds its convs
        # without it (swindet_tpu/models/roi_heads/mask_heads.py:39-46), so
        # configs/gn+ws's ConvWS leaves its mask convs plain there
        super().__init__()
        up = upsample_cfg or dict(type='deconv', scale_factor=2)
        if up.get('type', 'deconv') != 'deconv' \
                or up.get('scale_factor', 2) != 2:
            raise NotImplementedError(f'FCNMaskHead: upsample {up}')
        self.class_agnostic = class_agnostic
        self.num_classes = num_classes
        self.loss_mask = build_loss(dict(loss_mask or dict(
            type='CrossEntropyLoss', use_mask=True, loss_weight=1.0)))
        self.compute_dtype = resolve_dtype(dtype)
        chans = [in_channels] + [conv_out_channels] * num_convs
        self.convs = nn.ModuleList([
            ConvModule(chans[i], chans[i + 1], conv_kernel_size,
                       padding=conv_kernel_size // 2, norm_cfg=norm_cfg,
                       act_cfg=dict(type='ReLU'), dtype=dtype)
            for i in range(num_convs)])
        self.upsample = nn.ConvTranspose2d(chans[-1], conv_out_channels, 2,
                                           stride=2)
        self.conv_logits = nn.Conv2d(conv_out_channels,
                                     1 if class_agnostic else num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, 14, 14, C) -> (R, 28, 28, num_classes) logits."""
        for conv in self.convs:
            x = conv(x)
        return self.upsample_logits(x)

    def upsample_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The conv tower's output (R, 14, 14, C) -> the logits (R, 28, 28,
        num_classes): the deconv, its ReLU and the 1x1 logits conv."""
        d = self.compute_dtype
        r, h, w, _ = x.shape
        wt = self.upsample.weight                      # (in, out, 2, 2)
        co = wt.shape[1]
        y = torch.matmul(x.to(d), wt.reshape(wt.shape[0], -1).to(d))
        y = y.view(r, h, w, co, 2, 2).permute(0, 1, 4, 2, 5, 3) \
            .reshape(r, 2 * h, 2 * w, co)
        y = torch.relu(y + self.upsample.bias.to(d))
        return conv_nhwc(y, self.conv_logits, False, d, False)

    def init_weights(self, gen: torch.Generator):
        """flax defaults of the JAX head: lecun-normal convs, deconv and
        logits, zero biases."""
        for conv in self.convs:
            conv.init_weights(gen)
        up = self.upsample
        lecun_normal_(up.weight, up.in_channels * 4, gen)
        nn.init.zeros_(up.bias)
        init_conv(self.conv_logits, gen)

    @staticmethod
    def get_targets(gt_masks: torch.Tensor, pos_boxes: torch.Tensor,
                    pos_gt_inds: torch.Tensor,
                    mask_size: int) -> torch.Tensor:
        """Binary (M, s, s) targets of one image: gt_masks (G, H, W) at the
        padded input resolution cropped at pos_boxes (M, 4) from the masks
        pos_gt_inds (M,)."""
        _, hh, ww = gt_masks.shape
        m = pos_boxes.shape[0]
        s, r = mask_size, SR0_GMAX
        dev = pos_boxes.device
        x1 = pos_boxes[:, 0] - 0.5
        y1 = pos_boxes[:, 1] - 0.5
        x2 = pos_boxes[:, 2] - 0.5
        y2 = pos_boxes[:, 3] - 0.5
        bins = torch.arange(s, dtype=torch.float32, device=dev)
        slot = torch.arange(r, dtype=torch.float32, device=dev)[None, :, None]

        def samples(lo, hi, extent):
            sub, _, g = adaptive_grid(hi - lo, s, r)
            pos = lo[:, None, None] + (bins[None, None, :] + sub[:, :, None]) \
                * ((hi - lo) / s)[:, None, None]
            pos = torch.where((pos >= -1.0) & (pos <= extent)
                              & (slot < g[:, None, None]), pos, -2.0)
            return pos, g

        ys, g_y = samples(y1, y2, hh)
        xs, g_x = samples(x1, x2, ww)
        zero = torch.zeros(m, dtype=torch.int32, device=dev)
        ay = interp_matrices(ys, torch.full_like(zero, hh), zero, hh, r, s,
                             g_y)
        ax = interp_matrices(xs, torch.full_like(zero, ww), zero, ww, r, s,
                             g_x)
        masks = gt_masks[pos_gt_inds.long()].float()
        crops = torch.einsum('mow,mpw->mop',
                             torch.einsum('moh,mhw->mow', ay, masks), ax)
        return (crops >= 0.5).float()

    def loss(self, mask_pred: torch.Tensor, mask_targets: torch.Tensor,
             labels: torch.Tensor, pos_mask: torch.Tensor):
        """Per-roi BCE on each positive's own class channel, averaged
        over the positives. All flattened over (B * M)."""
        if self.class_agnostic:
            pred = mask_pred[..., 0]
        else:
            safe = labels.long().clamp(0, self.num_classes - 1)
            pred = torch.gather(mask_pred, 3, safe[:, None, None, None]
                                .expand(-1, *mask_pred.shape[1:3], 1))[..., 0]
        return dict(loss_mask=self.loss_mask(
            pred, mask_targets, weight=pos_mask,
            avg_factor=pos_mask.sum().clamp(min=1.0)))

    def get_mask_probs(self, mask_pred: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
        """Sigmoid of each detection's own class channel:
        (R, s, s, K) + (R,) -> (R, s, s) fp32."""
        if self.class_agnostic:
            pred = mask_pred[..., 0]
        else:
            safe = labels.clamp(0, self.num_classes - 1)
            idx = safe[:, None, None, None].expand(-1, *mask_pred.shape[1:3],
                                                    1)
            pred = torch.gather(mask_pred, 3, idx)[..., 0]
        return torch.sigmoid(pred.float())
