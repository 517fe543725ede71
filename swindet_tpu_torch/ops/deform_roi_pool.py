"""Deformable RoI pooling in plain torch (counterpart of
``swindet_tpu/ops/deform_roi_pool.py:32`` ``multilevel_deform_roi_pool``;
mmcv's deform_roi_pool, reached through
``roi_layer=dict(type='DeformRoIPoolPack' | 'ModulatedDeformRoIPoolPack')``
in configs/dcn/faster_rcnn_r50_fpn_{dpool,mdpool}_1x_coco.py).

The JAX package computes it in XLA, outside any Pallas kernel. It is
aligned RoIAlign averaging (mmcv's border rule, the adaptive grid capped at
``SR0_GMAX``) with each bin's sampling window moved by
``gamma * (roi_w, roi_h) * offset[r, ph, pw]`` in feature cells: the
per-bin shift breaks the separable form of RoIAlign, so every sample of
the (R, out, out, g, g) lattice is gathered. Here the rois go in chunks in
the order of their extent, each chunk on its largest roi's grid (the
slots past a roi's own grid weigh 0, as the JAX package's unused slots),
so that the lattice holds what the rois need rather than g = 8
everywhere. Autograd gives the gradients in the features and the offsets.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .roi_align import SR0_GMAX, _flat_layout, adaptive_grid, map_roi_levels

# rois per chunk: a chunk's (R, out, out, g, g, C) samples at most this
# many at the grid of a roi of a 14-28 cell extent (a level's range), more
# at the grid of the largest
_CHUNK_ELEMS = 1 << 25
_TYPICAL_GRID = 4


def _bilinear(feat_flat, y, x, h, w, base):
    """Bilinear samples of the flat (B * total, C) map at fractional (y, x)
    of the level (h, w) whose rows start at ``base``: mmcv's border rule,
    zero outside [-1, h] x [-1, w], clamped into the map within it."""
    valid = (y >= -1.0) & (y <= h) & (x >= -1.0) & (x <= w)
    y = torch.minimum(y.clamp(min=0.0), h - 1.0)
    x = torch.minimum(x.clamp(min=0.0), w - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1 = torch.minimum(y0 + 1, h - 1.0)
    x1 = torch.minimum(x0 + 1, w - 1.0)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    c = feat_flat.shape[-1]

    def take(yy, xx):
        idx = (base + yy * w + xx).long()
        return feat_flat.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, c).float()

    out = (take(y0, x0) * (hy * hx)[..., None]
           + take(y0, x1) * (hy * lx)[..., None]
           + take(y1, x0) * (ly * hx)[..., None]
           + take(y1, x1) * (ly * lx)[..., None])
    return torch.where(valid[..., None], out, 0.0)


def _pool_chunk(feat_flat, rois, lvl, offset, shapes, offsets, strides,
                total, out_size, g, gamma, sampling_ratio):
    dev = rois.device

    def table(vals):
        return torch.tensor([float(v) for v in vals], device=dev)[lvl]
    lvl_h, lvl_w = table(s[0] for s in shapes), table(s[1] for s in shapes)
    scale = 1.0 / table(strides)
    base = rois[:, 0] * float(total) + table(offsets)
    x1 = rois[:, 1] * scale - 0.5
    y1 = rois[:, 2] * scale - 0.5
    roi_w = rois[:, 3] * scale - 0.5 - x1
    roi_h = rois[:, 4] * scale - 0.5 - y1
    bin_w, bin_h = roi_w / out_size, roi_h / out_size
    n = rois.shape[0]
    if sampling_ratio > 0:
        sub = ((torch.arange(g, device=dev, dtype=torch.float32) + 0.5)
               / g).expand(n, g)
        sub_y = sub_x = sub
        w_y = w_x = torch.full((n, g), 1.0 / g, device=dev)
    else:
        sub_y, w_y, _ = adaptive_grid(roi_h, out_size, g)
        sub_x, w_x, _ = adaptive_grid(roi_w, out_size, g)
    off_x = gamma * roi_w[:, None, None] * offset[..., 0]   # (R, out, out)
    off_y = gamma * roi_h[:, None, None] * offset[..., 1]
    bins = torch.arange(out_size, device=dev, dtype=torch.float32)
    yy = (y1[:, None, None, None, None]
          + (bins[None, :, None, None, None] + sub_y[:, None, None, :, None])
          * bin_h[:, None, None, None, None] + off_y[..., None, None])
    xx = (x1[:, None, None, None, None]
          + (bins[None, None, :, None, None] + sub_x[:, None, None, None, :])
          * bin_w[:, None, None, None, None] + off_x[..., None, None])
    yy, xx = torch.broadcast_tensors(yy, xx)           # (R, out, out, g, g)
    geo = [t[:, None, None, None, None] for t in (lvl_h, lvl_w, base)]
    vals = _bilinear(feat_flat, yy, xx, *geo)
    wgt = w_y[:, None, None, :, None] * w_x[:, None, None, None, :]
    return (vals * wgt[..., None]).sum(dim=(3, 4))


def multilevel_deform_roi_pool(feats: Sequence[torch.Tensor],
                               rois: torch.Tensor, offset: torch.Tensor,
                               strides: Sequence[int], out_size: int,
                               sampling_ratio: int = 0, gamma: float = 0.1,
                               finest_scale: int = 56,
                               roi_valid: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Deformable RoI pool over FPN levels. feats: per-level
    (B, H_l, W_l, C); rois (R, 5) [batch, x1, y1, x2, y2] in image
    coordinates; offset (R, out, out, 2) per-bin (dx, dy) in units of
    gamma times the roi's extent (mmcv's (R, 2, out, out) moved
    channel-last). Returns (R, out, out, C) fp32; invalid rois give
    zeros."""
    b, c = feats[0].shape[0], feats[0].shape[-1]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    offsets, total = _flat_layout(shapes)
    feat_flat = torch.cat([f.reshape(b, -1, c) for f in feats], dim=1) \
        .reshape(b * total, c)
    rois = rois.float()
    n = rois.shape[0]
    lvl = map_roi_levels(rois, len(feats), finest_scale)
    stride = torch.tensor([float(s) for s in strides],
                          device=rois.device)[lvl]
    # each roi's samples a bin and axis, and the rois in their order
    ext = torch.maximum(rois[:, 3] - rois[:, 1],
                        rois[:, 4] - rois[:, 2]) / stride
    if sampling_ratio > 0:
        grid = torch.full_like(ext, float(sampling_ratio))
    else:
        grid = torch.nan_to_num(torch.ceil(ext / out_size), nan=1.0) \
            .clamp(1, SR0_GMAX)
    order = torch.argsort(grid, stable=True)
    chunk = max(1, _CHUNK_ELEMS // (out_size * out_size * _TYPICAL_GRID ** 2
                                    * c))
    starts = list(range(0, n, chunk))
    # one host read for every chunk's grid: its largest roi's
    ends = torch.tensor([min(s + chunk, n) - 1 for s in starts],
                        device=rois.device, dtype=torch.long)
    gmax = grid[order][ends].long().tolist() if starts else []
    outs = []
    for s, g in zip(starts, gmax):
        idx = order[s:s + chunk]
        outs.append(_pool_chunk(feat_flat, rois[idx], lvl[idx],
                                offset[idx].float(), shapes, offsets,
                                strides, total, out_size, g, gamma,
                                sampling_ratio))
    out = feat_flat.new_zeros((n, out_size, out_size, c),
                              dtype=torch.float32)
    if outs:
        out = out.index_copy(0, order, torch.cat(outs))
    if roi_valid is not None:
        out = torch.where(roi_valid[:, None, None, None], out, 0.0)
    return out
