"""Multilevel RoIAlign (mmcv semantics: aligned=True, adaptive sampling).

Counterpart of ``swindet_tpu/ops/roi_align.py`` (the contract, ported here
as the plain version :func:`multilevel_roi_align`) and of
``swindet_tpu/ops/roi_align_pallas.py`` (the TPU kernels, replaced by
``csrc/roi_align.cu``, which computes the same separable form
A_y . F . A_x^T). :func:`roi_align` runs the forward kernel on CUDA
tensors and the plain version on CPU tensors; :func:`roi_align_bwd` runs
the backward kernel (replacing ``_roi_align_bwd_kernel``; it writes every
level once, with no atomics, so it is deterministic) or its plain version
:func:`multilevel_roi_align_backward`, the exact gradient of the contract
for every roi. Both route rois to FPN levels with
:func:`map_roi_levels`. :func:`roi_align_op` is the differentiable entry
point (``_rap_vjp``): feature gradients for every level, none for the
rois, which are detached proposals throughout (:558-561).

``sampling_ratio=0`` is mmcv's adaptive grid, ``ceil(extent / out_size)``
samples per bin and axis, capped at :data:`SR0_GMAX` as in the JAX
package.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import build

# per-axis cap on the adaptive sample count (swindet_tpu/ops/roi_align.py)
SR0_GMAX = 8
# rois per chunk of the plain version: bounds its (R, P, P, C) sample grid
_PLAIN_CHUNK_ELEMS = 1 << 26

# the kernels carry 8 channels a thread in 16-byte pieces; the forward
# runs C / 8 threads on a roi, at most 256; the backward holds at most
# 64 x 64 bins
CHANNEL_MULTIPLE = 8
MAX_CHANNELS = 2048
MAX_BWD_OUT_SIZE = 64

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# swindet_roi_align_bwd takes the same arguments, with the level gradients
# in place of the features and grad_out in place of out, and its scratch
# before the stream
_BWD_ARGTYPES = _ARGTYPES[:-1] + (ctypes.c_void_p, ctypes.c_void_p)
# the backward's items: 16 x 16-cell tiles of every level and image, each
# in 64-channel chunks (csrc/roi_align.cu kTile, kBwdChunk)
BWD_TILE = 16
BWD_CHUNK = 64


def _check_channels(kernel: str, c: int) -> None:
    if c % CHANNEL_MULTIPLE or c > MAX_CHANNELS:
        raise ValueError(f'{kernel}: C must be a multiple of '
                         f'{CHANNEL_MULTIPLE} up to {MAX_CHANNELS}, got {c}')


def _bwd_items(feat_shapes: Sequence[Sequence[int]]) -> int:
    """The backward kernel's items, which its scratch holds a byte each."""
    tiles = sum(b * -(-h // BWD_TILE) * -(-w // BWD_TILE)
                for b, h, w, _ in feat_shapes)
    return tiles * -(-feat_shapes[0][-1] // BWD_CHUNK)


def adaptive_grid(extent: torch.Tensor, out_size: int, g_max: int):
    """Per-roi sample offsets (R, g_max), weights (R, g_max) (0 for unused
    slots) and counts (R,) along one axis."""
    g = torch.ceil(extent / out_size).clamp(1, g_max)
    k = torch.arange(g_max, dtype=extent.dtype, device=extent.device)
    steps = (k[None, :] + 0.5) / g[:, None]
    weights = torch.where(k[None, :] < g[:, None], 1.0 / g[:, None],
                          torch.zeros((), dtype=extent.dtype,
                                      device=extent.device))
    return steps, weights, g


def map_roi_levels(rois: torch.Tensor, num_levels: int,
                   finest_scale: int = 56) -> torch.Tensor:
    """FPN level per roi, floor(log2(sqrt(area) / finest_scale + 1e-6))
    clamped to the levels, as int64."""
    scale = torch.sqrt((rois[:, 3] - rois[:, 1]) * (rois[:, 4] - rois[:, 2]))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def _level_tables(shapes, offsets, strides, lvl, dev):
    """Per-roi level height, width, flat row offset and 1 / stride."""
    def table(vals):
        return torch.tensor([float(v) for v in vals], device=dev)[lvl]
    return (table(s[0] for s in shapes), table(s[1] for s in shapes),
            table(offsets), 1.0 / table(strides))


def _taps(rois, lvl, shapes, offsets, strides, total, out_size,
          sampling_ratio):
    """Sampling geometry of a chunk of rois: the flat feature rows of the
    four bilinear taps of every sample and their weights (each (R, P, P),
    P = out_size * samples per bin), the mask of samples inside the map
    (R, P, P) and the bin weights (R, out, r, out, r)."""
    dev = rois.device
    lvl_h, lvl_w, lvl_off, scale = _level_tables(shapes, offsets, strides,
                                                 lvl, dev)
    base = rois[:, 0] * float(total) + lvl_off

    x1 = rois[:, 1] * scale - 0.5
    y1 = rois[:, 2] * scale - 0.5
    x2 = rois[:, 3] * scale - 0.5
    y2 = rois[:, 4] * scale - 0.5
    bin_w = (x2 - x1) / out_size
    bin_h = (y2 - y1) / out_size
    n = rois.shape[0]
    if sampling_ratio > 0:
        r = sampling_ratio
        sub_y = ((torch.arange(r, device=dev, dtype=torch.float32) + 0.5)
                 / r).expand(n, r)
        sub_x = sub_y
        w_y = torch.full((n, r), 1.0 / r, device=dev)
        w_x = w_y
    else:
        # the chunk's largest adaptive grid: the slots past it weigh 0 in
        # every roi, so they are not sampled
        g = torch.ceil(torch.maximum(y2 - y1, x2 - x1) / out_size) \
            .clamp(1, SR0_GMAX)
        r = int(torch.nan_to_num(g, nan=1.0).max()) if n else 1
        sub_y, w_y, _ = adaptive_grid(y2 - y1, out_size, r)
        sub_x, w_x, _ = adaptive_grid(x2 - x1, out_size, r)

    bins = torch.arange(out_size, device=dev, dtype=torch.float32)
    ys = y1[:, None, None] + (bins[None, :, None] + sub_y[:, None, :]) \
        * bin_h[:, None, None]
    xs = x1[:, None, None] + (bins[None, :, None] + sub_x[:, None, :]) \
        * bin_w[:, None, None]
    yy = ys.reshape(n, -1)[:, :, None]                  # (R, P, 1)
    xx = xs.reshape(n, -1)[:, None, :]                  # (R, 1, P)
    h = lvl_h[:, None, None]
    w = lvl_w[:, None, None]

    valid = (yy >= -1.0) & (yy <= h) & (xx >= -1.0) & (xx <= w)
    yy = torch.minimum(yy.clamp(min=0.0), h - 1.0)
    xx = torch.minimum(xx.clamp(min=0.0), w - 1.0)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    y1i = torch.minimum(y0 + 1, h - 1.0)
    x1i = torch.minimum(x0 + 1, w - 1.0)
    ly = yy - y0
    lx = xx - x0
    hy = 1.0 - ly
    hx = 1.0 - lx
    off = base[:, None, None]

    def row(ty, tx):
        return (off + ty * w + tx).long()

    idx = (row(y0, x0), row(y0, x1i), row(y1i, x0), row(y1i, x1i))
    wts = (hy * hx, hy * lx, ly * hx, ly * lx)
    wgt = w_y[:, None, :, None, None] * w_x[:, None, None, None, :]
    return idx, wts, valid, wgt


def _align_chunk(feat_flat, rois, lvl, shapes, offsets, strides, total,
                 out_size, sampling_ratio):
    idx, wts, valid, wgt = _taps(rois, lvl, shapes, offsets, strides, total,
                                 out_size, sampling_ratio)
    vals = sum(feat_flat[i].float() * t[..., None]      # (R, P, P, C)
               for i, t in zip(idx, wts))
    vals = torch.where(valid[..., None], vals, 0.0)
    n, c = rois.shape[0], feat_flat.shape[-1]
    r = wgt.shape[2]
    vals = vals.view(n, out_size, r, out_size, r, c)
    return (vals * wgt[..., None]).sum(dim=(2, 4))


def _align_chunk_bwd(grad_flat, g, rois, lvl, shapes, offsets, strides,
                     total, out_size, sampling_ratio):
    """Adds the feature gradient of a chunk of rois into grad_flat
    (B * total, C) fp32."""
    idx, wts, valid, wgt = _taps(rois, lvl, shapes, offsets, strides, total,
                                 out_size, sampling_ratio)
    n, c = rois.shape[0], grad_flat.shape[-1]
    r = wgt.shape[2]
    gs = g.float()[:, :, None, :, None, :] * wgt[..., None]
    gs = gs.reshape(n, out_size * r, out_size * r, c)
    gs = torch.where(valid[..., None], gs, 0.0)
    for i, t in zip(idx, wts):
        grad_flat.index_add_(0, i.reshape(-1),
                             (gs * t[..., None]).reshape(-1, c))


def _flat_layout(shapes):
    """Flat row offsets of the levels and their total rows per image."""
    offsets, acc = [], 0
    for h, w in shapes:
        offsets.append(acc)
        acc += h * w
    return offsets, acc


def _plain_chunk(out_size: int, sampling_ratio: int, c: int) -> int:
    """Rois per chunk of the plain versions."""
    r = sampling_ratio if sampling_ratio > 0 else SR0_GMAX
    return max(1, _PLAIN_CHUNK_ELEMS // ((out_size * r) ** 2 * c))


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], out_size: int,
                         sampling_ratio: int = 0, finest_scale: int = 56,
                         roi_valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version. feats: per-level (B, H_l, W_l, C); rois (R, 5)
    [batch, x1, y1, x2, y2] in image coordinates. Returns (R, out_size,
    out_size, C) in the features' dtype; invalid rois give zeros."""
    num_levels = len(feats)
    b, c = feats[0].shape[0], feats[0].shape[-1]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    offsets, total = _flat_layout(shapes)
    feat_flat = torch.cat([f.reshape(b, -1, c) for f in feats], dim=1) \
        .reshape(b * total, c)
    rois = rois.float()
    lvl = map_roi_levels(rois, num_levels, finest_scale)
    chunk = _plain_chunk(out_size, sampling_ratio, c)
    # rois in the order of their extent in cells, so that each chunk's
    # adaptive grid (its largest roi's) is close to what its rois need
    ext = torch.maximum(rois[:, 3] - rois[:, 1], rois[:, 4] - rois[:, 2]) \
        / torch.tensor([float(s) for s in strides], device=rois.device)[lvl]
    order = torch.argsort(ext, stable=True)
    outs = [_align_chunk(feat_flat, rois[order[s:s + chunk]],
                         lvl[order[s:s + chunk]], shapes, offsets, strides,
                         total, out_size, sampling_ratio)
            for s in range(0, rois.shape[0], chunk)]
    out = feat_flat.new_zeros((rois.shape[0], out_size, out_size, c),
                              dtype=torch.float32)
    if outs:
        out[order] = torch.cat(outs)
    if roi_valid is not None:
        out = torch.where(roi_valid[:, None, None, None], out, 0.0)
    return out.to(feats[0].dtype)


def roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
              strides: Sequence[int], out_size: int,
              sampling_ratio: int = 0, finest_scale: int = 56,
              roi_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multilevel RoIAlign with the same arguments as
    :func:`multilevel_roi_align`: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if rois.device.type == 'cpu':
        return multilevel_roi_align(feats, rois, strides, out_size,
                                    sampling_ratio, finest_scale, roi_valid)
    if rois.device.type != 'cuda':
        raise ValueError(f'roi_align: unsupported device {rois.device}')
    feats = list(feats)
    dev, dtype = feats[0].device, feats[0].dtype
    code = build.dtype_code(feats[0], 'roi_align')
    b, c = feats[0].shape[0], feats[0].shape[-1]
    for f in feats:
        if f.device != dev or f.dtype != dtype or f.dim() != 4 \
                or f.shape[0] != b or f.shape[-1] != c \
                or not f.is_contiguous():
            raise ValueError('roi_align: feature levels must be contiguous '
                             f'(B, H, W, C) {dtype} tensors on {dev}')
    if len(strides) != len(feats):
        raise ValueError('roi_align: one stride per feature level')
    if rois.dtype != torch.float32 or rois.dim() != 2 \
            or rois.shape[1] != 5 or rois.device != dev \
            or not rois.is_contiguous():
        raise ValueError(f'roi_align: rois must be a contiguous fp32 (R, 5) '
                         f'tensor on {dev}')
    n = rois.shape[0]
    if roi_valid is not None:
        if roi_valid.shape != (n,) or roi_valid.device != dev:
            raise ValueError(f'roi_align: roi_valid must be ({n},) on {dev}')
        roi_valid = roi_valid.to(torch.uint8).contiguous()
    _check_channels('roi_align', c)
    build.check_aligned('roi_align', *feats)
    lvl = map_roi_levels(rois, len(feats), finest_scale).to(torch.int32)
    out = torch.empty((n, out_size, out_size, c), dtype=dtype, device=dev)
    nl = len(feats)
    ptrs = (ctypes.c_void_p * nl)(*[f.data_ptr() for f in feats])
    heights = (ctypes.c_int * nl)(*[f.shape[1] for f in feats])
    widths = (ctypes.c_int * nl)(*[f.shape[2] for f in feats])
    scales = (ctypes.c_float * nl)(*[1.0 / s for s in strides])
    fn = build.bind('roi_align', 'swindet_roi_align', _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(ptrs, heights, widths, scales, nl, b, rois.data_ptr(),
                    lvl.data_ptr(),
                    None if roi_valid is None else roi_valid.data_ptr(),
                    out.data_ptr(), n, c, out_size, sampling_ratio,
                    SR0_GMAX, code, build.stream_ptr(dev))
    build.check_launch('roi_align', status)
    roi_align.launches += 1
    return out


roi_align.launches = 0


def multilevel_roi_align_backward(feat_shapes: Sequence[Sequence[int]],
                                  dtype: torch.dtype, rois: torch.Tensor,
                                  g: torch.Tensor, strides: Sequence[int],
                                  out_size: int, sampling_ratio: int = 0,
                                  finest_scale: int = 56,
                                  roi_valid: Optional[torch.Tensor] = None
                                  ) -> List[torch.Tensor]:
    """Plain version of the backward: the gradient of
    :func:`multilevel_roi_align` with respect to each feature level
    (shapes ``feat_shapes``, (B, H_l, W_l, C)), given the output gradient
    g (R, out_size, out_size, C). Accumulated in fp32 and returned in
    ``dtype``; invalid rois contribute nothing."""
    b, c = feat_shapes[0][0], feat_shapes[0][-1]
    shapes = [(s[1], s[2]) for s in feat_shapes]
    offsets, total = _flat_layout(shapes)
    rois = rois.float()
    lvl = map_roi_levels(rois, len(shapes), finest_scale)
    if roi_valid is not None:
        g = torch.where(roi_valid[:, None, None, None], g.float(), 0.0)
    grad_flat = torch.zeros((b * total, c), dtype=torch.float32,
                            device=g.device)
    chunk = _plain_chunk(out_size, sampling_ratio, c)
    for s in range(0, rois.shape[0], chunk):
        _align_chunk_bwd(grad_flat, g[s:s + chunk], rois[s:s + chunk],
                         lvl[s:s + chunk], shapes, offsets, strides, total,
                         out_size, sampling_ratio)
    per_image = grad_flat.view(b, total, c)
    return [per_image[:, o:o + h * w].reshape(b, h, w, c).to(dtype)
            for o, (h, w) in zip(offsets, shapes)]


def roi_align_bwd(feat_shapes: Sequence[Sequence[int]], dtype: torch.dtype,
                  rois: torch.Tensor, g: torch.Tensor,
                  strides: Sequence[int], out_size: int,
                  sampling_ratio: int = 0, finest_scale: int = 56,
                  roi_valid: Optional[torch.Tensor] = None
                  ) -> List[torch.Tensor]:
    """Backward of :func:`roi_align` with the arguments of
    :func:`multilevel_roi_align_backward`: the kernel for CUDA tensors,
    which writes every value of the returned levels, the plain version for
    CPU tensors."""
    if rois.device.type == 'cpu':
        return multilevel_roi_align_backward(
            feat_shapes, dtype, rois, g, strides, out_size, sampling_ratio,
            finest_scale, roi_valid)
    if rois.device.type != 'cuda':
        raise ValueError(f'roi_align_bwd: unsupported device {rois.device}')
    dev = rois.device
    code = build.dtype_code(g, 'roi_align_bwd')
    nl = len(feat_shapes)
    b, c = feat_shapes[0][0], feat_shapes[0][-1]
    n = rois.shape[0]
    if any(len(s) != 4 or s[0] != b or s[-1] != c for s in feat_shapes) \
            or len(strides) != nl:
        raise ValueError('roi_align_bwd: levels must be (B, H, W, C) with '
                         'one stride each')
    if rois.dtype != torch.float32 or rois.dim() != 2 \
            or rois.shape[1] != 5 or not rois.is_contiguous():
        raise ValueError('roi_align_bwd: rois must be a contiguous fp32 '
                         '(R, 5) tensor')
    if g.dtype != dtype or tuple(g.shape) != (n, out_size, out_size, c) \
            or g.device != dev or not g.is_contiguous():
        raise ValueError(f'roi_align_bwd: g must be a contiguous {dtype} '
                         f'({n}, {out_size}, {out_size}, {c}) tensor on '
                         f'{dev}')
    if roi_valid is not None:
        if roi_valid.shape != (n,) or roi_valid.device != dev:
            raise ValueError(f'roi_align_bwd: roi_valid must be ({n},) on '
                             f'{dev}')
        roi_valid = roi_valid.to(torch.uint8).contiguous()
    _check_channels('roi_align_bwd', c)
    build.check_aligned('roi_align_bwd', g)
    if out_size > MAX_BWD_OUT_SIZE:
        raise ValueError(f'roi_align_bwd: out_size up to {MAX_BWD_OUT_SIZE}')
    lvl = map_roi_levels(rois, nl, finest_scale).to(torch.int32)
    grads = [torch.empty(tuple(s), dtype=dtype, device=dev)
             for s in feat_shapes]
    ptrs = (ctypes.c_void_p * nl)(*[t.data_ptr() for t in grads])
    heights = (ctypes.c_int * nl)(*[s[1] for s in feat_shapes])
    widths = (ctypes.c_int * nl)(*[s[2] for s in feat_shapes])
    scales = (ctypes.c_float * nl)(*[1.0 / s for s in strides])
    # a byte per item: whether its tile is left to the split kernel
    deferred = torch.empty(_bwd_items(feat_shapes), dtype=torch.uint8,
                           device=dev)
    fn = build.bind('roi_align', 'swindet_roi_align_bwd', _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(ptrs, heights, widths, scales, nl, b, rois.data_ptr(),
                    lvl.data_ptr(),
                    None if roi_valid is None else roi_valid.data_ptr(),
                    g.data_ptr(), n, c, out_size, sampling_ratio, SR0_GMAX,
                    code, deferred.data_ptr(), build.stream_ptr(dev))
    build.check_launch('roi_align_bwd', status)
    roi_align_bwd.launches += 1
    return grads


roi_align_bwd.launches = 0


class RoIAlignFunction(torch.autograd.Function):
    """``_rap_vjp``: gradients for every feature level, in the features'
    dtype; none for the rois or the validity mask."""

    @staticmethod
    def forward(ctx, rois, roi_valid, strides, out_size, sampling_ratio,
                finest_scale, *feats):
        ctx.save_for_backward(rois, roi_valid)
        ctx.args = (tuple(tuple(f.shape) for f in feats), feats[0].dtype,
                    strides, out_size, sampling_ratio, finest_scale)
        return roi_align(feats, rois, strides, out_size, sampling_ratio,
                         finest_scale, roi_valid)

    @staticmethod
    def backward(ctx, g):
        rois, roi_valid = ctx.saved_tensors
        shapes, dtype, strides, out_size, ratio, finest = ctx.args
        grads = roi_align_bwd(shapes, dtype, rois, g.contiguous(), strides,
                              out_size, ratio, finest, roi_valid)
        return (None,) * 6 + tuple(grads)


def roi_align_op(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 strides: Sequence[int], out_size: int,
                 sampling_ratio: int = 0, finest_scale: int = 56,
                 roi_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable :func:`roi_align` in the features."""
    return RoIAlignFunction.apply(rois, roi_valid, tuple(strides), out_size,
                                  sampling_ratio, finest_scale, *feats)
