"""3x3 stride-1 SAME convolution over NHWC with fused bias and ReLU.

Counterpart of ``swindet_tpu/ops/conv3x3.py``. :func:`conv3x3` runs a
hand-written implicit-GEMM kernel (``csrc/conv3x3.cu``, replacing the
Pallas ``_conv_kernel``) on a CUDA tensor and the plain version
:func:`conv3x3_reference` on a CPU tensor; :func:`conv3x3_dw` runs a
filter-gradient kernel (replacing ``_dw_kernel``) or its plain version
:func:`conv3x3_dw_reference`. On the card each picks its kernel by dtype
alone: bf16 runs the tensor-core kernels (TMA loads and wgmma, counted in
``wrapper.tc_launches`` as well as ``wrapper.launches``), fp32 the SIMT
kernels. :func:`conv3x3_op` is the differentiable entry point
(``conv3x3`` with ``_c3_fwd`` / ``conv3x3_bwd_pallas``, :183-226): dx is
the forward kernel applied to g with the weight rotated by 180 degrees, dw
the filter-gradient kernel, db the sum of g. Weights are HWIO as in the
JAX package; :func:`hwio` turns a torch OIHW weight into that layout.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P) + (_I,) * 6 + (_P,)
_DW_ARGTYPES = (_P, _P, _P) + (_I,) * 5 + (_P,)
_TC_ARGTYPES = (_P, _P, _P, _P) + (_I,) * 8 + (_P,)
_DW_TC_ARGTYPES = (_P, _P, _P) + (_I,) * 8 + (_P,)
# the fp32 SIMT kernel stages K slices of 16 channels; the bf16 kernels'
# TMA needs rows and strides in multiples of 16 bytes
CHANNEL_MULTIPLE = {torch.float32: 16, torch.bfloat16: 8}
# the tensor-core kernels read the image in spatial boxes of 64 pixels
BOX_SHAPES = ((1, 64), (2, 32), (4, 16), (8, 8))
# the bf16 filter gradient's block tile, input by output channels, and
# its blocks in waves over the SMs
DW_TILE = (128, 256)
DW_WAVES = 3


def box_shape(h: int, w: int):
    """The (rows, columns) box of 64 pixels that pads an h x w map least
    (ties to the wider box): 4 x 16 for FPN P2 (200 x 336), 8 x 8 for the
    14 x 14 mask-head maps."""
    return min(BOX_SHAPES, key=lambda s: -(-h // s[0]) * s[0]
               * (-(-w // s[1]) * s[1]))


def dw_chunk(boxes: int, tiles: int, sms: int) -> int:
    """Pixel boxes per block of the bf16 filter gradient: split the
    ``boxes`` so that ``tiles`` x splits blocks make about DW_WAVES waves
    over ``sms`` SMs (one block an SM), with at least one box a block."""
    splits = max(1, min(boxes, DW_WAVES * sms // tiles))
    return -(-boxes // splits)


def hwio(weight_oihw: torch.Tensor) -> torch.Tensor:
    """(Co, C, 3, 3) torch conv weight -> contiguous (3, 3, C, Co)."""
    return weight_oihw.permute(2, 3, 1, 0).contiguous()


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      relu: bool = False) -> torch.Tensor:
    """Plain version: an fp32 conv of x (B, H, W, C) with w (3, 3, C, Co)
    plus b (Co,), optional ReLU, output in x's dtype."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2),
                   w.float().permute(3, 2, 0, 1), b.float(), padding=1)
    out = out.permute(0, 2, 3, 1)
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            relu: bool = False) -> torch.Tensor:
    """x (B, H, W, C) and w (3, 3, C, Co) of one dtype, b (Co,) fp32. On
    the card bf16 runs the tensor-core kernel (C and Co multiples of 8),
    fp32 the SIMT kernel (C a multiple of 16)."""
    if x.device.type == 'cpu':
        return conv3x3_reference(x, w, b, relu)
    if x.device.type != 'cuda':
        raise ValueError(f'conv3x3: unsupported device {x.device}')
    build.dtype_code(x, 'conv3x3')
    bs, h, wd, c = x.shape
    co = w.shape[3]
    if tuple(w.shape) != (3, 3, c, co) or w.dtype != x.dtype:
        raise ValueError(f'conv3x3: weight {tuple(w.shape)} {w.dtype} does '
                         f'not match (3, 3, {c}, Co) {x.dtype}')
    mult = CHANNEL_MULTIPLE[x.dtype]
    tc = x.dtype == torch.bfloat16
    if c % mult or (tc and co % mult):
        raise ValueError(f'conv3x3: {x.dtype} takes channels in multiples '
                         f'of {mult}, got {c} -> {co}')
    if b.dtype != torch.float32 or tuple(b.shape) != (co,):
        raise ValueError(f'conv3x3: bias must be fp32 ({co},)')
    for name, t in (('x', x), ('w', w), ('b', b)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f'conv3x3: {name} must be contiguous on '
                             f'{x.device}')
    out = torch.empty((bs, h, wd, co), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bs, h,
            wd, c, co, int(relu))
    with torch.cuda.device(x.device):
        if tc:
            build.check_aligned('conv3x3', x, w)
            fn = build.bind('conv3x3', 'swindet_conv3x3_tc', _TC_ARGTYPES)
            status = fn(*args, *box_shape(h, wd),
                        build.stream_ptr(x.device))
        else:
            fn = build.bind('conv3x3', 'swindet_conv3x3', _ARGTYPES)
            status = fn(*args, build.stream_ptr(x.device))
    build.check_launch('conv3x3', status)
    conv3x3.launches += 1
    conv3x3.tc_launches += tc
    return out


conv3x3.launches = 0
conv3x3.tc_launches = 0


def conv3x3_dw_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the filter gradient of a 3x3 SAME conv: x
    (B, H, W, C) and g (B, H, W, Co) -> (3, 3, C, Co) fp32, each tap the
    fp32 product of the shifted, zero-padded input with g over every
    pixel."""
    b, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float().reshape(-1, g.shape[-1])
    taps = [xp[:, dy:dy + h, dx:dx + w].reshape(-1, c).t() @ gf
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).view(3, 3, c, g.shape[-1])


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Filter gradient (3, 3, C, Co) fp32 of x (B, H, W, C) and g
    (B, H, W, Co) of one dtype. On the card bf16 runs the tensor-core
    kernel (C and Co multiples of 8), fp32 the SIMT kernel."""
    if x.device.type == 'cpu':
        return conv3x3_dw_reference(x, g)
    if x.device.type != 'cuda':
        raise ValueError(f'conv3x3_dw: unsupported device {x.device}')
    build.dtype_code(x, 'conv3x3_dw')
    bs, h, wd, c = x.shape
    co = g.shape[-1]
    if g.dtype != x.dtype or tuple(g.shape) != (bs, h, wd, co):
        raise ValueError(f'conv3x3_dw: g {tuple(g.shape)} {g.dtype} does not '
                         f'match ({bs}, {h}, {wd}, Co) {x.dtype}')
    tc = x.dtype == torch.bfloat16
    mult = CHANNEL_MULTIPLE[x.dtype]
    if tc and (c % mult or co % mult):
        raise ValueError(f'conv3x3_dw: {x.dtype} takes channels in '
                         f'multiples of {mult}, got {c} -> {co}')
    for name, t in (('x', x), ('g', g)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f'conv3x3_dw: {name} must be contiguous on '
                             f'{x.device}')
    dw = torch.zeros((3, 3, c, co), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), g.data_ptr(), dw.data_ptr(), bs, h, wd, c, co)
    with torch.cuda.device(x.device):
        if tc:
            build.check_aligned('conv3x3_dw', x, g)
            bh, bw = box_shape(h, wd)
            boxes = bs * -(-h // bh) * -(-wd // bw)
            tiles = 9 * -(-c // DW_TILE[0]) * -(-co // DW_TILE[1])
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            fn = build.bind('conv3x3', 'swindet_conv3x3_dw_tc',
                            _DW_TC_ARGTYPES)
            status = fn(*args, bh, bw, dw_chunk(boxes, tiles, sms),
                        build.stream_ptr(x.device))
        else:
            fn = build.bind('conv3x3', 'swindet_conv3x3_dw', _DW_ARGTYPES)
            status = fn(*args, build.stream_ptr(x.device))
    build.check_launch('conv3x3_dw', status)
    conv3x3_dw.launches += 1
    conv3x3_dw.tc_launches += tc
    return dw


conv3x3_dw.launches = 0
conv3x3_dw.tc_launches = 0


class Conv3x3Function(torch.autograd.Function):
    """``conv3x3`` with ``_c3_fwd`` / ``conv3x3_bwd_pallas``: the output
    is saved only where the ReLU mask needs it. dx comes out in x's dtype,
    dw in fp32 cast to w's dtype, db in b's dtype."""

    @staticmethod
    def forward(ctx, x, w, b, relu):
        out = conv3x3(x, w, b, relu)
        ctx.save_for_backward(x, w, b, out if relu else None)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, b, out = ctx.saved_tensors
        g = g.contiguous()
        if ctx.relu:
            g = g * (out > 0).to(g.dtype)
        # rot180 and (C, Co) -> (Co, C): dx is a SAME conv of g with wt
        wt = w.flip(0, 1).transpose(2, 3).contiguous().to(g.dtype)
        zero = torch.zeros(x.shape[-1], dtype=torch.float32, device=g.device)
        dx = conv3x3(g, wt, zero)
        dw = conv3x3_dw(x, g).to(w.dtype)
        db = g.float().sum((0, 1, 2)).to(b.dtype)
        return dx.to(x.dtype), dw, db, None


def conv3x3_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               relu: bool = False) -> torch.Tensor:
    """Differentiable :func:`conv3x3`."""
    return Conv3x3Function.apply(x, w, b, relu)
