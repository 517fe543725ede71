"""LayerNorm over the last axis with fp32 statistics and fp32 affine.

Counterpart of ``swindet_tpu/ops/layer_norm.py``. :func:`layer_norm` runs
the hand-written kernel (``csrc/layer_norm.cu``, replacing the Pallas
``_ln_kernel``) on a CUDA tensor and the plain version
:func:`layer_norm_reference` on a CPU tensor. :func:`layer_norm_op` is the
differentiable entry point: the forward is :func:`layer_norm`, and the
backward recomputes through :func:`layer_norm_reference` in plain torch,
as ``_ln_vjp_bwd`` (:58) does in lax; the JAX package has no Pallas
LayerNorm backward.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_void_p)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5
                         ) -> torch.Tensor:
    """Plain version: statistics and affine in fp32, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of any-rank ``x`` over its last axis. ``weight`` and
    ``bias`` are fp32 of shape (C,)."""
    if x.device.type == 'cpu':
        return layer_norm_reference(x, weight, bias, eps)
    if x.device.type != 'cuda':
        raise ValueError(f'layer_norm: unsupported device {x.device}')
    c = x.shape[-1]
    code = build.dtype_code(x, 'layer_norm')
    for name, t in (('weight', weight), ('bias', bias)):
        if t.dtype != torch.float32 or t.shape != (c,) \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f'layer_norm: {name} must be a contiguous fp32 '
                             f'({c},) tensor on {x.device}')
    if not x.is_contiguous():
        raise ValueError('layer_norm: x must be contiguous')
    out = torch.empty_like(x)
    fn = build.bind('layer_norm', 'swindet_layer_norm', _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), x.numel() // max(c, 1), c, eps, code,
                    build.stream_ptr(x.device))
    build.check_launch('layer_norm', status)
    layer_norm.launches += 1
    return out


layer_norm.launches = 0


class LayerNormFunction(torch.autograd.Function):
    """``_ln_vjp``: the kernel forward; the backward differentiates the
    plain version at the saved inputs."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return layer_norm(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = layer_norm_reference(*saved, ctx.eps)
        return (*torch.autograd.grad(y, saved, g), None)


def layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Differentiable :func:`layer_norm`."""
    return LayerNormFunction.apply(x, weight, bias, eps)
