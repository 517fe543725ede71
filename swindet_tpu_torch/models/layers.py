"""Shared building blocks (counterpart of ``swindet_tpu/models/layers.py``).

Activations are NHWC between modules, as in the JAX package. Parameters
stay fp32 and each layer computes in its ``dtype`` (bf16 on the card), as
the JAX package's compute-dtype policy does; statistics of norms and
softmaxes stay fp32. Initialisers reproduce the JAX package's schemes
with a ``torch.Generator``.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3_op, hwio
from ..ops.fused_mlp import fused_mlp_op

# the JAX package's width guard of the fused MLP (layers.py:103-107)
FUSED_MLP_MAX_BYTES = 12 * 2 ** 20
# flax's lecun_normal truncates at 2 std and rescales by this factor
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """Normal(0, std) truncated at 2 std (timm trunc_normal_ / jax
    truncated_normal(-2, 2) * std)."""
    with torch.no_grad():
        v = torch.empty(t.shape, dtype=torch.float32)
        nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.copy_(v * std)
    return t


def normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)
    return t


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax ``lecun_normal``: truncated normal of variance 1 / fan_in."""
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, gen)


def he_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax ``he_normal``: truncated normal of variance 2 / fan_in."""
    return trunc_normal_(t, math.sqrt(2.0 / fan_in) / _TRUNC_STD, gen)


def uniform_(t: torch.Tensor, a: float, gen: torch.Generator):
    """Uniform(-a, a)."""
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * a) - a)
    return t


def xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    gen: torch.Generator):
    return uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), gen)


def resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {'float32': torch.float32, 'bfloat16': torch.bfloat16,
            'float16': torch.float16}[str(dtype)]


class Linear(nn.Linear):
    """nn.Linear computing in ``dtype`` with fp32 parameters."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = resolve_dtype(dtype)

    def forward(self, x):
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d),
                        None if self.bias is None else self.bias.to(d))

    def init_trunc_normal(self, gen, std=0.02):
        trunc_normal_(self.weight, std, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class DropPath(nn.Module):
    """Per-sample stochastic depth (``swindet_tpu/models/layers.py:48``):
    in training each sample's branch is kept with probability 1 - p and
    scaled by 1 / (1 - p), by a Bernoulli draw from ``gen``, a
    ``torch.Generator`` on the data's device; the identity in eval mode."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x, gen: Optional[torch.Generator] = None):
        if self.drop_prob == 0.0 or not self.training:
            return x
        if gen is None:
            raise ValueError('DropPath: training needs a torch.Generator')
        keep = 1.0 - self.drop_prob
        u = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=gen,
                       device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """fc1 -> exact-erf GELU -> fc2 (reference swin_transformer.py:20).

    ``fused`` runs the three as one op whose hidden never leaves the chip
    (``ops/fused_mlp.py``), as ``swindet_tpu/models/layers.py:98-112``
    does; None reads the JAX package's switch, ``SWINDET_FUSED_MLP=1``,
    once here. The JAX package's width guard holds either way, so both
    packages fuse the same layers: a layer whose fp32 weight gradients
    (2 C H 4 bytes) exceed 12 MiB (Swin-T's stage 4) stays unfused."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dtype=torch.float32,
                 fused: Optional[bool] = None):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype)
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype)
        if fused is None:
            fused = os.environ.get('SWINDET_FUSED_MLP') == '1'
        self.fused = fused and \
            2 * in_features * hidden_features * 4 <= FUSED_MLP_MAX_BYTES

    def forward(self, x):
        if not self.fused:
            return self.fc2(F.gelu(self.fc1(x), approximate='none'))
        d = self.fc1.compute_dtype
        out = fused_mlp_op(x.to(d).reshape(-1, x.shape[-1]).contiguous(),
                           self.fc1.weight.to(d), self.fc1.bias.float(),
                           self.fc2.weight.to(d), self.fc2.bias.float())
        return out.reshape(*x.shape[:-1], out.shape[-1])

    def init_weights(self, gen):
        self.fc1.init_trunc_normal(gen)
        self.fc2.init_trunc_normal(gen)


def _moments(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance over ``dims`` (kept) as flax's norms take them:
    E[x^2] - E[x]^2, the biased variance, clamped at 0."""
    mean = x.mean(dims, keepdim=True)
    var = ((x * x).mean(dims, keepdim=True) - mean * mean).clamp(min=0.0)
    return mean, var


class Norm(nn.Module):
    """A channels-last norm computing in fp32 (counterpart of
    ``_NormWrapper``, ``swindet_tpu/models/layers.py:173``): ``kind`` 'bn'
    (BN, BN2d and SyncBN, which is plain BN on one card), 'gn' or 'ln',
    with mmcv's parameter and buffer names (``weight``, ``bias``, and for
    BN ``running_mean``, ``running_var``, ``num_batches_tracked``).

    BN in training mode normalises with the batch's statistics over every
    axis but the channels and updates the running ones with ``momentum``
    from the biased variance, as flax's ``nn.BatchNorm`` does (torch's
    ``BatchNorm2d`` takes the unbiased one); in eval mode it reads the
    running statistics."""

    def __init__(self, kind: str, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, num_groups: int = 32,
                 requires_grad: bool = True):
        super().__init__()
        if kind not in ('bn', 'gn', 'ln'):
            raise KeyError(f'Norm: unknown kind {kind}')
        if kind == 'gn' and num_features % num_groups:
            raise ValueError(f'Norm: {num_features} channels in '
                             f'{num_groups} groups')
        self.kind = kind
        self.eps = eps
        self.momentum = momentum
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_features),
                                   requires_grad=requires_grad)
        self.bias = nn.Parameter(torch.zeros(num_features),
                                 requires_grad=requires_grad)
        if kind == 'bn':
            self.register_buffer('running_mean', torch.zeros(num_features))
            self.register_buffer('running_var', torch.ones(num_features))
            self.register_buffer('num_batches_tracked',
                                 torch.tensor(0, dtype=torch.long))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            if self.kind == 'bn':
                self.running_mean.zero_()
                self.running_var.fill_(1.0)
                self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., C) in any dtype -> fp32."""
        x = x.float()
        if self.kind == 'gn':
            g = x.reshape(*x.shape[:-1], self.num_groups, -1)
            dims = tuple(range(1, x.ndim - 1)) + (x.ndim,)
            mean, var = _moments(g, dims)
            y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
            return y * self.weight + self.bias
        if self.kind == 'ln':
            mean, var = _moments(x, (-1,))
        elif self.training:
            mean, var = _moments(x, tuple(range(x.ndim - 1)))
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(m * mean.flatten())
                self.running_var.mul_(1.0 - m).add_(m * var.flatten())
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def build_norm(norm_cfg: dict, num_features: int) -> Tuple[str, Norm]:
    """(name, module) of a norm config, as mmcv's ``build_norm_layer``
    names them: 'bn' for BN, BN2d and SyncBN, 'gn' for GN, 'ln' for LN
    (``swindet_tpu/models/layers.py:147``)."""
    t = norm_cfg['type']
    eps = norm_cfg.get('eps', 1e-5)
    if t in ('BN', 'BN2d', 'SyncBN'):
        return 'bn', Norm('bn', num_features, eps=eps,
                          momentum=norm_cfg.get('momentum', 0.1),
                          requires_grad=norm_cfg.get('requires_grad', True))
    if t == 'GN':
        return 'gn', Norm('gn', num_features, eps=eps,
                          num_groups=norm_cfg.get('num_groups', 32))
    if t == 'LN':
        return 'ln', Norm('ln', num_features, eps=eps)
    raise KeyError(f'Unknown norm type {t}')


class ConvModule(nn.Module):
    """conv (+ norm) (+ ReLU) over NHWC with an mmcv ``ConvModule``
    state_dict (``conv.weight`` OIHW, ``conv.bias``, the norm under its
    mmcv name, ``bn`` or ``gn``). A normed conv has no bias (mmcv's
    bias='auto'). The order is conv -> norm (fp32) -> cast to ``dtype`` ->
    ReLU, as swindet_tpu/models/layers.py:336-348.

    A 3x3 / stride 1 / padding 1 conv with bias, no norm and no or ReLU
    activation, whose channel counts are multiples of 128, goes through
    the conv3x3 kernel, as swindet_tpu/models/layers.py:295-310 sends it
    to the Pallas kernel; every other conv, a normed one included, is a
    plain ``F.conv2d``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None, dtype=torch.float32):
        super().__init__()
        act = (act_cfg or {}).get('type')
        if act not in (None, 'ReLU'):
            raise NotImplementedError(f'ConvModule: activation {act}')
        use_bias = norm_cfg is None
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding, bias=use_bias)
        self.norm_name = None
        if norm_cfg is not None:
            self.norm_name, norm = build_norm(norm_cfg, out_channels)
            self.add_module(self.norm_name, norm)
        self.relu = act == 'ReLU'
        self.compute_dtype = resolve_dtype(dtype)
        self.use_kernel = (kernel_size == 3 and stride == 1 and padding == 1
                           and norm_cfg is None and use_bias
                           and in_channels % 128 == 0
                           and out_channels % 128 == 0)

    def forward(self, x):
        """x: (B, H, W, C) -> (B, H', W', Co) in ``dtype``."""
        d = self.compute_dtype
        if self.norm_name is None:
            return conv_nhwc(x, self.conv, self.relu, d, self.use_kernel)
        x = getattr(self, self.norm_name)(conv_nhwc(x, self.conv, False, d,
                                                    False)).to(d)
        return torch.relu(x) if self.relu else x

    def init_weights(self, gen, std: Optional[float] = None):
        init_conv(self.conv, gen, std)
        if self.norm_name is not None:
            getattr(self, self.norm_name).reset_parameters()


def init_conv(conv: nn.Conv2d, gen: torch.Generator,
              std: Optional[float] = None):
    """flax nn.Conv defaults (lecun_normal kernel, zero bias), or
    Normal(0, std) where the JAX package sets ``normal_init(std)``."""
    fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
    if std is None:
        lecun_normal_(conv.weight, fan_in, gen)
    else:
        normal_(conv.weight, std, gen)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, relu: bool,
              dtype: torch.dtype, use_kernel: bool) -> torch.Tensor:
    """Apply ``conv`` (OIHW weights) to an NHWC tensor in ``dtype``."""
    x = x.to(dtype)
    if use_kernel:
        return conv3x3_op(x.contiguous(), hwio(conv.weight.to(dtype)),
                          conv.bias.float(), relu)
    w = conv.weight
    b = None if conv.bias is None else conv.bias.to(dtype)
    if w.shape[2:] == (1, 1) and conv.stride == (1, 1):
        out = F.linear(x, w[:, :, 0, 0].to(dtype), b)
    else:
        out = F.conv2d(x.permute(0, 3, 1, 2), w.to(dtype), b,
                       stride=conv.stride,
                       padding=conv.padding).permute(0, 2, 3, 1)
    return torch.relu(out) if relu else out


def resize_nearest(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC to (H, W), torch F.interpolate('nearest')
    index arithmetic (floor of the source index)."""
    b, h, w, c = x.shape
    nh, nw = shape
    if nh % h == 0 and nw % w == 0:
        fy, fx = nh // h, nw // w
        return x[:, :, None, :, None, :].expand(b, h, fy, w, fx, c) \
            .reshape(b, nh, nw, c)
    rows = (torch.arange(nh, device=x.device) * (h / nh)).long()
    cols = (torch.arange(nw, device=x.device) * (w / nw)).long()
    return x[:, rows][:, :, cols]


def max_pool_1x1_s2(x: torch.Tensor) -> torch.Tensor:
    """F.max_pool2d(x, 1, stride=2) on NHWC: a plain subsample."""
    return x[:, ::2, ::2, :]
