"""Swin window attention with both projections folded in: the v4
configuration (``SWINDET_WATTN_V4=1``).

Counterpart of ``swindet_tpu/ops/window_attention_v4.py``:

    out = proj(window_attention(x Wqkv^T + bqkv)) + bproj

- :func:`window_attention_v4` runs the forward kernel of
  ``csrc/window_attention_v4.cu`` (replacing the Pallas ``_wattn4_kernel``,
  :74) on a CUDA tensor and the plain version
  :func:`window_attention_v4_reference` (:297, the JAX package's non-TPU
  path) on a CPU tensor;
- :func:`window_attention_v4_bwd` runs the backward kernels (replacing
  ``_wattn4_bwd_kernel``, :141) or :func:`window_attention_v4_bwd_reference`;
- :func:`window_attention_v4_op` is the differentiable entry point
  (``_wattn4_vjp``, :305-337): the forward saves only its inputs and the
  backward recomputes qkv and P.

Weights take the ``nn.Linear`` layout, Wqkv (3C, C) and Wproj (C, C), and
stay fp32 with their biases, as the JAX package passes its fp32
parameters; x, the output and dx are in the compute dtype.

On the card each wrapper picks its kernels before the launch
(:func:`uses_tensor_cores`, :func:`kernel_symbol`). bf16 with N <= 64, hd
in {16, 32, 48, 64} and the shared memory of :func:`tc_fwd_smem` and
:func:`tc_bwd_smem` within a block's (every stage of Swin-T/S/B) runs the
tensor-core kernels (``mma.sync`` on 64-row tiles, counted in
``wrapper.tc_launches`` as well as ``wrapper.launches``; 16-byte aligned x
and g, else ValueError): the weights rounded to bf16 once a call, q, k, v,
P, the attention output, d(attn), dS and dq, dk, dv rounded to bf16 where
they feed a product, sums and the softmax in fp32.
:func:`fwd_geometry` sets how many blocks (a thread-block cluster) share
a forward window, :func:`bwd_geometry` the backward's windows a block and
:func:`dw_split_rows` the weight gradients' split of the rows. Anything
else runs the SIMT kernels, which keep qkv, P and the attention output in
fp32 and round once, at the output. The plain forward rounds qkv and the
attention output to x's dtype as the JAX reference does; the plain
backward computes in fp32, or with ``tc_rounding`` rounds where the
tensor-core kernels do (the check of a bf16 run, with limits from
:func:`window_attention_v4_bwd_limits`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .fused_mlp import ORDER_SPREAD_FACTOR, _bf16_ulp
from .window_attention import (MAX_HEAD_DIM, MAX_TOKENS, attention_probs,
                               window_attention_reference)
from .window_attention_v3 import TC_HEAD_DIMS, TC_ROWS, _sms, bwd_geometry

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the SIMT kernels' last int is the dtype code, the tensor-core forward's
# its cluster; the tensor-core kernels take bf16 scratch for the rounded
# weights (and the backward's ao and dqkv), the backward its windows a
# block and the weight gradients' rows a split
_FWD_ARGTYPES = (_P,) * 8 + (_I,) * 5 + (_F, _I, _P)
_FWD_TC_ARGTYPES = (_P,) * 9 + (_I,) * 5 + (_F, _I, _P)
_BWD_ARGTYPES = (_P,) * 15 + (_I,) * 5 + (_F, _I, _P)
_BWD_TC_ARGTYPES = (_P,) * 16 + (_I,) * 5 + (_F,) + (_I,) * 3 + (_P,)
# dynamic shared memory a block may use on the H100 (227 KB), and the
# floats of the staging tiles that share the logits' region
# (csrc/tile_gemm.cuh: 2 x 16 x 65)
SMEM_LIMIT = 232448
_STAGE_FLOATS = 2 * 16 * 65
# the tensor-core kernels (csrc/window_attention_v4.cu): the forward's and
# the backward heads kernel's products streamed in chunks of TC_KC
# columns, TC_PIPE deep, each staged row TC_KC + 8 bf16 values; the
# forward's cluster of at most TC_MAX_CLUSTER blocks a window should give
# FWD_BLOCKS_PER_SM blocks an SM; the weight gradients' tiles are 64 x 64
# and split their rows for DW_BLOCKS_PER_SM blocks an SM, in runs of a
# multiple of DW_KC rows (a pipeline stage)
TC_KC = 32
TC_PIPE = 2
TC_MAX_CLUSTER = 8
FWD_BLOCKS_PER_SM = 2
DW_TILE = 64
DW_KC = 64
DW_BLOCKS_PER_SM = 2


def _forward_smem_bytes(n: int, c: int, num_heads: int) -> int:
    """Shared memory of the SIMT forward kernel's block: the N x C fp32
    attention output, one head's q, k, v and the logits."""
    hd = c // num_heads
    return 4 * (n * c + 3 * n * (hd + 1) + max(n * (n + 1), _STAGE_FLOATS))


def _tc_pipe_bytes(head_dim: int) -> int:
    """The pipeline: TC_PIPE chunks of a 64-row A and B's 3 hd rows, or
    the forward projection's 64 where those are more."""
    return 2 * TC_PIPE * (TC_ROWS + max(3 * head_dim, 64)) * (TC_KC + 8)


def _add_floats(n: int, head_dim: int) -> int:
    """Floats of a block's table of the head's bias plus the window's
    mask (n x n), at least the backward's four 16-row staging tiles that
    take its room (csrc add_floats), in 16-byte units."""
    return -(-max(n * n, 32 * (head_dim + 8)) // 4) * 4


def tc_fwd_smem(n: int, c: int, head_dim: int, cluster: int = 1) -> int:
    """Shared memory of a tensor-core forward block (csrc tc_fwd_smem) in
    a cluster of ``cluster`` blocks a window: the block's C / cluster
    columns of the 64-row bf16 attention output (row pitch rounded up to
    32, plus 8), the head's q, k, v tiles, its fp32 bias plus mask and the
    pipeline of 64-row A and 3 hd-row B chunks. A block alone (the
    largest) holds all C columns."""
    return 2 * (TC_ROWS * (-(-(c // cluster) // 32) * 32 + 8)
                + 3 * TC_ROWS * (head_dim + 8)) \
        + 4 * _add_floats(n, head_dim) + _tc_pipe_bytes(head_dim)


def tc_bwd_smem(n: int, head_dim: int) -> int:
    """Shared memory of a tensor-core backward heads block (csrc
    tc_bwd_smem): q, k, v and d(attn) tiles, bf16 P and dS, the bias plus
    mask (whose room the four warps' 16-row staging tiles take once P is
    in registers), the pipeline."""
    return 2 * (4 * TC_ROWS * (head_dim + 8) + 2 * TC_ROWS * (TC_ROWS + 8)) \
        + 4 * _add_floats(n, head_dim) + _tc_pipe_bytes(head_dim)


def uses_tensor_cores(dtype: torch.dtype, n: int, c: int,
                      num_heads: int) -> bool:
    """Whether the card runs the tensor-core kernels of rows 12 and 13 for
    x of ``dtype`` and (B_, n, c) windows of ``num_heads`` heads: bf16,
    N <= 64, hd in TC_HEAD_DIMS and both kernels' blocks within
    SMEM_LIMIT."""
    if dtype != torch.bfloat16 or c % num_heads or n > TC_ROWS:
        return False
    hd = c // num_heads
    return hd in TC_HEAD_DIMS and max(tc_fwd_smem(n, c, hd),
                                      tc_bwd_smem(n, hd)) <= SMEM_LIMIT


# C entry points of csrc/window_attention_v4.cu: (SIMT, tensor-core)
_SYMBOLS = {'fwd': ('swindet_window_attention_v4',
                    'swindet_window_attention_v4_tc'),
            'bwd': ('swindet_window_attention_v4_bwd',
                    'swindet_window_attention_v4_bwd_tc')}


def kernel_symbol(kind: str, dtype: torch.dtype, n: int, c: int,
                  num_heads: int) -> str:
    """The entry point that the wrapper of ``kind`` ('fwd' or 'bwd')
    launches for x of ``dtype`` and (B_, n, c) windows of ``num_heads``
    heads."""
    return _SYMBOLS[kind][uses_tensor_cores(dtype, n, c, num_heads)]


def fwd_geometry(windows: int, num_heads: int, sms: int) -> int:
    """Blocks that share a window of the tensor-core forward (a cluster,
    each block a run of nH / cluster heads): the smallest divisor of nH up
    to TC_MAX_CLUSTER whose grid of windows x cluster blocks fills ``sms``
    SMs FWD_BLOCKS_PER_SM times over (fewer blocks a window re-read x and
    the attention output less), else the largest."""
    sizes = [g for g in range(1, min(num_heads, TC_MAX_CLUSTER) + 1)
             if num_heads % g == 0]
    for g in sizes:
        if windows * g >= FWD_BLOCKS_PER_SM * sms:
            return g
    return sizes[-1]


def dw_split_rows(rows: int, m: int, n: int, sms: int) -> int:
    """Rows a split of a tensor-core weight gradient (m, n) += a^T b over
    ``rows`` rows: 64 x 64 output tiles, and at least as many splits as
    give DW_BLOCKS_PER_SM blocks an SM (each split adds its tile with one
    fp32 atomic per entry), in runs of a multiple of DW_KC rows."""
    tiles = -(-m // DW_TILE) * -(-n // DW_TILE)
    splits = max(1, min(-(-rows // TC_ROWS),
                        -(-DW_BLOCKS_PER_SM * sms // tiles)))
    return max(DW_KC, rows // splits // DW_KC * DW_KC)


def window_attention_v4_reference(x: torch.Tensor, wqkv: torch.Tensor,
                                  bqkv: torch.Tensor, bias: torch.Tensor,
                                  mask: Optional[torch.Tensor],
                                  wproj: torch.Tensor, bproj: torch.Tensor,
                                  num_heads: int) -> torch.Tensor:
    """Plain version, the unfused chain in x's dtype: qkv = x Wqkv^T +
    bqkv, :func:`window_attention_reference`, then the projection."""
    d = x.dtype
    qkv = F.linear(x, wqkv.to(d), bqkv.to(d))
    out = window_attention_reference(qkv, bias, mask, num_heads)
    return F.linear(out, wproj.to(d), bproj.to(d))


def _bwd(x, wqkv, bqkv, bias, mask, wproj, g, num_heads, tc_rounding,
         dtype, keep=False):
    """The plain backward in ``dtype`` (fp32, or float64 for the order
    spread), with the tensor-core kernels' bf16 roundings where
    ``tc_rounding``; with ``keep`` also the rows of x and g, the attention
    output, d(attn), v, P and dqkv."""
    b_, n, c = x.shape
    hd = c // num_heads
    scale = hd ** -0.5

    def r(t):
        return t.to(torch.bfloat16).to(dtype) if tc_rounding else t

    xf, gf = x.to(dtype), g.to(dtype)
    qkv = r(F.linear(xf, r(wqkv.to(dtype)), bqkv.to(dtype)))
    p, v = attention_probs(qkv, bias, mask, num_heads, dtype)
    attn = r(r(p) @ v).transpose(1, 2).reshape(b_ * n, c)
    g2 = gf.reshape(b_ * n, c)
    dwproj = g2.t() @ attn
    dbproj = g2.sum(0)
    da = r(g2 @ r(wproj.to(dtype))).view(b_, n, num_heads, hd) \
        .transpose(1, 2)
    q, k = qkv.view(b_, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)[:2]
    q = q * scale
    dv = r(p).transpose(-1, -2) @ da
    dp = da @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (r(ds) @ k) * scale
    dk = r(ds).transpose(-1, -2) @ q
    dqkv = r(torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
             .reshape(b_ * n, 3 * c))
    x2 = xf.reshape(b_ * n, c)
    dwqkv = dqkv.t() @ x2
    dx = (dqkv @ r(wqkv.to(dtype))).view(b_, n, c).to(x.dtype)
    out = (dx, dwqkv, dqkv.sum(0), ds.sum(0), dwproj, dbproj)
    if keep:
        return out, dict(x=x2, g=g2, attn=attn, da=da, v=v, p=p, dqkv=dqkv)
    return out


def window_attention_v4_bwd_reference(x: torch.Tensor, wqkv: torch.Tensor,
                                      bqkv: torch.Tensor, bias: torch.Tensor,
                                      mask: Optional[torch.Tensor],
                                      wproj: torch.Tensor, g: torch.Tensor,
                                      num_heads: int,
                                      tc_rounding: bool = False):
    """Plain version of the backward (``_wattn4_bwd_kernel``), written out
    in fp32 from x and the output gradient g as the kernels compute it:
    qkv and P recomputed, dx rounded to x's dtype. Returns dx (B_, N, C)
    and, fp32, dWqkv (3C, C), dbqkv (3C,), dBias (nH, N, N) summed over
    the windows, dWproj (C, C), dbproj (C,).

    ``tc_rounding`` rounds to bf16 exactly the operands that the
    tensor-core kernels feed their products: Wqkv and Wproj; q, k and v
    (after the bias); P for P v and P^T d(attn); the attention output
    (for dWproj); d(attn) = g Wproj; dS for dQ and dK; and dq, dk, dv
    (for dx, dWqkv and the sum dbqkv). The logits, the softmax, dP, the
    dS that dBias sums and every sum stay fp32. Off (the default), nothing
    is rounded but dx: the fp32 computation of the SIMT kernels."""
    return _bwd(x, wqkv, bqkv, bias, mask, wproj, g, num_heads, tc_rounding,
                torch.float32)


def window_attention_v4_bwd_reference_f64(x: torch.Tensor,
                                          wqkv: torch.Tensor,
                                          bqkv: torch.Tensor,
                                          bias: torch.Tensor,
                                          mask: Optional[torch.Tensor],
                                          wproj: torch.Tensor,
                                          g: torch.Tensor, num_heads: int):
    """:func:`window_attention_v4_bwd_reference` with ``tc_rounding``,
    every operation in float64 and each output rounded once to fp32: the
    rounding plain version under another summation order. Returns dWqkv,
    dbqkv, dBias, dWproj, dbproj."""
    out = _bwd(x, wqkv, bqkv, bias, mask, wproj, g, num_heads, True,
               torch.float64)
    return [t.float() for t in out[1:]]


def window_attention_v4_bwd_limits(x: torch.Tensor, wqkv: torch.Tensor,
                                   bqkv: torch.Tensor, bias: torch.Tensor,
                                   mask: Optional[torch.Tensor],
                                   wproj: torch.Tensor, g: torch.Tensor,
                                   num_heads: int, want,
                                   floor: float = 1e-4):
    """Limits on max |kernel - plain| of dWqkv, dbqkv, dBias, dWproj and
    dbproj of a bf16 run, given ``want``, the rounding plain version's
    outputs (``tc_rounding=True``) on the same inputs. Each is the largest
    of ``floor`` times the output's largest entry, ORDER_SPREAD_FACTOR
    (ops/fused_mlp.py) times its spread, max |want - the same computation
    in float64 with the same bf16 roundings, rounded once to fp32|, and
    the largest change one rounding flip of an operand can make in an
    entry: one bf16 step of dqkv times the largest |x| in its row (dWqkv),
    of dqkv (dbqkv), of the attention output times the largest |g| in its
    row (dWproj), of d(attn) times twice its row's largest P and the
    head's largest |v| in the window, which bounds its change of dS
    (dBias); none for dbproj, a sum of g."""
    other, kept = _bwd(x, wqkv, bqkv, bias, mask, wproj, g, num_heads, True,
                       torch.float64, keep=True)
    ulp = {k: _bf16_ulp(kept[k].float()) for k in ('dqkv', 'attn', 'da')}
    x2, g2, v = kept['x'].float(), kept['g'].float(), kept['v'].float()
    flip = ((x2.abs().amax(1) * ulp['dqkv'].amax(1)).max().item(),
            ulp['dqkv'].max().item(),
            (2 * ulp['da'].amax(-1) * kept['p'].float().amax(-1)
             * v.abs().amax((-1, -2))[..., None]).max().item(),
            (g2.abs().amax(1) * ulp['attn'].amax(1)).max().item(), 0.0)
    return [max(floor * w.abs().max().item(),
                ORDER_SPREAD_FACTOR * (o.float() - w).abs().max().item(), f)
            for w, o, f in zip(want[1:], other[1:], flip)]


def _check(name, x, wqkv, bqkv, bias, mask, wproj, num_heads, last):
    """Shapes of a kernel call: (B_, N, C, hd, dtype code, whether the
    tensor-core kernels run); raises on what the kernels do not take.
    ``last``: (name, tensor, dtype, shape) of the final argument, bproj or
    g."""
    code = build.dtype_code(x, name)
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f'{name}: x must be a contiguous (B_, N, C) tensor')
    b_, n, c = x.shape
    if c % num_heads:
        raise ValueError(f'{name}: C={c} does not split into {num_heads} '
                         f'heads')
    hd = c // num_heads
    if n > MAX_TOKENS or hd > MAX_HEAD_DIM:
        raise ValueError(f'{name}: N={n}, head dim {hd} over the kernel '
                         f'limits {MAX_TOKENS}, {MAX_HEAD_DIM}')
    tc = uses_tensor_cores(x.dtype, n, c, num_heads)
    smem = _forward_smem_bytes(n, c, num_heads)
    if not tc and smem > SMEM_LIMIT:
        raise ValueError(f'{name}: N={n}, C={c}, head dim {hd} need {smem} '
                         f'bytes of shared memory, over a block\'s '
                         f'{SMEM_LIMIT}')
    f32 = torch.float32
    tables = [('wqkv', wqkv, f32, (3 * c, c)), ('bqkv', bqkv, f32, (3 * c,)),
              ('bias', bias, f32, (num_heads, n, n)),
              ('wproj', wproj, f32, (c, c)), last]
    if mask is not None:
        tables.append(('mask', mask, f32, (mask.shape[0], n, n)))
        if mask.shape[0] == 0 or b_ % mask.shape[0]:
            raise ValueError(f'{name}: {mask.shape[0]} mask windows do not '
                             f'divide B_={b_}')
    for tname, t, dtype, shape in tables:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f'{name}: {tname} must be a contiguous {dtype} '
                             f'{shape} tensor on {x.device}')
    if tc:
        build.check_aligned(name, x, *([last[1]] if last[0] == 'g' else []))
    return b_, n, c, hd, code, tc


def window_attention_v4(x: torch.Tensor, wqkv: torch.Tensor,
                        bqkv: torch.Tensor, bias: torch.Tensor,
                        mask: Optional[torch.Tensor], wproj: torch.Tensor,
                        bproj: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The fused forward: x (B_, N, C); Wqkv (3C, C), bqkv (3C,), bias
    (nH, N, N), Wproj (C, C), bproj (C,) fp32; mask (nW, N, N) fp32 or
    None with nW dividing B_. Returns (B_, N, C) in x's dtype."""
    if x.device.type == 'cpu':
        return window_attention_v4_reference(x, wqkv, bqkv, bias, mask,
                                             wproj, bproj, num_heads)
    if x.device.type != 'cuda':
        raise ValueError(f'window_attention_v4: unsupported device '
                         f'{x.device}')
    b_, n, c, hd, code, tc = _check(
        'window_attention_v4', x, wqkv, bqkv, bias, mask, wproj, num_heads,
        ('bproj', bproj, torch.float32, (x.shape[-1],)))
    out = torch.empty_like(x)
    nw = 1 if mask is None else mask.shape[0]
    args = [x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), wproj.data_ptr(),
            bproj.data_ptr(), out.data_ptr()]
    if tc:
        # the bf16 Wqkv and Wproj, rounded anew every call
        w16 = torch.empty(4 * c * c, dtype=torch.bfloat16, device=x.device)
        args += [w16.data_ptr(), b_, n, c, num_heads, nw, hd ** -0.5,
                 fwd_geometry(b_, num_heads, _sms(x.device))]
    else:
        args += [b_, n, c, num_heads, nw, hd ** -0.5, code]
    fn = build.bind('window_attention_v4',
                    kernel_symbol('fwd', x.dtype, n, c, num_heads),
                    _FWD_TC_ARGTYPES if tc else _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(*args, build.stream_ptr(x.device))
    build.check_launch('window_attention_v4', status)
    window_attention_v4.launches += 1
    window_attention_v4.tc_launches += tc
    return out


window_attention_v4.launches = 0
window_attention_v4.tc_launches = 0


def window_attention_v4_bwd(x: torch.Tensor, wqkv: torch.Tensor,
                            bqkv: torch.Tensor, bias: torch.Tensor,
                            mask: Optional[torch.Tensor], wproj: torch.Tensor,
                            g: torch.Tensor, num_heads: int):
    """dx, dWqkv, dbqkv, dBias, dWproj, dbproj of :func:`window_attention_v4`
    for the output gradient g (B_, N, C) in x's dtype; dx in x's dtype,
    the rest fp32."""
    if x.device.type == 'cpu':
        return window_attention_v4_bwd_reference(x, wqkv, bqkv, bias, mask,
                                                 wproj, g, num_heads)
    if x.device.type != 'cuda':
        raise ValueError(f'window_attention_v4_bwd: unsupported device '
                         f'{x.device}')
    b_, n, c, hd, code, tc = _check(
        'window_attention_v4_bwd', x, wqkv, bqkv, bias, mask, wproj,
        num_heads, ('g', g, x.dtype, tuple(x.shape)))
    dev, f32 = x.device, torch.float32
    # scratch: the attention output and dqkv, fp32 for the SIMT kernels,
    # bf16 (they only feed products) for the tensor-core ones
    scratch = x.dtype if tc else f32
    attn = torch.empty((b_, n, c), dtype=scratch, device=dev)
    dqkv = torch.empty((b_, n, 3 * c), dtype=scratch, device=dev)
    dx = torch.empty_like(x)
    dwqkv = torch.zeros((3 * c, c), dtype=f32, device=dev)
    dbqkv = torch.zeros((3 * c,), dtype=f32, device=dev)
    dbias = torch.zeros((num_heads, n, n), dtype=f32, device=dev)
    dwproj = torch.zeros((c, c), dtype=f32, device=dev)
    dbproj = torch.zeros((c,), dtype=f32, device=dev)
    nw = 1 if mask is None else mask.shape[0]
    args = [x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), wproj.data_ptr(),
            g.data_ptr(), attn.data_ptr(), dqkv.data_ptr()]
    tail = [dx.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(),
            dbias.data_ptr(), dwproj.data_ptr(), dbproj.data_ptr(), b_, n, c,
            num_heads, nw, hd ** -0.5]
    if tc:
        # Wqkv, its transpose and Wproj's transpose in bf16, rounded anew
        # every call
        w16 = torch.empty(7 * c * c, dtype=torch.bfloat16, device=dev)
        sms, rows = _sms(dev), b_ * n
        args += [w16.data_ptr(), *tail, bwd_geometry(b_, num_heads, sms),
                 dw_split_rows(rows, 3 * c, c, sms),
                 dw_split_rows(rows, c, c, sms)]
    else:
        args += [*tail, code]
    fn = build.bind('window_attention_v4',
                    kernel_symbol('bwd', x.dtype, n, c, num_heads),
                    _BWD_TC_ARGTYPES if tc else _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(*args, build.stream_ptr(dev))
    build.check_launch('window_attention_v4_bwd', status)
    window_attention_v4_bwd.launches += 1
    window_attention_v4_bwd.tc_launches += tc
    return dx, dwqkv, dbqkv, dbias, dwproj, dbproj


window_attention_v4_bwd.launches = 0
window_attention_v4_bwd.tc_launches = 0


class WindowAttentionV4Function(torch.autograd.Function):
    """``_wattn4_vjp``: the forward saves only its inputs; the backward
    kernels recompute qkv and P. The shift mask is a constant of the block
    geometry and gets no gradient (:325-328)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, bias, mask, wproj, bproj, num_heads):
        ctx.save_for_backward(x, wqkv, bqkv, bias, mask, wproj)
        ctx.num_heads = num_heads
        return window_attention_v4(x, wqkv, bqkv, bias, mask, wproj, bproj,
                                   num_heads)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, bias, mask, wproj = ctx.saved_tensors
        dx, dwqkv, dbqkv, dbias, dwproj, dbproj = window_attention_v4_bwd(
            x, wqkv, bqkv, bias, mask, wproj, g.to(x.dtype).contiguous(),
            ctx.num_heads)
        return dx, dwqkv, dbqkv, dbias, None, dwproj, dbproj, None


def window_attention_v4_op(x: torch.Tensor, wqkv: torch.Tensor,
                           bqkv: Optional[torch.Tensor], bias: torch.Tensor,
                           mask: Optional[torch.Tensor], wproj: torch.Tensor,
                           bproj: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Differentiable :func:`window_attention_v4`; a missing qkv bias is
    zeros (``swin.py:250-251``)."""
    if bqkv is None:
        bqkv = torch.zeros(wqkv.shape[0], dtype=torch.float32,
                           device=wqkv.device)
    return WindowAttentionV4Function.apply(x, wqkv, bqkv, bias, mask, wproj,
                                           bproj, num_heads)
