"""Smoke run of the PyTorch / CUDA port (swindet_tpu_torch) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
before the last line:

1. device  -- requires CUDA; prints the card's name and power limit as
              nvidia-smi reports them, torch's CUDA and the nvcc version.
2. build   -- builds every kernel from swindet_tpu_torch/csrc with nvcc;
              the conv and fused-MLP libraries' SASS must hold
              tensor-core (HGMMA) and TMA (UTMALDG) instructions, the
              v3 and v4 window attentions' HMMA, and so must each of the
              four instances of the tensor-core forward over head-major
              q, k, v (row 14) and over the qkv map (row 15); their bf16
              kernels' and the LayerNorm
              kernels' registers, shared and local memory are printed,
              each instance by its template arguments (the attention
              forward's with the P store on and off and its staging
              policy, the LayerNorm's dtype and chunks a lane).
3. kernels -- holds each of the fifteen kernels against its plain
              PyTorch version on the card at the shapes of the main paths,
              in bf16 and fp32 (NMS: fp32 boxes, exact equality), times
              both with CUDA events, times the one PyTorch call that
              computes the same function where there is one (library_ms;
              for the fused MLP and the v4 attention the unfused chain --
              F.linear -> F.gelu -> F.linear, F.linear -> SDPA -> F.linear
              -- and its autograd backward as unfused_ms), and computes
              each kernel's bound from the bytes and operations of its
              inputs. LayerNorm runs at the seven shapes of a request's
              32 norms, each with its kernel's profiler device ms, and
              its first kernel (a warp a row, for other widths and bases
              off 16 bytes) at the first of them, on a copy of x one
              element past a 16-byte boundary, which the profiler must
              show ran that kernel alone. The
              v1 and full-map attention kernels, which no model path
              runs (as in the JAX package), run only here, each in bf16
              on its tensor-core kernel and in fp32 on its SIMT one (a
              launch of the other fails the run): the v1 one at stage 1,
              its kernel's device ms read apart from its wrapper's
              head-major copy; the full-map one on the padded map of one
              image at every Swin stage with shift 3 and at stage 1 with
              no shift, with its kernel's device ms, the unfused chain
              (roll, partition, SDPA, reverse) and the port's blockwise
              path (gather, row 2, inverse gather) beside it.
              The 3x3 conv and its filter gradient run in bf16 (their
              tensor-core kernels) at every conv shape of the main path
              and in fp32 (their SIMT kernels) at two: FPN P2 and the
              mask head. The window attention's three kernels run in
              bf16 (tensor cores) at every Swin stage's shape, the
              inference forward at a request's windows, the training
              forward and the backward at a training batch's, and in
              fp32 (SIMT) at stages 1 and 4. NMS runs at its three
              shapes with the device time of its mask and scan kernels
              apart (torch.profiler) and the number of 64-box blocks the
              scan visited. The v4 attention (rows 12 and 13) runs in
              bf16 (its tensor-core kernels) at every Swin stage's shape,
              the forward at a request's windows and the backward at a
              training batch's, and in fp32 (SIMT) at stages 1 and 4; its
              bf16 backward is held to the plain version with the
              kernels' bf16 roundings, dx at TOL_SUM and the fp32
              gradients at limits derived on the check's inputs, which a
              control with a 64-row tile of g zeroed must exceed, and
              each output's distance to the fp32 plain version is logged
              beside the bf16 unfused chain's. The fused MLP runs in
              bf16 (its tensor-core kernels) at the forward's serving
              rows of stages 1-3 and training rows of stage 1 and the
              backward's training rows of stages 1-3, and in fp32
              (SIMT) at stages 1 and 3; its
              bf16 weight gradients are held to a limit derived from the
              plain version's summation-order spread, which a control
              with a 64-row tile of g zeroed must exceed. RoIAlign runs
              at serving's and training's bbox and mask shapes, its
              backward at training's, each with its bound; both then at
              7x7 and 14x14 on 256 rois piled on one 20x20-cell area of
              P2 and on edge-case rois (slivers, one past every border,
              reversed, degenerate, invalid); the backward must repeat
              bit for bit.
4. main    -- serving: Mask R-CNN Swin-T (full width, seeded weights,
              bf16, RPN nms_pre = max_per_img = 1000) through
              init_detector and inference_detector on 3 synthetic
              800x1333 images after one warm-up; every inference kernel's
              launch count must rise (NMS twice a request: RPN and
              multiclass) and no training kernel may launch; every conv,
              v3 attention (and fused-MLP) launch must be a tensor-core
              one (``tc_launches``).
5. check   -- the same detector at fp32 on a small canvas, on the card
              (kernels) and on the CPU (plain versions), must agree; its
              convs, attentions (and fused MLPs) run the SIMT kernels,
              no tensor-core one.
6. train   -- training: the same detector in bf16 with the config's
              train_cfg, drop_path_rate 0.1, AdamW with the Swin
              paramwise_cfg and the schedule_1x warm-up, through
              make_train_step on a batch of 2 synthetic 800x1333 images
              (canvas 800x1344) whose painted rectangles are the ground
              truth: 1 warm-up step, 5 timed steps, one step whose NMS
              runs under torch.cuda.set_sync_debug_mode('error') (it
              reads nothing on the host), one validation pass
              (simple_test) of the trained model on the batch, then 2
              profiled steps. Over the timed steps every kernel of the
              configuration but the inference attention kernel must
              launch (NMS once a step), and that one must not, and every
              conv, filter-gradient, attention training-forward and
              attention-backward launch must be a tensor-core one;
              the validation pass, counted on its own, must launch the
              inference kernels and no training kernel.
7. train-check -- forward_train and its gradients in fp32 on a 224x320
              canvas, on the card and on the CPU, with the same weights,
              batch and sampler keys, must agree (the fp32 run launches
              no tensor-core kernel); a bf16 control run on the card is
              held to the same CPU run and logged.
8. fused   -- phases 4 to 7 again in the fused-MLP configuration, the JAX
              package's switch SWINDET_FUSED_MLP=1: the token MLPs of
              stages 1-3 (10 blocks) run the fused kernels, stage 4 stays
              unfused. Serving launches the fused forward 10 times a
              request; training the forward and the backward 10 times a
              step, every bf16 launch a tensor-core one, every fp32 one
              SIMT. The card-vs-CPU checks hold the same limits.
9. wattn-v4 -- phases 4 to 7 again in the v4 window-attention
              configuration, the JAX package's switch SWINDET_WATTN_V4=1:
              every Swin block's qkv projection, attention and output
              projection run as one kernel. Serving launches the v4
              forward 12 times a request, training the forward and the
              backward 12 times a step, every bf16 launch a tensor-core
              one, every fp32 one SIMT, and none of the v3 attention
              kernels runs. The card-vs-CPU checks hold the same limits.

Then one JSON line of per-kernel results (``launches``: the serving
and the training runs' counts of the three configurations, each from its
own reset, summed; each also apart; for the conv, fused-MLP and v1, v3,
v4 and full-map attention rows also ``tc_launches``, counted the same
way; ``shapes``, the bf16 readings at every main-path shape, for those,
LayerNorm, RoIAlign and its backward and NMS; ``device_ms`` for
LayerNorm and the v1 and full-map attentions, for the v1 one
``copy_device_ms``, for the full-map one ``unfused_ms``,
``unfused_device_ms``, ``blockwise_ms`` and ``blockwise_device_ms``, and
for LayerNorm ``first_kernel``, its first kernel's reading), the card's
name and power limit,
and, last, one JSON line with the device. It imports neither jax nor the
JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from swindet_tpu_torch import inference_detector, init_detector
from swindet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                      make_train_step)
from swindet_tpu_torch.ops import (FUSED_MLP_KERNELS, INFERENCE_KERNELS,
                                   KERNEL_WRAPPERS, OP_ONLY_KERNELS,
                                   TENSOR_CORE_KERNELS, TRAINING_KERNELS,
                                   WATTN_V4_KERNELS, build,
                                   conv3x3, conv3x3_dw, conv3x3_dw_reference,
                                   conv3x3_reference, fused_mlp,
                                   fused_mlp_bwd, fused_mlp_bwd_limits,
                                   fused_mlp_bwd_reference,
                                   fused_mlp_reference, launch_counts,
                                   layer_norm, layer_norm_reference,
                                   multilevel_roi_align,
                                   multilevel_roi_align_backward,
                                   nms_sorted, nms_sorted_reference,
                                   reset_launch_counts, roi_align,
                                   tc_launch_counts,
                                   roi_align_bwd, swin_attention_reference,
                                   swin_window_attention, window_attention,
                                   window_attention_bwd,
                                   window_attention_bwd_reference,
                                   window_attention_fwd_p,
                                   window_attention_fwd_p_reference,
                                   window_attention_reference,
                                   window_attention_v3, window_attention_v4,
                                   window_attention_v4_bwd,
                                   window_attention_v4_bwd_limits,
                                   window_attention_v4_bwd_reference,
                                   window_attention_v4_reference)
from swindet_tpu_torch.ops.roi_align import _flat_layout, _taps, map_roi_levels
from swindet_tpu_torch.models.backbones.swin import (WindowAttention,
                                                     shifted_window_attn_mask,
                                                     window_gather_indices)
from swindet_tpu_torch.models.dense_heads import rpn_head as rpn_head_module
from swindet_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(
    REPO, 'configs/swin/'
    'mask_rcnn_swin_tiny_patch4_window7_mstrain_480-800_adamw_1x_coco.py')

KERNELS = {
    'layer_norm': dict(
        source='swindet_tpu_torch/csrc/layer_norm.cu',
        replaces='swindet_tpu/ops/layer_norm.py:22'),
    'window_attention_v3': dict(
        source='swindet_tpu_torch/csrc/window_attention.cu',
        replaces='swindet_tpu/ops/window_attention_v3.py:38'),
    'conv3x3': dict(
        source='swindet_tpu_torch/csrc/conv3x3.cu',
        replaces='swindet_tpu/ops/conv3x3.py:25'),
    'roi_align': dict(
        source='swindet_tpu_torch/csrc/roi_align.cu',
        replaces='swindet_tpu/ops/roi_align_pallas.py:92'),
    'window_attention_fwd_p': dict(
        source='swindet_tpu_torch/csrc/window_attention.cu',
        replaces='swindet_tpu/ops/window_attention_v3.py:209'),
    'window_attention_bwd': dict(
        source='swindet_tpu_torch/csrc/window_attention.cu',
        replaces='swindet_tpu/ops/window_attention_v3.py:119'),
    'conv3x3_dw': dict(
        source='swindet_tpu_torch/csrc/conv3x3.cu',
        replaces='swindet_tpu/ops/conv3x3.py:112'),
    'roi_align_bwd': dict(
        source='swindet_tpu_torch/csrc/roi_align.cu',
        replaces='swindet_tpu/ops/roi_align_pallas.py:411'),
    'nms_sorted': dict(
        source='swindet_tpu_torch/csrc/nms.cu',
        replaces='swindet_tpu/ops/nms_pallas.py:38'),
    'fused_mlp': dict(
        source='swindet_tpu_torch/csrc/fused_mlp.cu',
        replaces='swindet_tpu/ops/fused_mlp.py:78'),
    'fused_mlp_bwd': dict(
        source='swindet_tpu_torch/csrc/fused_mlp.cu',
        replaces='swindet_tpu/ops/fused_mlp.py:115'),
    'window_attention_v4': dict(
        source='swindet_tpu_torch/csrc/window_attention_v4.cu',
        replaces='swindet_tpu/ops/window_attention_v4.py:74'),
    'window_attention_v4_bwd': dict(
        source='swindet_tpu_torch/csrc/window_attention_v4.cu',
        replaces='swindet_tpu/ops/window_attention_v4.py:141'),
    'window_attention': dict(
        source='swindet_tpu_torch/csrc/window_attention.cu',
        replaces='swindet_tpu/ops/window_attention.py:30'),
    'swin_window_attention': dict(
        source='swindet_tpu_torch/csrc/window_attention.cu',
        replaces='swindet_tpu/ops/swin_attention.py:46'),
}
# |kernel - plain| <= ATOL + RTOL * |plain|: fp32 differs by summation
# order only; bf16 outputs are each rounded once from fp32 on both sides,
# so they may differ by about one bf16 unit (2^-8 relative) of the output
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# RoIAlign in fp32: the plain version's elementwise ops and the kernel may
# round a sample coordinate one ulp apart (measured on the H100: up to
# 1.8e-4 on level-0 rois at x ~ 290 cells, where one ulp is 3e-5 cells
# and N(0, 1) feature maps change by up to ~6 per cell)
TOL_ROI_FP32 = (1e-3, 1e-4)
# The backward kernels sum over windows, pixels or rois across blocks, by
# fp32 atomics in an order that changes from run to run (RoIAlign's sums
# its rois in index order instead, and must repeat bit for bit), and their
# entries cancel (a sum of ~1e5 signed products can be near zero while
# each product is not): |kernel - plain| <= TOL_SUM * max|plain| per
# output, a little looser than the forwards' elementwise tolerance. bf16
# outputs add one bf16 rounding (2^-8); RoIAlign's fp32 adds the one-ulp
# sample coordinates above.
TOL_SUM = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_SUM_ROI_FP32 = 1e-3
# The fused MLP forward is held elementwise to TOL: its fp32 sums run in
# another order than the plain version's matmuls, its erf may contract
# into fused multiply-adds (a few fp32 ulps), and in bf16 a rounding of
# the hidden activation may land one bf16 unit apart. Its backward sums
# over rows (the weight gradients by fp32 atomics, in a changing order)
# from terms rounded to bf16 in a bf16 run, so it is held per output to
# TOL_SUM of the largest entry, but for the fp32 weight gradients of a
# bf16 run (dw1, db1, dw2): a and dh are rounded to bf16 from fp32 sums
# whose order decides the rounding, which moves them by more than TOL_SUM
# allows, so each is held to the largest of TOL_SUM[fp32] of its largest
# entry, ORDER_SPREAD_FACTOR (4) times the plain version's own spread
# under another summation order and the change one rounding flip can
# make, on the inputs of the check (_mlp_bwd_limits, with a control that
# must exceed it). NMS must equal its plain version exactly (count,
# indices and detections): its IoU rounds as the plain version's.
# The v4 attention forward is held elementwise to TOL against its plain
# version computed in fp32 on the same inputs and rounded once to the
# compute dtype: the SIMT kernel (fp32) keeps qkv, P and the attention
# output in fp32, the tensor-core kernel (bf16) rounds them to bf16 as
# the JAX package's bf16 chain does (max |d| 0.0078-0.0156 against TOL's
# 2e-2 + 2e-2 |out|). Its fp32 backward is held to TOL_SUM against the
# fp32 plain version. The bf16 backward's tensor-core kernels round
# their operands to bf16 (q, k, v, P, the attention output, d(attn), dS,
# dqkv, the weights), which moves the fp32 weight gradients by 2e-3 to
# 8e-3 of their largest entry, as much as the bf16 autograd of the
# unfused chain: it is held to the plain version with the same roundings
# (tc_rounding), dx at TOL_SUM[bf16] and the fp32 outputs at limits
# derived as the fused MLP's (_v4_bwd_check).
FPN_SHAPES = ((200, 336), (100, 168), (50, 84), (25, 42))
# the Swin stages of an 800x1344 canvas: windows of one image, C, heads
# and the map padded to whole 7x7 windows (the shift mask's (Hp, Wp))
ATTN_STAGES = ((1392, 96, 3, (203, 336)), (360, 192, 6, (105, 168)),
               (96, 384, 12, (56, 84)), (24, 768, 24, (28, 42)))
# the (rows, C) of Swin-T's 32 LayerNorms on an 800x1344 canvas, a request's:
# the patch embedding's and stage 1's (6 norms), the first merge norm,
# stage 2's (5), the second merge norm, stage 3's (13), the third merge
# norm, stage 4's (5)
LN_SHAPES = ((67200, 96), (16800, 384), (16800, 192), (4200, 768),
             (4200, 384), (1050, 1536), (1050, 768))
# H100 SXM data-sheet rates (dense bf16 tensor cores, fp32 outside the
# tensor cores, HBM3)
PEAK_FLOPS = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# operations of one IoU of the NMS kernel: two areas (2 subtractions, 2
# clamps, 1 product each), the intersection (2 min, 2 max, 2
# subtractions, 2 clamps, 1 product), the union (an addition, a
# subtraction, a clamp), a division and a comparison
NMS_OPS_PER_IOU = 24
IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)
# COCO train2017 (118,287 images) at the config's 16 images per batch,
# for the schedule's epoch boundaries
ITERS_PER_EPOCH = 7393


def log(phase: str, msg: str) -> None:
    print(f'[{phase}] {msg}', flush=True)


def cuda_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Mean device time of fn() in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------- phase 1
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; the port is measured '
                         'on a GPU only')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([build.nvcc_path(), '--version'],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    log('device', f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
                  f'{torch.cuda.device_count()} device(s); nvcc: {nvcc}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ------------------------------------------------------------- phase 2
def _demangle(names):
    """C++ names of mangled kernel symbols, by c++filt where the host has
    it (else the mangled names), template arguments kept and the
    parameter list dropped."""
    try:
        out = subprocess.run(['c++filt'], input='\n'.join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    return [re.sub(r'^void |\(.*$', '', n).replace('swindet::', '')
            for n in out]


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = build.build()
    log('build', f'{len(paths)} kernel libraries in '
                 f'{time.perf_counter() - t0:.1f} s: '
                 + ', '.join(p.name for p in paths.values()))
    # the bf16 conv and fused-MLP kernels must be tensor-core (HGMMA)
    # kernels fed by TMA (UTMALDG), the window attentions' (v3 and v4) hold
    # mma.sync (HMMA), every instance of the tensor-core forward over
    # head-major q, k, v (row 14) and over the qkv map (row 15) among them;
    # their registers, shared memory and local memory (spills), and the
    # LayerNorm kernels'
    tool = os.path.join(os.path.dirname(build.nvcc_path()), 'cuobjdump')
    for name, pattern, wanted in (
            ('conv3x3', r'conv3x3\w*_tc_kernel', ('HGMMA', 'UTMALDG')),
            ('fused_mlp', r'mlp\w*_tc_kernel', ('HGMMA', 'UTMALDG')),
            ('window_attention', r'wattn_\w*_tc_kernel', ('HMMA',)),
            ('window_attention_v4', r'wattn4\w*_tc_kernel', ('HMMA',)),
            ('layer_norm', r'layer_norm\w*_kernel', ())):
        lib = str(paths[name])
        if wanted:
            sass = subprocess.run([tool, '-sass', lib], capture_output=True,
                                  text=True, timeout=300, check=True).stdout
            ops = {op: sum(op in line for line in sass.splitlines())
                   for op in wanted}
            log('build', f'{name} SASS: ' + ', '.join(
                f'{v} {op}' for op, v in ops.items()) + ' instructions')
            if not all(ops.values()):
                raise AssertionError(f'{name}: no tensor-core or TMA '
                                     f'instructions in {lib}: {ops}')
        if name == 'window_attention':
            for policy, row in (('HeadMajorTc', 14), ('SwinMapTc', 15)):
                fns = [f for f in sass.split('Function : ')[1:]
                       if policy in f.splitlines()[0]]
                hmma = [f.count('HMMA') for f in fns]
                log('build', f'  the {policy} tensor-core instances (row '
                             f'{row}): {hmma} HMMA instructions')
                if len(hmma) != 4 or not all(hmma):
                    raise AssertionError(f'window_attention: {policy} '
                                         f'tensor-core instances {hmma}')
        usage = subprocess.run([tool, '-res-usage', lib],
                               capture_output=True, text=True, timeout=300,
                               check=True).stdout.splitlines()
        found = [(re.search(r'Function (\S+?):?$', fn.strip())[1],
                  res.strip()) for fn, res in zip(usage, usage[1:])
                 if 'Function' in fn and re.search(pattern, fn)]
        for kernel, (_, res) in zip(_demangle([f for f, _ in found]),
                                    found):
            log('build', f'  {kernel}: {res}')


# ------------------------------------------------------------- phase 3
def _tensors(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes, flops, peak=PEAK_FLOPS):
    """Least time (ms) of the work on the card: its bytes over the memory
    rate or its operations over their peak rate (the bf16 tensor-core rate
    unless given), whichever is larger, and which it was."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _compare(name, dtype, kernel_fn, plain_fn, shape_note, work=None,
             library_fn=None, summed=False, exact=False, limits=None):
    """Hold kernel_fn() against plain_fn() (each a tensor or a tuple of
    them), time both and, if given, library_fn; ``work`` (bytes, flops[,
    peak]) gives the bound. ``summed`` picks the scale-relative TOL_SUM
    check of the backward kernels, ``exact`` equality; ``limits``, one
    entry per output, replaces an output's summed limit by its entry where
    that is not None."""
    got = _tensors(kernel_fn())
    want = _tensors(plain_fn())
    torch.cuda.synchronize()
    max_err = 0.0
    limits = limits or [None] * len(want)
    for g, w, lim in zip(got, want, limits, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f'{name} {dtype}: kernel gives {g.shape} '
                                 f'{g.dtype}, plain {w.shape} {w.dtype}')
        g, w, odt = g.float(), w.float(), g.dtype
        if not torch.isfinite(g).all():
            raise AssertionError(f'{name} {dtype}: non-finite kernel output')
        err = (g - w).abs()
        if exact:
            excess = 0.0 if torch.equal(g, w) else 1.0
            rule = 'equality'
        elif lim is not None:
            excess = err.max().item() - lim
            rule = f'the derived limit {lim:.3g}'
        elif summed:
            tol = TOL_SUM_ROI_FP32 if (
                name, odt) == ('roi_align_bwd', torch.float32) \
                else TOL_SUM[odt]
            limit = tol * w.abs().max().item()
            excess = err.max().item() - limit
            rule = f'{tol} x max|plain| = {limit:.3g}'
        else:
            atol, rtol = TOL_ROI_FP32 if (name, odt) == (
                'roi_align', torch.float32) else TOL[odt]
            excess = (err - (atol + rtol * w.abs())).max().item()
            rule = f'atol {atol} + rtol {rtol}'
        if excess > 0:
            raise AssertionError(f'{name} {dtype} {shape_note}: max |d| = '
                                 f'{err.max().item():.3g} over {rule}')
        max_err = max(max_err, err.max().item())
    ms = cuda_ms(kernel_fn, iters=20)
    plain_ms = cuda_ms(plain_fn)
    r = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, shape=shape_note,
             library_ms=None if library_fn is None else cuda_ms(library_fn,
                                                                 iters=20))
    if work is not None:
        r['bound_ms'], r['bound_by'] = bound(*work)
    log('kernels', f'{name} {str(dtype)[6:]} {shape_note}: max|d| '
                   f'{max_err:.3g}; kernel {ms:.4f} ms, plain '
                   f'{plain_ms:.4f} ms'
                   + ('' if library_fn is None else
                      f', library {r["library_ms"]:.4f} ms')
                   + ('' if work is None else
                      f', bound {r["bound_ms"]:.4f} ms ({r["bound_by"]})'))
    return r


def _rois(gen, n, img_h=800, img_w=1344, batch=1):
    """Proposal-like rois over an 800x1344 canvas: log-uniform sizes of
    8-800 px, aspect ratios 1/3-3, clipped to the image, spread over
    ``batch`` images."""
    u = torch.rand(n, 5, generator=gen)
    size = 8.0 * 100.0 ** u[:, 0]
    aspect = 3.0 ** (2 * u[:, 1] - 1)
    w, h = size * aspect.sqrt(), size / aspect.sqrt()
    cx, cy = u[:, 2] * img_w, u[:, 3] * img_h
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    boxes[:, 0::2] = boxes[:, 0::2].clamp(0, img_w)
    boxes[:, 1::2] = boxes[:, 1::2].clamp(0, img_h)
    b = (u[:, 4] * batch).floor().clamp(max=batch - 1)
    return torch.cat([b[:, None], boxes], 1).cuda().contiguous()


def _attn_flops(b_, n, c, matmuls):
    """``matmuls`` N x N x hd products per (window, head), 2 flops each."""
    return 2.0 * matmuls * b_ * n * n * c


def _roi_work(shapes, rois, strides, out_size):
    """What the RoIAlign of ``rois`` needs on these inputs: the distinct
    feature rows (of C values) that the bilinear taps of its samples read,
    and the number of samples, both over the samples that lie inside the
    map and belong to the adaptive grid of their bin. ``shapes``: (H, W)
    per level."""
    offsets, total = _flat_layout(shapes)
    lvl = map_roi_levels(rois, len(shapes))
    rows, samples = [], 0
    for s in range(0, rois.shape[0], 64):
        idx, _, valid, wgt = _taps(rois[s:s + 64], lvl[s:s + 64], shapes,
                                   offsets, strides, total, out_size, 0)
        r = wgt.shape[2]
        used = valid & (wgt.expand(-1, out_size, r, out_size, r)
                        .reshape(valid.shape) > 0)
        samples += int(used.sum())
        rows += [i[used].unique() for i in idx]
    return torch.cat(rows).unique().numel(), samples


# rois of ROADMAP section 3 item 3 and the borders on an 800x1344 canvas,
# [batch, x1, y1, x2, y2]: corners, a full-width and a full-height
# sliver, one past every border, one that is reversed, one degenerate
# and one invalid (last)
ROI_EDGE_CASES = (
    (0, 0, 0, 60, 60), (1, 1300, 760, 1344, 800), (1, 0, 400, 1344, 406),
    (0, 600, 0, 612, 800), (1, -400, -240, 1900, 1700),
    (0, 700, 500, 650, 420), (1, 5, 5, 5, 5), (0, 100, 100, 300, 300))


def _crowded_rois(gen, n, x0=400.0, y0=300.0, cells=20, stride=4,
                  device='cuda'):
    """n rois of 8-80 px, all inside one cells x cells area of P2 whose
    corner is (x0, y0) px, spread over a batch of 2."""
    u = torch.rand(n, 4, generator=gen)
    side = cells * stride
    w, h = 8 + u[:, 0] * (side - 8), 8 + u[:, 1] * (side - 8)
    x1, y1 = x0 + u[:, 2] * (side - w), y0 + u[:, 3] * (side - h)
    b = (torch.arange(n) % 2).float()
    return torch.stack([b, x1, y1, x1 + w, y1 + h], 1).to(device) \
        .contiguous()


def roi_checks(dtype, gen, randn):
    """RoIAlign (row 4) and its backward (row 9) against their plain
    versions at the main paths' shapes, each with its bound: the forward
    at serving's bbox (1000 rois 7x7) and mask (100 rois 14x14) shapes,
    batch 1, and at training's (1024 rois 7x7, 256 rois 14x14, batch 2),
    the backward at training's; then both at 7x7 and 14x14 on 256 rois
    piled on one 20x20-cell area of P2 (the backward's tiles each sum many
    overlapping rois) and on the edge-case rois, with one of them invalid.
    The backward must repeat bit for bit (it has no atomics). Returns the
    forward's and the backward's rows, the bbox shape first, with every
    main-path shape in ``shapes``."""
    strides = (4, 8, 16, 32)
    el = torch.finfo(dtype).bits // 8
    fwd, bwd = [], []
    shapes = [(2, h, w, 256) for h, w in FPN_SHAPES]
    level_bytes = sum(np.prod(s) for s in shapes) * el
    feats = {b: [randn(b, h, w, 256).to(dtype) for h, w in FPN_SHAPES]
             for b in (1, 2)}
    for n, size, b in ((1000, 7, 1), (100, 14, 1), (1024, 7, 2),
                       (256, 14, 2)):
        rois = _rois(gen, n, batch=b)
        touched, samples = _roi_work(FPN_SHAPES, rois, strides, size)
        note = f'{n} rois {size}x{size}x256' + ('' if b == 1 else
                                                 f', batch {b}')
        fwd.append(_compare(
            'roi_align', dtype,
            lambda: roi_align(feats[b], rois, strides, size),
            lambda: multilevel_roi_align(feats[b], rois, strides, size),
            note, work=(touched * 256 * el + _nbytes(rois)
                        + n * size * size * 256 * el,
                        samples * 256 * 4 * 2.0)))
        if b == 1:
            continue
        g = randn(n, size, size, 256).to(dtype)
        bwd.append(_compare(
            'roi_align_bwd', dtype,
            lambda: roi_align_bwd(shapes, dtype, rois, g, strides, size),
            lambda: multilevel_roi_align_backward(shapes, dtype, rois, g,
                                                  strides, size),
            note, summed=True,
            work=(_nbytes(g, rois) + level_bytes, samples * 256 * 4 * 2.0)))
        _check_repeats(shapes, dtype, rois, g, strides, size)
    edge = torch.tensor(ROI_EDGE_CASES, dtype=torch.float32).cuda()
    valid = torch.ones(len(edge), dtype=torch.bool).cuda()
    valid[-1] = False
    for rois, valid, note in ((_crowded_rois(gen, 256), None,
                               '256 rois on 20x20 cells of P2'),
                              (edge, valid, 'edge-case rois')):
        for size in (7, 14):
            g = randn(rois.shape[0], size, size, 256).to(dtype)
            _compare('roi_align', dtype,
                     lambda: roi_align(feats[2], rois, strides, size,
                                       roi_valid=valid),
                     lambda: multilevel_roi_align(feats[2], rois, strides,
                                                  size, roi_valid=valid),
                     f'{note} {size}x{size}x256, batch 2')
            _compare('roi_align_bwd', dtype,
                     lambda: roi_align_bwd(shapes, dtype, rois, g, strides,
                                           size, roi_valid=valid),
                     lambda: multilevel_roi_align_backward(
                         shapes, dtype, rois, g, strides, size,
                         roi_valid=valid),
                     f'{note} {size}x{size}x256, batch 2', summed=True)
            _check_repeats(shapes, dtype, rois, g, strides, size, valid)
    return dict(fwd[0], shapes=fwd), dict(bwd[0], shapes=bwd)


def _check_repeats(shapes, dtype, rois, g, strides, size, valid=None):
    """Two runs of the RoIAlign backward kernel give the same bits."""
    a, b = (roi_align_bwd(shapes, dtype, rois, g, strides, size,
                          roi_valid=valid) for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f'roi_align_bwd {dtype} {rois.shape[0]} rois '
                             f'{size}x{size}: two runs differ')


def _nms_inputs(gen, b, n, groups):
    """Score-sorted NMS candidates as batched_nms hands them to the
    kernel: proposal-like boxes over an 800x1344 canvas, each shifted by
    its group's offset (RPN level or class) times (max coordinate + 1),
    uniform scores, 5 % of them invalid; sorted by a stable sort on the
    negated score."""
    boxes = _rois(gen, b * n).cpu()[:, 1:].reshape(b, n, 4)
    ids = torch.randint(0, groups, (b, n), generator=gen).float()
    boxes = boxes + (ids * (boxes.amax(dim=(1, 2))[:, None] + 1.0))[..., None]
    valid = torch.rand(b, n, generator=gen) > 0.05
    score = torch.where(valid, torch.rand(b, n, generator=gen), -torch.inf)
    order = torch.sort(-score, dim=1, stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return [t.cuda().contiguous() for t in (
        boxes, torch.gather(score, 1, order), torch.gather(valid, 1, order),
        order)]


def _nms_work(args, out):
    """Bytes and fp32 operations that these candidates need: each input
    read once and each output written once; the IoUs of every kept box
    with the candidates after it (what the greedy scan must look at)."""
    boxes, _, _, order = args
    dets, inds, count = out
    n = order.shape[1]
    inv = torch.argsort(order, dim=1)
    pairs = 0
    for b in range(order.shape[0]):
        pos = inv[b][inds[b, :int(count[b])]]
        pairs += int((n - 1 - pos).sum())
    return (_nbytes(*args) + _nbytes(*out), NMS_OPS_PER_IOU * pairs,
            PEAK_FP32)


def _nms_blocks(args, out, max_out):
    """The 64-box blocks that the scan visits per image on these
    candidates: through the block of the last kept box where max_out were
    kept, else all of them."""
    order = args[3]
    _, inds, count = out
    inv = torch.argsort(order, dim=1)
    blocks = []
    for b in range(order.shape[0]):
        k = int(count[b])
        blocks.append(int(inv[b][inds[b, k - 1]]) // 64 + 1
                      if k == max_out and k else -(-order.shape[1] // 64))
    return blocks


def _kernel_device_ms(fn, keys, iters=10):
    """Device ms per call of fn() by kernel, from torch.profiler over
    ``iters`` calls: {key: the summed time of the kernels whose name holds
    keys[key]}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return {key: sum(e.device_time_total for e in events if name in e.key)
            / 1e3 / iters for key, name in keys.items()}


def _swin_chain(qmap, bias, mask, nh, shift, ws=7):
    """The unfused chain of row 15 in qmap's dtype: torch.roll, window
    partition, SDPA with the bias and the shift mask as one additive mask
    (made here, outside the timed call), window reverse; rolled
    coordinates, as the kernel's. The yardstick of row 15's kernels."""
    _, hp, wp, c3 = qmap.shape
    c, nwy, nwx = c3 // 3, hp // ws, wp // ws
    add = bias[None] if mask is None else bias[None] + mask[:, None]
    add = add.to(qmap.dtype)

    def chain():
        x = torch.roll(qmap, (-shift, -shift), (1, 2))
        q, k, v = x.view(1, nwy, ws, nwx, ws, c3).permute(0, 1, 3, 2, 4, 5) \
            .reshape(-1, ws * ws, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=add)
        return o.transpose(1, 2).reshape(1, nwy, nwx, ws, ws, c) \
            .permute(0, 1, 3, 2, 4, 5).reshape(1, hp, wp, c)
    return chain


def _swin_blockwise(qmap, bias, mask, nh, shift, ws=7):
    """The port's own blockwise path for row 15's attention: the
    backbone's roll + partition gather (window_gather_indices), row 2's
    wrapper with the shift mask, and the inverse gather, which also
    un-rolls. A yardstick of the fused kernel's worth."""
    _, hp, wp, c3 = qmap.shape
    idx, _, inv_idx = (torch.from_numpy(t).to(qmap.device)
                       for t in window_gather_indices(hp, wp, ws, shift))

    def blockwise():
        wins = qmap.view(1, hp * wp, c3)[:, idx].view(-1, ws * ws, c3)
        o = window_attention_v3(wins, bias, mask, nh)
        return o.view(1, hp * wp, c3 // 3)[:, inv_idx] \
            .view(1, hp, wp, c3 // 3)
    return blockwise


def swin_checks(dtype, randn):
    """Row 15 on the padded map of one image at the four Swin stages of
    an 800x1344 canvas with shift 3, and at stage 1 with no shift: each
    held to its plain version, with the kernel's profiler device ms, the
    unfused chain (unfused_ms) and the port's blockwise path (blockwise_ms,
    its output un-rolled, so held to the un-rolled kernel output; events
    and device ms of all their kernels). In bf16 every launch must be the
    tensor-core kernel's, in fp32 the SIMT kernel's. Returns stage 1 with
    shift 3 and every row under ``shapes``."""
    bf16 = dtype == torch.bfloat16
    peak = PEAK_FLOPS if bf16 else PEAK_FP32
    before = swin_window_attention.launches, swin_window_attention.tc_launches
    rows = []
    for (windows, c, nh, (hp, wp)), shift in (
            [(st, 3) for st in ATTN_STAGES] + [(ATTN_STAGES[0], 0)]):
        qmap = randn(1, hp, wp, 3 * c).to(dtype)
        bias = randn(nh, 49, 49, scale=0.5)
        mask = None if shift == 0 else torch.from_numpy(
            shifted_window_attn_mask(hp, wp, 7, shift)).to(qmap.device)
        fn = lambda: swin_window_attention(qmap, bias, 7, shift, nh)  # noqa
        r = _compare('swin_window_attention', dtype, fn,
                     lambda: swin_attention_reference(qmap, bias, 7, shift,
                                                      nh),
                     f'(1, {hp}, {wp}, 3x{c}) shift {shift}',
                     work=(_nbytes(qmap, bias) + _nbytes(qmap) // 3,
                           _attn_flops(windows, 49, c, 2), peak))
        r['device_ms'] = _kernel_device_ms(fn, {'k': 'swindet'})['k']
        got = fn()
        for name, yard, want in (
                ('unfused', _swin_chain(qmap, bias, mask, nh, shift), got),
                ('blockwise', _swin_blockwise(qmap, bias, mask, nh, shift),
                 torch.roll(got, (shift, shift), (1, 2)))):
            err = (yard().float() - want.float()).abs().max().item()
            atol, rtol = TOL[dtype]
            if not err <= atol + rtol * want.float().abs().max().item():
                raise AssertionError(f'swin_window_attention {dtype}: the '
                                     f'{name} yardstick differs by {err:.3g}')
            r[f'{name}_ms'] = cuda_ms(yard, iters=20)
            r[f'{name}_device_ms'] = _kernel_device_ms(yard,
                                                       {'k': ''})['k']
        log('kernels', f'  device ms: kernel {r["device_ms"]:.4f}, unfused '
                       f'chain {r["unfused_device_ms"]:.4f} (events '
                       f'{r["unfused_ms"]:.4f}), blockwise path '
                       f'{r["blockwise_device_ms"]:.4f} (events '
                       f'{r["blockwise_ms"]:.4f})')
        rows.append(r)
        del qmap, got
    launched = swin_window_attention.launches - before[0]
    launched_tc = swin_window_attention.tc_launches - before[1]
    log('kernels', f'  swin_window_attention: {launched} launches, '
                   f'{launched_tc} tensor-core')
    if launched_tc != (launched if bf16 else 0):
        raise AssertionError('swin_window_attention: bf16 must run the '
                             'tensor-core kernel and fp32 the SIMT one')
    return dict(rows[0], shapes=rows)


def _mlp_inputs(randn, rows, c, dtype):
    """x (rows, C) and the weights of a Swin token MLP (H = 4C) in dtype,
    fp32 biases, and the output gradient."""
    h = 4 * c
    return (randn(rows, c).to(dtype), randn(h, c, scale=c ** -0.5).to(dtype),
            randn(h, scale=0.1), randn(c, h, scale=h ** -0.5).to(dtype),
            randn(c, scale=0.1), randn(rows, c).to(dtype))


def _unfused_mlp(x, w1, b1, w2, b2):
    """The unfused chain in x's dtype (cuBLAS GEMMs, the hidden in device
    memory): the yardstick of the fused kernels."""
    return F.linear(F.gelu(F.linear(x, w1, b1.to(x.dtype))), w2,
                    b2.to(x.dtype))


def _unfused_mlp_bwd(x, w1, b1, w2, b2, g):
    """A function that runs the backward of the unfused chain's graph
    (built once here), the yardstick of the fused backward."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, w1, b1, w2,
                                                           b2)]
    out = _unfused_mlp(*leaves)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def _mlp_bwd_limits(bwd, want):
    """The limits of a bf16 run's fp32 weight gradients (dw1, db1, dw2)
    of the fused backward on the inputs ``bwd``, given the plain version's
    outputs ``want``: each the larger of TOL_SUM[fp32] of its largest entry
    and ORDER_SPREAD_FACTOR times its summation-order spread on these
    inputs (ops/fused_mlp.py). The plain version with the first 64-row
    tile of g zeroed, a kernel that dropped a tile, must exceed every one
    of them, or the limits could not tell."""
    limits = fused_mlp_bwd_limits(*bwd, want, floor=TOL_SUM[torch.float32])
    g = bwd[-1].clone()
    g[:64] = 0
    control = fused_mlp_bwd_reference(*bwd[:-1], g)
    errs = [(a - w).abs().max().item()
            for a, w in zip(control[1:4], want[1:4])]
    log('kernels', '  weight-gradient limits (dw1, db1, dw2): '
                   + ', '.join(f'{lim:.3g}' for lim in limits)
                   + '; control with a 64-row tile of g zeroed: '
                   + ', '.join(f'{e:.3g}' for e in errs))
    if any(e <= lim for e, lim in zip(errs, limits)):
        raise AssertionError('fused_mlp_bwd: the zeroed-tile control '
                             'passes the derived limits')
    return limits


def _sdpa_inputs(qkv, bias, mask, nh):
    """q, k, v (B_, nH, N, hd) views of the packed qkv and the additive
    bias + mask in qkv's dtype, for the library yardstick."""
    b_, n, c3 = qkv.shape
    q, k, v = qkv.view(b_, n, 3, nh, c3 // 3 // nh).permute(2, 0, 3, 1, 4)
    add = bias[None].expand(b_, -1, -1, -1)
    if mask is not None:
        add = (add.reshape(b_ // mask.shape[0], mask.shape[0], nh, n, n)
               + mask[None, :, None]).reshape(b_, nh, n, n)
    return q, k, v, add.to(qkv.dtype).contiguous()


def _sdpa_bwd(qkv, bias, mask, nh, g):
    """A function that runs the autograd backward of SDPA's graph (built
    once here) with q, k, v and the fp32 bias as leaves, the bias added
    to every window with the mask (so dBias sums over the windows): the
    yardstick of row 7."""
    b_, n, c3 = qkv.shape
    hd = c3 // 3 // nh
    leaves = [t.detach().contiguous().requires_grad_()
              for t in qkv.view(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)]
    leaves.append(bias.detach().clone().requires_grad_())
    add = _sdpa_inputs(qkv, leaves[3], mask, nh)[3]
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=add)
    go = g.view(b_, n, nh, hd).transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, go, retain_graph=True)


def _v4_inputs(randn, b_, c, dtype):
    """x (B_, 49, C) in dtype, the fp32 projections of a Swin block (nn.Linear
    layout) and an output gradient in dtype."""
    return (randn(b_, 49, c).to(dtype), randn(3 * c, c, scale=c ** -0.5),
            randn(3 * c, scale=0.1), randn(c, c, scale=c ** -0.5),
            randn(c, scale=0.1), randn(b_, 49, c).to(dtype))


def _unfused_v4(x, wqkv, bqkv, bias, mask, wproj, bproj, nh):
    """The unfused chain in x's dtype: F.linear -> SDPA with the additive
    bias and mask -> F.linear (cuBLAS and a library attention, qkv and the
    attention output in device memory): the yardstick of the v4 kernels.
    The weights are cast beforehand, outside the timed call."""
    b_, n, c = x.shape
    q, k, v, add = _sdpa_inputs(F.linear(x, wqkv, bqkv), bias, mask, nh)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=add)
    return F.linear(out.transpose(1, 2).reshape(b_, n, c), wproj, bproj)


def _unfused_v4_bwd(x, wqkv, bqkv, bias, mask, wproj, bproj, nh, g):
    """A function that runs the backward of the unfused chain's graph
    (built once here), the yardstick of the v4 backward."""
    d = x.dtype
    leaves = [t.detach().to(d).clone().requires_grad_()
              for t in (x, wqkv, bqkv, wproj, bproj)]
    bias = bias.detach().clone().requires_grad_()
    out = _unfused_v4(leaves[0], leaves[1], leaves[2], bias, mask,
                      leaves[3], leaves[4], nh)
    return lambda: torch.autograd.grad(out, leaves + [bias], g,
                                       retain_graph=True)


def _v4_bwd_check(bwd, bproj):
    """Row 13's bf16 check on the inputs ``bwd``: the limits of its fp32
    outputs (dWqkv, dbqkv, dBias, dWproj, dbproj) against the plain
    version with the tensor-core kernels' roundings, each the largest of
    TOL_SUM[fp32] of its largest entry, ORDER_SPREAD_FACTOR (4) times its
    summation-order spread on these inputs and the change one rounding
    flip can make (ops/window_attention_v4.py). That plain version with
    the first 64-row tile of g zeroed, a kernel that dropped a tile, must
    exceed every one. Logs beside them the grade of a bf16 run: the
    kernel's distance to the fp32 plain version and that of the bf16
    autograd of the unfused chain, as shares of each output's largest
    entry. Returns the six outputs' limits (None for dx, held to
    TOL_SUM[bf16])."""
    x, wqkv, bqkv, bias, mask, wproj, g, nh = bwd
    want = window_attention_v4_bwd_reference(*bwd, tc_rounding=True)
    limits = window_attention_v4_bwd_limits(*bwd, want,
                                            floor=TOL_SUM[torch.float32])
    dropped = g.clone()
    dropped.view(-1, x.shape[-1])[:64] = 0
    control = window_attention_v4_bwd_reference(*bwd[:-2], dropped, nh,
                                                tc_rounding=True)
    errs = [(a - w).abs().max().item()
            for a, w in zip(control[1:], want[1:])]
    del want, control, dropped

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    fp32 = window_attention_v4_bwd_reference(*bwd)
    got = window_attention_v4_bwd(*bwd)
    chain = _unfused_v4_bwd(x, wqkv, bqkv, bias, mask, wproj, bproj, nh,
                            g)()
    chain = [chain[i] for i in (0, 1, 2, 5, 3, 4)]
    log('kernels', '  fp32-output limits (dWqkv, dbqkv, dBias, dWproj, '
                   'dbproj): ' + ', '.join(f'{lim:.3g}' for lim in limits)
                   + '; control with a 64-row tile of g zeroed: '
                   + ', '.join(f'{e:.3g}' for e in errs))
    log('kernels', '  distance to the fp32 plain version / max|fp32| '
                   '(dx, dWqkv, dbqkv, dBias, dWproj, dbproj): kernel '
                   + ', '.join(f'{rel(a, f):.2g}' for a, f in zip(got, fp32))
                   + '; bf16 autograd of the unfused chain '
                   + ', '.join(f'{rel(a, f):.2g}'
                               for a, f in zip(chain, fp32)))
    if any(e <= lim for e, lim in zip(errs, limits)):
        raise AssertionError('window_attention_v4_bwd: the zeroed-tile '
                             'control passes the derived limits')
    return [None, *limits]


def _v4_flops(b_, c, backward=False):
    """Operations of the v4 function on B_ windows of 49 tokens: the qkv
    and output projections (8 N C^2 a window) and the two attention
    products; the backward recomputes qkv, P and the attention output and
    adds d(attn), dWproj, dWqkv and dx (22 N C^2 in all) and the four
    products of the attention backward."""
    rows = b_ * 49
    if backward:
        return 22.0 * rows * c * c + _attn_flops(b_, 49, c, 6)
    return 8.0 * rows * c * c + _attn_flops(b_, 49, c, 2)


def _conv_compare(dtype, x, cw, cb, relu=False):
    """Row 3 (``conv3x3``) on x (B, H, W, C) with cw (3, 3, C, Co) and cb
    against its plain version, with its bound and the library call on
    channels-last views (F.conv2d, without the ReLU where the kernel fuses
    one)."""
    (b, h, w, c), co = x.shape, cw.shape[3]
    x_nchw, w_oihw = x.permute(0, 3, 1, 2), cw.permute(3, 2, 0, 1)
    cbd = cb.to(dtype)
    return _compare('conv3x3', dtype, lambda: conv3x3(x, cw, cb, relu),
                    lambda: conv3x3_reference(x, cw, cb, relu),
                    f'({b}, {h}, {w}, {c}->{co})' + (' relu' if relu else ''),
                    work=(_nbytes(x) + b * h * w * co * x.element_size()
                          + _nbytes(cw, cb), 2.0 * 9 * c * co * b * h * w),
                    library_fn=lambda: F.conv2d(x_nchw, w_oihw, cbd,
                                                padding=1))


def _dw_compare(dtype, x, g):
    """Row 8 (``conv3x3_dw``) on x (B, H, W, C) and g (B, H, W, Co)
    against its plain version, with its bound and
    torch.nn.grad.conv2d_weight on channels-last views."""
    (b, h, w, c), co = x.shape, g.shape[3]
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    return _compare('conv3x3_dw', dtype, lambda: conv3x3_dw(x, g),
                    lambda: conv3x3_dw_reference(x, g),
                    f'({b}, {h}, {w}, {c}->{co})', summed=True,
                    work=(_nbytes(x, g) + 9 * c * co * 4,
                          2.0 * 9 * c * co * b * h * w),
                    library_fn=lambda: torch.nn.grad.conv2d_weight(
                        x_nchw, (co, c, 3, 3), g_nchw, padding=1))


def phase_kernels():
    gen = torch.Generator().manual_seed(0)
    dev = 'cuda'

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    results = {}
    strides = (4, 8, 16, 32)
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.finfo(dtype).bits // 8
        # LayerNorm at the seven shapes of a request's 32 norms (the row's
        # main shape first: the patch embedding's and stage 1's), each with
        # its kernel's device ms beside the wrapper's event ms
        rows1 = []
        for n, c in LN_SHAPES:
            x = (randn(n, c) * 2 + 0.5).to(dtype)
            w, b = randn(c), randn(c)
            wd, bd = w.to(dtype), b.to(dtype)
            r = _compare('layer_norm', dtype, lambda: layer_norm(x, w, b),
                         lambda: layer_norm_reference(x, w, b),
                         f'({n}, {c})',
                         work=(2 * _nbytes(x) + _nbytes(w, b),
                               8.0 * x.numel()),
                         library_fn=lambda: F.layer_norm(x, (c,), wd, bd))
            r['device_ms'] = _kernel_device_ms(
                lambda: layer_norm(x, w, b), {'k': 'swindet'})['k']
            log('kernels', f'  device ms {r["device_ms"]:.4f}')
            rows1.append(r)
        # the first kernel (a warp a row), which takes the widths that are
        # no multiple of the vector and bases off 16 bytes: the main
        # shape's x copied one element past a 16-byte boundary
        x = (randn(*LN_SHAPES[0]) * 2 + 0.5).to(dtype)
        w, b = randn(x.shape[1]), randn(x.shape[1])
        off = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:] \
            .view(x.shape).copy_(x)
        first = _compare('layer_norm', dtype, lambda: layer_norm(off, w, b),
                         lambda: layer_norm_reference(x, w, b),
                         f'{tuple(x.shape)} off 16 bytes',
                         work=(2 * _nbytes(x) + _nbytes(w, b),
                               8.0 * x.numel()))
        dms = _kernel_device_ms(lambda: layer_norm(off, w, b),
                                {'first': 'layer_norm_kernel',
                                 'vec': 'layer_norm_vec_kernel'})
        if dms['first'] <= 0 or dms['vec'] > 0:
            raise AssertionError('layer_norm: a base off 16 bytes must run '
                                 f'the first kernel alone, profiler {dms}')
        first['device_ms'] = dms['first']
        log('kernels', f'  device ms {first["device_ms"]:.4f} (the first '
                       'kernel)')
        results.setdefault('layer_norm', {})[dtype] = dict(
            rows1[0], shapes=rows1, first_kernel=first)
        del x, off

        # window attention at the shifted blocks of stages 1-4 of an
        # 800x1344 canvas: the forward (row 2) at a request's windows, the
        # training forward (row 6) and the backward (row 7) at a training
        # batch's (twice as many); in bf16 (the tensor-core kernels) at
        # every stage, in fp32 (the SIMT kernels) at stages 1 and 4
        rows2, rows6, rows7 = [], [], []
        for b_, c, nh, hw in (ATTN_STAGES if dtype == torch.bfloat16
                              else ATTN_STAGES[::3]):
            mask = torch.from_numpy(
                shifted_window_attn_mask(*hw, 7, 3)).to(dev)
            bias = randn(nh, 49, 49, scale=0.5)
            qkv = randn(b_, 49, 3 * c).to(dtype)
            q, k, v, add = _sdpa_inputs(qkv, bias, mask, nh)
            rows2.append(_compare(
                'window_attention_v3', dtype,
                lambda: window_attention_v3(qkv, bias, mask, nh),
                lambda: window_attention_reference(qkv, bias, mask, nh),
                f'({b_}, 49, 3x{c}) {nh} heads shifted',
                work=(_nbytes(qkv, bias, mask) + _nbytes(qkv) // 3,
                      _attn_flops(b_, 49, c, 2)),
                library_fn=lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=add)))
            del qkv, q, k, v, add
            qkv2 = randn(2 * b_, 49, 3 * c).to(dtype)
            # out held to TOL[dtype] elementwise, the fp32 P to TOL[fp32]
            rows6.append(_compare(
                'window_attention_fwd_p', dtype,
                lambda: window_attention_fwd_p(qkv2, bias, mask, nh),
                lambda: window_attention_fwd_p_reference(qkv2, bias, mask,
                                                         nh),
                f'({2 * b_}, 49, 3x{c}) {nh} heads shifted',
                work=(_nbytes(qkv2, bias, mask) + _nbytes(qkv2) // 3
                      + nh * 2 * b_ * 49 * 49 * 4,
                      _attn_flops(2 * b_, 49, c, 2))))
            _, p = window_attention_fwd_p_reference(qkv2, bias, mask, nh)
            g = randn(2 * b_, 49, c).to(dtype)
            r = _compare('window_attention_bwd', dtype,
                         lambda: window_attention_bwd(qkv2, p, g, nh),
                         lambda: window_attention_bwd_reference(qkv2, p, g,
                                                                nh),
                         f'({2 * b_}, 49, 3x{c}) {nh} heads', summed=True,
                         work=(2 * _nbytes(qkv2) + _nbytes(p, g)
                               + nh * 49 * 49 * 4,
                               _attn_flops(2 * b_, 49, c, 5)))
            r['unfused_ms'] = cuda_ms(_sdpa_bwd(qkv2, bias, mask, nh, g),
                                      iters=20)
            log('kernels', f'  SDPA backward (autograd, q, k, v and the '
                           f'bias as leaves) {r["unfused_ms"]:.4f} ms')
            rows7.append(r)
            del qkv2, p, g
            torch.cuda.empty_cache()
        results.setdefault('window_attention_v3', {})[dtype] = dict(
            rows2[0], shapes=rows2)
        results.setdefault('window_attention_fwd_p', {})[dtype] = dict(
            rows6[0], shapes=rows6)
        results.setdefault('window_attention_bwd', {})[dtype] = dict(
            rows7[0], shapes=rows7)

        # 3x3 conv: the FPN output convs at P2 (the row's main shape) and,
        # in bf16 (the tensor-core kernel), P3-P5; in bf16 the RPN conv
        # (ReLU) at P6; the mask-head conv (ReLU) on 100 rois
        x = randn(1, 200, 336, 256).to(dtype)
        cw = randn(3, 3, 256, 256, scale=0.02).to(dtype)
        cb = randn(256)
        rows = [_conv_compare(dtype, x, cw, cb)]
        if dtype == torch.bfloat16:
            for (h, w), relu in [(hw, False) for hw in FPN_SHAPES[1:]] \
                    + [((13, 21), True)]:
                rows.append(_conv_compare(dtype, randn(1, h, w, 256).to(
                    dtype), cw, cb, relu))
        xm = randn(100, 14, 14, 256).to(dtype)
        rows.append(_conv_compare(dtype, xm, cw, cb, True))
        results.setdefault('conv3x3', {})[dtype] = dict(rows[0], shapes=rows)

        # its filter gradient: FPN P2 of a batch of 2; mask head, 256 rois
        x2 = randn(2, 200, 336, 256).to(dtype)
        g2 = randn(2, 200, 336, 256, scale=0.1).to(dtype)
        rows = [_dw_compare(dtype, x2, g2)]
        del x2, g2
        xm2 = randn(256, 14, 14, 256).to(dtype)
        gm2 = randn(256, 14, 14, 256, scale=0.1).to(dtype)
        rows.append(_dw_compare(dtype, xm2, gm2))
        results.setdefault('conv3x3_dw', {})[dtype] = dict(rows[0],
                                                           shapes=rows)
        del x, xm, xm2, gm2
        torch.cuda.empty_cache()

        results.setdefault('roi_align', {})[dtype], \
            results.setdefault('roi_align_bwd', {})[dtype] = \
            roi_checks(dtype, gen, randn)
        torch.cuda.empty_cache()

        # fused MLP: in bf16 (the tensor-core kernels) the forward at the
        # serving rows of stages 1-3 and the training rows of stage 1, the
        # backward at the training rows of stages 1-3; in fp32 (the SIMT
        # kernels) stages 1 and 3
        fwd = ((67200, 96), (16800, 192), (4200, 384), (134400, 96)) \
            if dtype == torch.bfloat16 else ((67200, 96), (4200, 384))
        rows = []
        for n, c in fwd:
            x, w1, b1, w2, b2, _ = _mlp_inputs(randn, n, c, dtype)
            mlp = (x, w1, b1, w2, b2)
            r = _compare('fused_mlp', dtype, lambda: fused_mlp(*mlp),
                         lambda: fused_mlp_reference(*mlp),
                         f'({n}, {c}) H {4 * c}',
                         work=(_nbytes(*mlp) + _nbytes(x),
                               4.0 * n * c * 4 * c))
            r['unfused_ms'] = cuda_ms(lambda: _unfused_mlp(*mlp), iters=20)
            log('kernels', f'  unfused F.linear -> F.gelu -> F.linear '
                           f'{r["unfused_ms"]:.4f} ms')
            rows.append(r)
        results.setdefault('fused_mlp', {})[dtype] = dict(rows[0],
                                                          shapes=rows)
        rows = []
        for n, c in ((134400, 96), (33600, 192), (8400, 384)) \
                if dtype == torch.bfloat16 else ((134400, 96), (8400, 384)):
            x, w1, b1, w2, b2, g = _mlp_inputs(randn, n, c, dtype)
            bwd = (x, w1, b1, w2, g)
            want = fused_mlp_bwd_reference(*bwd)
            limits = None
            if dtype == torch.bfloat16:
                limits = [None, *_mlp_bwd_limits(bwd, want), None]
            r = _compare('fused_mlp_bwd', dtype, lambda: fused_mlp_bwd(*bwd),
                         lambda: fused_mlp_bwd_reference(*bwd),
                         f'({n}, {c}) H {4 * c}', summed=True,
                         limits=limits,
                         work=(_nbytes(*bwd) + _nbytes(x)
                               + 4 * (2 * 4 * c * c + 5 * c),
                               10.0 * n * c * 4 * c))
            del want
            r['unfused_ms'] = cuda_ms(_unfused_mlp_bwd(x, w1, b1, w2, b2, g),
                                      iters=20)
            log('kernels', f'  unfused backward (autograd of the chain) '
                           f'{r["unfused_ms"]:.4f} ms')
            rows.append(r)
        results.setdefault('fused_mlp_bwd', {})[dtype] = dict(rows[0],
                                                              shapes=rows)
        del x, g, mlp, bwd
        torch.cuda.empty_cache()

        # v4 attention (qkv projection, attention, output projection in one
        # kernel, row 12, and its backward, row 13): in bf16 (the
        # tensor-core kernels, bound at the bf16 tensor-core rate) at every
        # stage, in fp32 (the SIMT kernels, bound at the fp32 CUDA-core
        # rate) at stages 1 and 4; the forward at a request's windows, the
        # backward at a training batch's, with the stage's shift mask. The
        # bf16 backward is held to the plain version with the tensor-core
        # kernels' roundings (_v4_bwd_check).
        bf16 = dtype == torch.bfloat16
        peak = PEAK_FLOPS if bf16 else PEAK_FP32
        rows12, rows13 = [], []
        for b_, c, nh, hw in ATTN_STAGES if bf16 else ATTN_STAGES[::3]:
            mask = torch.from_numpy(
                shifted_window_attn_mask(*hw, 7, 3)).to(dev)
            bias = randn(nh, 49, 49, scale=0.5)
            x, wqkv, bqkv, wproj, bproj, _ = _v4_inputs(randn, b_, c, dtype)
            v4 = (x, wqkv, bqkv, bias, mask, wproj, bproj, nh)
            r = _compare('window_attention_v4', dtype,
                         lambda: window_attention_v4(*v4),
                         lambda: window_attention_v4_reference(
                             x.float(), *v4[1:]).to(dtype),
                         f'({b_}, 49, {c}) {nh} heads shifted',
                         work=(2 * _nbytes(x) + _nbytes(wqkv, bqkv, bias,
                                                        wproj, bproj, mask),
                               _v4_flops(b_, c), peak))
            cast = [t.to(dtype) for t in (wqkv, bqkv, wproj, bproj)]
            r['unfused_ms'] = cuda_ms(lambda: _unfused_v4(
                x, cast[0], cast[1], bias, mask, cast[2], cast[3], nh),
                iters=20)
            log('kernels', f'  unfused F.linear -> SDPA -> F.linear '
                           f'{r["unfused_ms"]:.4f} ms')
            rows12.append(r)
            del x, v4, cast
            x, wqkv, bqkv, wproj, bproj, g = _v4_inputs(randn, 2 * b_, c,
                                                        dtype)
            bwd = (x, wqkv, bqkv, bias, mask, wproj, g, nh)
            limits = _v4_bwd_check(bwd, bproj) if bf16 else None
            r = _compare('window_attention_v4_bwd', dtype,
                         lambda: window_attention_v4_bwd(*bwd),
                         lambda: window_attention_v4_bwd_reference(
                             *bwd, tc_rounding=bf16),
                         f'({2 * b_}, 49, {c}) {nh} heads shifted',
                         summed=True, limits=limits,
                         work=(3 * _nbytes(x) + 2 * _nbytes(
                             wqkv, bqkv, bias, wproj, bproj) + _nbytes(mask),
                               _v4_flops(2 * b_, c, backward=True), peak))
            r['unfused_ms'] = cuda_ms(_unfused_v4_bwd(
                x, wqkv, bqkv, bias, mask, wproj, bproj, nh, g), iters=20)
            log('kernels', f'  unfused backward (autograd of the chain) '
                           f'{r["unfused_ms"]:.4f} ms')
            rows13.append(r)
            del x, g, bwd
            torch.cuda.empty_cache()
        results.setdefault('window_attention_v4', {})[dtype] = dict(
            rows12[0], shapes=rows12)
        results.setdefault('window_attention_v4_bwd', {})[dtype] = dict(
            rows13[0], shapes=rows13)

        # the v1 attention over head-major q, k, v (row 14; in bf16 its
        # tensor-core kernel, in fp32 the SIMT one) and the full-map shifted
        # attention, which no model path runs: stage 1 of one image. Row
        # 14's wrapper makes the head-major copy before its kernel: the
        # profiler splits the kernel's device ms from the copy's.
        mask = torch.from_numpy(
            shifted_window_attn_mask(203, 336, 7, 3)).to(dev)
        qkv = randn(1392, 49, 288).to(dtype)
        bias = randn(3, 49, 49, scale=0.5)
        q, k, v, add = _sdpa_inputs(qkv, bias, mask, 3)
        before = window_attention.launches, window_attention.tc_launches
        r = _compare(
            'window_attention', dtype,
            lambda: window_attention(qkv, bias, mask, 3),
            lambda: window_attention_reference(qkv, bias, mask, 3),
            '(1392, 49, 3x96) shifted',
            work=(_nbytes(qkv, bias, mask) + _nbytes(qkv) // 3,
                  _attn_flops(1392, 49, 96, 2)),
            library_fn=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=add))
        dms = _kernel_device_ms(lambda: window_attention(qkv, bias, mask, 3),
                                {'device_ms': 'swindet', 'all': ''})
        r['device_ms'] = dms['device_ms']
        r['copy_device_ms'] = dms['all'] - dms['device_ms']
        launched = window_attention.launches - before[0]
        launched_tc = window_attention.tc_launches - before[1]
        log('kernels', f'  device ms: kernel {r["device_ms"]:.4f}, '
                       f'head-major copy {r["copy_device_ms"]:.4f}; '
                       f'{launched} launches, {launched_tc} tensor-core')
        if launched_tc != (launched if dtype == torch.bfloat16 else 0):
            raise AssertionError('window_attention: bf16 must run the '
                                 'tensor-core kernel and fp32 the SIMT one')
        results.setdefault('window_attention', {})[dtype] = r
        del qkv, q, k, v, add
        results.setdefault('swin_window_attention', {})[dtype] = \
            swin_checks(dtype, randn)

        # NMS on fp32 boxes (the same in both configurations): RPN when
        # serving and in a training step, the bbox head's multiclass NMS;
        # its mask and scan kernels' device times apart
        if dtype == torch.float32:
            rows = []
            for b, n, groups, thr, max_out, note in (
                    (2, 8819, 5, 0.7, 1000, 'RPN train'),
                    (1, 4819, 5, 0.7, 1000, 'RPN serve'),
                    (1, 2048, 80, 0.5, 100, 'multiclass')):
                args = _nms_inputs(gen, b, n, groups)
                out = nms_sorted_reference(*args, thr, max_out)
                r = _compare('nms_sorted', dtype,
                             lambda: nms_sorted(*args, thr, max_out),
                             lambda: nms_sorted_reference(*args, thr,
                                                          max_out),
                             f'B {b} N {n} IoU {thr} max {max_out} ({note}, '
                             f'{[int(k) for k in out[2]]} kept)',
                             work=_nms_work(args, out), exact=True)
                r.update(_kernel_device_ms(
                    lambda: nms_sorted(*args, thr, max_out),
                    {'mask_device_ms': 'nms_mask_kernel',
                     'scan_device_ms': 'nms_scan_kernel'}))
                r['scan_blocks'] = _nms_blocks(args, out, max_out)
                log('kernels', f'  device ms: mask {r["mask_device_ms"]:.4f}'
                               f', scan {r["scan_device_ms"]:.4f}; 64-box '
                               f'blocks the scan visited per image '
                               f'{r["scan_blocks"]} of {-(-n // 64)}')
                rows.append(r)
            results['nms_sorted'] = {dtype: dict(rows[0], shapes=rows)}
            del args, out
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------- phase 4
def synthetic_images(n, h=800, w=1333, seed=0, with_boxes=False):
    """Seeded noise with painted rectangles (bench.py's input recipe), as
    BGR uint8 images; with ``with_boxes`` also each image's rectangles
    (16, 4) as x1, y1, x2, y2."""
    rs = np.random.RandomState(seed)
    imgs, boxes = [], []
    for _ in range(n):
        raw = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        rects = []
        for _ in range(16):
            y0, x0 = rs.randint(0, h - 64), rs.randint(0, w - 64)
            bh, bw = rs.randint(24, 256), rs.randint(24, 256)
            raw[y0:min(y0 + bh, h), x0:min(x0 + bw, w)] = \
                rs.randint(0, 256, 3)
            rects.append((x0, y0, min(x0 + bw, w), min(y0 + bh, h)))
        imgs.append(raw)
        boxes.append(np.array(rects, np.float32))
    return (imgs, boxes) if with_boxes else imgs


def _check_result(res, h, w):
    bbox_res, mask_res = res
    if len(bbox_res) != 80 or len(mask_res) != 80:
        raise AssertionError('expected 80 classes of results')
    n = 0
    for dets, masks in zip(bbox_res, mask_res):
        if dets.ndim != 2 or dets.shape[1] != 5 \
                or not np.isfinite(dets).all():
            raise AssertionError(f'bad detections {dets.shape}')
        if len(masks) != len(dets) or any(m.shape != (h, w) for m in masks):
            raise AssertionError('masks do not match detections')
        n += len(dets)
    # seeded heads score every class near 1/81, under score_thr 0.05, so
    # few or no boxes survive; phase 5 checks detections with spread heads
    if n > 100:
        raise AssertionError(f'{n} detections, over max_per_img 100')
    return n


@contextlib.contextmanager
def env_switch(name):
    """A configuration of the JAX package's switches: ``name``=1
    (SWINDET_FUSED_MLP, read by every Mlp built inside, or
    SWINDET_WATTN_V4, read by every WindowAttention)."""
    os.environ[name] = '1'
    try:
        yield
    finally:
        del os.environ[name]


def _fused_blocks(model):
    """How many token MLPs of the model run fused."""
    return sum(bool(getattr(m, 'fused', False)) for m in model.modules())


def _check_blocks(model, fused, v4):
    """Swin-T's configuration as built: 10 fused token MLPs (stages 1-3)
    with the fused-MLP switch, 12 v4 attention blocks with the v4 switch,
    none otherwise."""
    v4_blocks = sum(m.v4 for m in model.modules()
                    if isinstance(m, WindowAttention))
    got = (_fused_blocks(model), v4_blocks)
    if got != (10 if fused else 0, 12 if v4 else 0):
        raise AssertionError(f'{got[0]} fused token MLPs, {got[1]} v4 '
                             f'attention blocks')
    return got


def _serving_kernels(v4):
    """The kernels a request must launch: the inference kernels, with the
    v4 forward in place of the v3 one in the v4 configuration."""
    return tuple(window_attention_v4 if v4 and fn is window_attention_v3
                 else fn for fn in INFERENCE_KERNELS)


# kernels that serving and a validation pass must not launch
NOT_SERVING = TRAINING_KERNELS + (fused_mlp_bwd, window_attention_v4_bwd) \
    + OP_ONLY_KERNELS


def _tc_kernels(fused, training=True, v4=False):
    """The wrappers with a tensor-core kernel that a run launches: the
    conv forward and, in training, its filter gradient; outside the v4
    configuration the v3 attention's inference forward (serving) or its
    training forward and backward (training), in it the v4 forward and,
    in training, its backward; in the fused-MLP configuration the fused
    forward and, in training, its backward."""
    kernels = (conv3x3, conv3x3_dw) if training else (conv3x3,)
    if not v4:
        kernels += (window_attention_fwd_p, window_attention_bwd) \
            if training else (window_attention_v3,)
    else:
        kernels += WATTN_V4_KERNELS if training else (window_attention_v4,)
    if fused:
        kernels += FUSED_MLP_KERNELS if training else (fused_mlp,)
    return kernels


def _check_tc(what, launches, bf16, wanted):
    """The conv, fused-MLP and v3 and v4 attention wrappers pick their
    kernel by dtype (the attentions' also by head width, 32 at every
    stage): in a bf16 run every launch is a tensor-core one, and each of
    ``wanted`` launched; in an fp32 run none is. Returns the tensor-core
    counts."""
    tc = tc_launch_counts()
    want = {fn.__name__: launches[fn.__name__] if bf16 else 0
            for fn in TENSOR_CORE_KERNELS}
    idle = [fn.__name__ for fn in wanted if not launches[fn.__name__]]
    if tc != want or idle:
        raise AssertionError(f'{what}: tensor-core launches {tc}, expected '
                             f'{want}; not launched: {idle}')
    return tc


def phase_main(phase='main', fused=False, v4=False):
    opts = {'model.test_cfg.rpn.nms_pre': 1000,
            'model.test_cfg.rpn.max_per_img': 1000}
    t0 = time.perf_counter()
    model = init_detector(CONFIG, device='cuda', cfg_options=opts, seed=0)
    blocks, v4_blocks = _check_blocks(model, fused, v4)
    log(phase, f'init_detector: {type(model).__name__} '
               f'{sum(p.numel() for p in model.parameters())} params, '
               f'compute {model.dtype}, {blocks} fused token MLPs, '
               f'{v4_blocks} v4 attention blocks, '
               f'{time.perf_counter() - t0:.1f} s')
    imgs = synthetic_images(3)
    t0 = time.perf_counter()
    _check_result(inference_detector(model, imgs[0]), 800, 1333)
    torch.cuda.synchronize()
    log(phase, f'warm-up request {time.perf_counter() - t0:.3f} s')

    reset_launch_counts()
    lat = []
    counts = []
    for img in imgs:
        t0 = time.perf_counter()
        res = inference_detector(model, img)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        counts.append(_check_result(res, 800, 1333))
    launches = launch_counts()
    log(phase, 'per-image latency (s): '
               + ', '.join(f'{t:.4f}' for t in lat)
               + f'; detections per image: {counts}')
    log(phase, f'kernel launches over the 3 requests: {launches}')
    tc = _check_tc(phase, launches, True, _tc_kernels(fused, False, v4))
    log(phase, f'of which tensor-core kernels: {tc}')
    idle = [fn.__name__ for fn in _serving_kernels(v4)
            if launches[fn.__name__] == 0]
    if idle:
        raise AssertionError(f'kernels not launched on the main path: '
                             f'{idle}')
    # serving must not pay for the training forward's softmax writes
    trained = [fn.__name__ for fn in NOT_SERVING if launches[fn.__name__]]
    if trained:
        raise AssertionError(f'training kernels launched while serving: '
                             f'{trained}')
    # NMS twice a request (RPN proposals, multiclass NMS); the fused
    # forward once per fused block; the attention forward, v3 or v4, once
    # per Swin block
    want = {'nms_sorted': 2 * len(imgs),
            'fused_mlp': (10 if fused else 0) * len(imgs),
            'window_attention_v3': (0 if v4 else 12) * len(imgs),
            'window_attention_v4': (12 if v4 else 0) * len(imgs)}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f'launches {got}, expected {want}')
    return launches, lat, tc


# ------------------------------------------------------------- phase 5
def phase_check(device: str = 'cuda', phase: str = 'check',
                fused: bool = False, v4: bool = False):
    """fp32 Swin-T Mask R-CNN on a 224x320 canvas, on the card (kernels)
    and on the CPU (plain versions), same seeded weights; rpn_cls and
    fc_cls are scaled to std 1 so no top-k or NMS boundary sits within
    fp32 noise."""
    opts = {'bf16': False, 'model.test_cfg.rpn.nms_pre': 1000,
            'model.test_cfg.rpn.max_per_img': 1000}
    cpu = init_detector(CONFIG, device='cpu', cfg_options=opts, seed=1)
    with torch.no_grad():
        cpu.rpn_head.rpn_cls.weight.mul_(100.0)
        cpu.roi_head.bbox_head.fc_cls.weight.mul_(100.0)
    gpu = init_detector(CONFIG, device='cpu', cfg_options=opts, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(device)
    rs = np.random.RandomState(1)
    img = rs.randn(1, 224, 320, 3).astype(np.float32)
    shapes = np.array([[224, 320]], np.int32)
    sf = np.ones((1, 4), np.float32)
    _check_blocks(gpu, fused, v4)
    outs = []
    reset_launch_counts()
    for model, dev in ((cpu, 'cpu'), (gpu, device)):
        args = [torch.from_numpy(a).to(dev) for a in (img, shapes, sf)]
        with torch.inference_mode():
            feats = model.extract_feat(args[0])
            out = model.simple_test(*args)
        outs.append(([f.cpu() for f in feats],
                     {k: v.cpu() for k, v in out.items()}))
    (f_cpu, o_cpu), (f_gpu, o_gpu) = outs
    if device == 'cuda' and (
            bool(fused_mlp.launches) != fused
            or bool(window_attention_v4.launches) != v4
            or bool(window_attention_v3.launches) == v4):
        raise AssertionError(f'launches against the configuration: '
                             f'{launch_counts()}')
    if device == 'cuda':
        _check_tc(phase, launch_counts(), False,
                  _tc_kernels(fused, False, v4))
    feat_err = max((a - b).abs().max().item() / max(a.abs().max().item(), 1)
                   for a, b in zip(f_cpu, f_gpu))
    if feat_err > 1e-3:
        raise AssertionError(f'FPN features: card vs CPU relative max|d| '
                             f'{feat_err:.3g} > 1e-3')
    if not torch.equal(o_cpu['det_valid'], o_gpu['det_valid']) \
            or not torch.equal(o_cpu['labels'], o_gpu['labels']):
        raise AssertionError('detections differ between card and CPU')
    box_err = (o_cpu['dets'] - o_gpu['dets']).abs().max().item()
    mask_err = (o_cpu['mask_probs'] - o_gpu['mask_probs']).abs().max().item()
    n = int(o_cpu['det_valid'].sum())
    if n == 0 or box_err > 1e-2 or mask_err > 1e-3:
        raise AssertionError(f'{n} dets, box max|d| {box_err:.3g} (1e-2), '
                             f'mask max|d| {mask_err:.3g} (1e-3)')
    log(phase, f'224x320 fp32 card vs CPU: features rel max|d| '
                 f'{feat_err:.3g}, {n} dets equal, box max|d| '
                 f'{box_err:.3g} px, mask max|d| {mask_err:.3g}')


# ------------------------------------------------------------- phase 6
TRAIN_GRADS = (
    'backbone.patch_embed.proj.weight',
    'backbone.layers.0.blocks.0.attn.qkv.weight',
    'backbone.layers.0.blocks.0.attn.relative_position_bias_table',
    'neck.fpn_convs.0.conv.weight',
    'rpn_head.rpn_conv.weight',
    'roi_head.bbox_head.fc_cls.weight',
    'roi_head.mask_head.convs.0.conv.weight',
)


def synthetic_train_batch(n=2, seed=0, canvas=(800, 1344)):
    """The keys of make_train_step's batch on the card: n synthetic
    800x1333 images (normalized, RGB, padded onto ``canvas``) whose 16
    painted rectangles are the ground truth -- boxes, bitmap masks and
    seeded labels."""
    imgs, rects = synthetic_images(n, seed=seed, with_boxes=True)
    h, w = imgs[0].shape[:2]
    rs = np.random.RandomState(seed + 100)
    img = np.zeros((n, *canvas, 3), np.float32)
    masks = np.zeros((n, 16, *canvas), np.uint8)
    for i, (raw, boxes) in enumerate(zip(imgs, rects)):
        img[i, :h, :w] = (raw[..., ::-1] - IMG_MEAN) / IMG_STD
        for j, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
            masks[i, j, y1:y2, x1:x2] = 1
    batch = dict(img=img, img_shapes=np.array([[h, w]] * n, np.int32),
                 pad_shapes=np.array([canvas] * n, np.int32),
                 gt_bboxes=np.stack(rects), gt_valid=np.ones((n, 16), bool),
                 gt_labels=rs.randint(0, 80, (n, 16)), gt_masks=masks)
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _check_log(log, what):
    bad = {k: v for k, v in log.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f'{what}: non-finite {bad}')


def _profile_steps(step, batch, gen, step_ms, phase, n=2):
    """Device time by kernel over ``n`` more steps (torch.profiler), per
    step, and the card's busy share of an unprofiled step (``step_ms``,
    the median of the timed steps), which it returns: the profiler slows
    the host, not the kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            _check_log(step(batch, gen), 'profiled step')
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(phase, f'profile: {busy:.1f} ms of kernel time per step, '
                 f'{len(rows)} kernels; against the {step_ms:.1f} ms '
                 f'median unprofiled step the card is busy '
                 f'{busy / step_ms:.3f} of the time')
    # one stream runs one kernel at a time: a share over 1 would mean
    # device time counted twice
    if busy > step_ms:
        raise AssertionError(f'profiled kernel time {busy:.1f} ms exceeds '
                             f'the {step_ms:.1f} ms step')
    ours = [r for r in rows if 'swindet' in r[0]]
    log(phase, f'  hand-written kernels: '
                 f'{sum(r[1] for r in ours):.1f} ms per step, of which the '
                 f'fused MLP\'s '
                 f'{sum(r[1] for r in ours if "mlp" in r[0]):.2f} ms')
    for key, ms, count in ours + [r for r in rows if r not in ours][:12]:
        log(phase, f'  {ms:9.3f} ms/step  {count:5d} launches/step  '
                     f'{key[:110]}')
    return busy / step_ms


@contextlib.contextmanager
def nms_without_host_reads():
    """Run the RPN's batched_nms (the NMS of the training step) under
    torch.cuda.set_sync_debug_mode('error'): a host read or a synchronising
    copy inside it raises. Yields the list of its calls."""
    batched_nms = rpn_head_module.batched_nms
    calls = []

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode('error')
        try:
            calls.append(batched_nms(*args, **kw))
        finally:
            torch.cuda.set_sync_debug_mode('default')
        return calls[-1]
    rpn_head_module.batched_nms = strict
    try:
        yield calls
    finally:
        rpn_head_module.batched_nms = batched_nms


def phase_train(phase='train', fused=False, v4=False):
    """Full-width Mask R-CNN Swin-T training steps in bf16 on the card."""
    cfg = Config.fromfile(CONFIG)
    model = init_detector(cfg, device='cuda', seed=0)
    opt = build_optimizer(model, dict(cfg.optimizer))
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH)
    step = make_train_step(model, opt, schedule,
                           dict(cfg.optimizer_config).get('grad_clip'))
    blocks, v4_blocks = _check_blocks(model, fused, v4)
    log(phase, f'{type(model).__name__} compute {model.dtype}, '
               f'drop_path_rate {cfg.model.backbone.drop_path_rate}, '
               f'{blocks} fused token MLPs, {v4_blocks} v4 attention blocks, '
               f'{cfg.optimizer["type"]} groups '
               f'{[(g["weight_decay"], len(g["params"])) for g in opt.param_groups]}')
    batch = synthetic_train_batch()
    gen = torch.Generator(device='cuda').manual_seed(0)
    before = [p.detach().clone() for p in model.parameters()]
    t0 = time.perf_counter()
    _check_log(step(batch, gen), 'warm-up step')
    torch.cuda.synchronize()
    log(phase, f'warm-up step {time.perf_counter() - t0:.3f} s')

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_log(out, 'timed step')
    steps = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(phase, 'per-step ms: ' + ', '.join(f'{t:.1f}' for t in times)
               + f'; peak memory {peak / 2 ** 30:.2f} GiB')
    log(phase, 'last step: ' + ', '.join(f'{k} {v:.4f}'
                                         for k, v in out.items()))
    log(phase, f'kernel launches over the 5 timed steps: {steps}')
    tc = _check_tc(phase, steps, True, _tc_kernels(fused, v4=v4))
    log(phase, f'of which tensor-core kernels: {tc}')
    # with a gradient wanted the attention forward is the softmax-saving
    # kernel, never the inference one, or in the v4 configuration the v4
    # forward and backward in place of all three; every other kernel of
    # the configuration runs
    v3_training = (window_attention_fwd_p, window_attention_bwd)
    idle = [fn.__name__ for fn in KERNEL_WRAPPERS
            if fn is not window_attention_v3 and fn not in OP_ONLY_KERNELS
            and steps[fn.__name__] == 0
            and (fused or fn not in FUSED_MLP_KERNELS)
            and (fn not in (v3_training if v4 else WATTN_V4_KERNELS))]
    if idle:
        raise AssertionError(f'kernels not launched in training: {idle}')
    # NMS once a step (the RPN proposals); the fused forward and backward
    # once per fused block; the attention forward and backward once per
    # Swin block
    attn = 0 if v4 else 60
    want = {'nms_sorted': 5, 'fused_mlp': 50 if fused else 0,
            'fused_mlp_bwd': 50 if fused else 0, 'window_attention_v3': 0,
            'window_attention_fwd_p': attn, 'window_attention_bwd': attn,
            'window_attention_v4': 60 - attn,
            'window_attention_v4_bwd': 60 - attn,
            'window_attention': 0, 'swin_window_attention': 0}
    got = {k: steps[k] for k in want}
    if got != want:
        raise AssertionError(f'launches {got}, expected {want}')
    still = sum(torch.equal(a, p.detach())
                for a, p in zip(before, model.parameters()))
    if still:
        raise AssertionError(f'{still} parameter tensors did not change')
    del before
    with nms_without_host_reads() as calls:
        _check_log(step(batch, gen), 'step without host reads in NMS')
    if len(calls) != 1:
        raise AssertionError(f'{len(calls)} NMS calls in a step')
    log(phase, "one more step with its NMS under torch.cuda."
               "set_sync_debug_mode('error'): no host read")
    # a validation pass of the trained model, counted on its own: eval
    # mode must go back to the inference kernels
    reset_launch_counts()
    with torch.inference_mode():
        model.eval()
        res = model.simple_test(batch['img'], batch['img_shapes'],
                                torch.ones((2, 4), device='cuda'))
        model.train()
    if not torch.isfinite(res['dets']).all():
        raise AssertionError('validation pass: non-finite detections')
    val = launch_counts()
    log(phase, f'kernel launches of one validation pass (simple_test on '
               f'the batch): {val}')
    wrong = [fn.__name__ for fn in _serving_kernels(v4)
             if val[fn.__name__] == 0] + [
        fn.__name__ for fn in NOT_SERVING if val[fn.__name__]]
    if wrong:
        raise AssertionError(f'validation pass: kernels idle or launched '
                             f'against their mode: {wrong}')
    _check_tc('validation pass', val, True,
              _tc_kernels(fused, False, v4))
    busy = _profile_steps(step, batch, gen, float(np.median(times)), phase)
    return steps, times, peak, busy, tc


# ------------------------------------------------------------- phase 7
def train_check_batch(b=2, h=224, w=320, g=4, seed=2):
    """Gt boxes at fractional coordinates with filled-ellipse masks, so no
    mask-target sample sits on the 0.5 threshold."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] + 0.5
    boxes = np.zeros((b, g, 4), np.float32)
    masks = np.zeros((b, g, h, w), np.uint8)
    for i in range(b):
        cx, cy = rs.uniform(0.2, 0.8, g) * w, rs.uniform(0.2, 0.8, g) * h
        bw, bh = rs.uniform(24, 120, g), rs.uniform(24, 100, g)
        boxes[i] = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                             cy + bh / 2], -1)
        for j in range(g):
            masks[i, j] = (((xx - cx[j]) / (bw[j] / 2)) ** 2
                           + ((yy - cy[j]) / (bh[j] / 2)) ** 2) <= 1
    return dict(img=rs.randn(b, h, w, 3).astype(np.float32),
                img_shapes=np.array([[h, w]] * b, np.int32),
                pad_shapes=np.array([[h, w]] * b, np.int32),
                gt_bboxes=boxes, gt_valid=np.ones((b, g), bool),
                gt_labels=rs.randint(0, 80, (b, g)), gt_masks=masks)


LOSS_PARTS = {'rpn': ('loss_rpn_cls', 'loss_rpn_bbox'),
              'bbox': ('loss_cls', 'loss_bbox'), 'mask': ('loss_mask',)}
# Limits of the fp32 card-vs-CPU training check, each between the sound
# run's reading and a bf16 control run's (H100, 224x320): the losses read
# at most 2.0e-7 relative (fp32 sums in another order; the forward kernels
# are deterministic), the control at least 2.0e-5. Gradients, as max |d|
# over the largest entry, for each group of loss terms on its own. The
# RPN group reads at most 2.4e-6 (control 3.2e-2 and up). The bbox and
# mask groups read up to 1.8e-3 (control 2.1e-2 and up): a few ReLU units
# of the RoI heads (2 of the bbox head's 2.1M, 60 of the mask head's 51M)
# sit within fp32 rounding of zero and pass their gradient on one side
# only, and every positive roi's units carry gradient. The RPN conv has 3
# such units too, but its losses send gradient only to the pixels of the
# 256 anchors sampled per image.
TOL_TRAIN_LOSS = 2e-6
TOL_TRAIN_GRAD = {'rpn': 1e-4, 'bbox': 6e-3, 'mask': 6e-3}


def _record(model):
    """Keep, to count where two runs of forward_train differ, the bbox
    labels and mask targets that the RoI head computes and which units
    each ReLU of the heads lets through: the RPN conv's, the bbox head's
    shared fcs' and the mask head's four convs'. Returns what it keeps and
    a function that undoes the recording."""
    seen = {k: [] for k in ('labels', 'mask_targets', 'relu_rpn',
                            'relu_bbox', 'relu_mask')}
    for key, head in (('labels', model.roi_head.bbox_head),
                      ('mask_targets', model.roi_head.mask_head)):
        def record(*args, _fn=head.get_targets, _key=key, **kw):
            out = _fn(*args, **kw)
            seen[_key].append((out[0] if isinstance(out, tuple) else out)
                              .detach().cpu())
            return out
        head.get_targets = record

    def keep(key):
        return lambda mod, args, out: seen[key].append(
            (out > 0).flatten().cpu())
    hooks = [m.register_forward_hook(keep('relu_bbox'))
             for m in model.roi_head.bbox_head.shared_fcs]
    hooks += [m.register_forward_hook(keep('relu_mask'))
              for m in model.roi_head.mask_head.convs]
    conv_nhwc = rpn_head_module.conv_nhwc

    def rpn_conv(x, conv, relu, *args):
        out = conv_nhwc(x, conv, relu, *args)
        if relu:
            seen['relu_rpn'].append((out > 0).flatten().cpu())
        return out
    rpn_head_module.conv_nhwc = rpn_conv

    def undo():
        for h in hooks:
            h.remove()
        rpn_head_module.conv_nhwc = conv_nhwc
        for head in (model.roi_head.bbox_head, model.roi_head.mask_head):
            del head.get_targets
    return seen, undo


def _train_grads(model, batch, keys, dev):
    """forward_train on ``dev``: its losses, the gradients of TRAIN_GRADS
    from each group of LOSS_PARTS on its own (zeros where a group does not
    reach a parameter), and what :func:`_record` keeps."""
    seen, undo = _record(model)
    model.train()
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    tk = {name: [tuple(torch.from_numpy(k).to(dev) for k in pair)
                 for pair in per_image] for name, per_image in keys.items()}
    try:
        losses = model.forward_train(
            tb['img'], tb['img_shapes'], tb['pad_shapes'], tb['gt_bboxes'],
            tb['gt_valid'], tb['gt_labels'], tb['gt_masks'],
            sampler_keys=tk)
    finally:
        undo()
    params = dict(model.named_parameters())
    ps = [params[n] for n in TRAIN_GRADS]
    grads = {}
    for i, (part, names) in enumerate(LOSS_PARTS.items()):
        gs = torch.autograd.grad(sum(losses[k] for k in names), ps,
                                 retain_graph=i + 1 < len(LOSS_PARTS),
                                 allow_unused=True)
        grads[part] = {n: (torch.zeros_like(p) if g is None else g)
                       .detach().cpu() for n, p, g in zip(TRAIN_GRADS, ps, gs)}
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            {k: torch.cat(v) for k, v in seen.items()})


def _train_errors(want, got):
    """Relative loss |d| per loss term; per part and parameter the
    gradient's max |d| over its largest entry (None where the part does
    not reach the parameter); and the targets and ReLU units that
    differ."""
    (l_w, g_w, t_w), (l_g, g_g, t_g) = want, got
    loss = {k: abs(l_g[k] - v) / max(abs(v), 1e-30) for k, v in l_w.items()}
    grad = {part: {n: None if not g_w[part][n].abs().max() else
                   ((g_g[part][n] - g_w[part][n]).abs().max()
                    / g_w[part][n].abs().max()).item()
                   for n in TRAIN_GRADS} for part in LOSS_PARTS}
    flips = {k: int((t_g[k] != t_w[k]).sum()) for k in t_w}
    return loss, grad, flips


def _log_errors(what, loss, grad, flips):
    log('train-check', f'{what}: relative loss |d| '
        + ', '.join(f'{k} {v:.3g}' for k, v in loss.items())
        + f'; targets and ReLU units that differ {flips}')
    for n in TRAIN_GRADS:
        log('train-check', f'  grad |d| / max {n}: ' + ', '.join(
            f'{part} ' + ('-' if grad[part][n] is None
                          else f'{grad[part][n]:.3g}') for part in LOSS_PARTS))


def _check_train(loss, grad, what):
    """The names of the readings over their limits (TOL_TRAIN_*)."""
    over = [k for k, v in loss.items() if not v <= TOL_TRAIN_LOSS]
    for part, errs in grad.items():
        over += [f'grad {n} of the {part} losses' for n, v in errs.items()
                 if v is not None and not v <= TOL_TRAIN_GRAD[part]]
    log('train-check', f'{what}: {len(over)} readings over their limits')
    return over


def phase_train_check(device: str = 'cuda', fused: bool = False,
                      v4: bool = False):
    """forward_train of the full-width detector in fp32 on a 224x320
    canvas, on the card (kernels) and on the CPU (plain versions): same
    seeded weights with rpn_cls and fc_cls scaled to std 1 (no top-k, NMS
    or IoU boundary within fp32 noise), same batch, same sampler keys,
    no stochastic depth. The losses and the listed gradients of each
    group of loss terms must agree within TOL_TRAIN_*. A control run of
    the same detector in bf16 on the card, held to the same CPU run, must
    exceed the loss limit and each group's gradient limit: the check
    tells a card run that lost precision from a sound one."""
    opts = {'bf16': False, 'model.backbone.drop_path_rate': 0.0}
    cpu = init_detector(CONFIG, device='cpu', cfg_options=opts, seed=1)
    with torch.no_grad():
        cpu.rpn_head.rpn_cls.weight.mul_(100.0)
        cpu.roi_head.bbox_head.fc_cls.weight.mul_(100.0)
    gpu = init_detector(CONFIG, device='cpu', cfg_options=opts, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(device)
    ctl = init_detector(CONFIG, device='cpu', seed=1, cfg_options={
        'model.backbone.drop_path_rate': 0.0})
    ctl.load_state_dict(cpu.state_dict())
    ctl = ctl.to(device)
    _check_blocks(gpu, fused, v4)
    _check_blocks(ctl, fused, v4)
    batch = train_check_batch()
    h, w = batch['img'].shape[1:3]
    n_rpn = 3 * sum(-(-h // s) * -(-w // s) for s in (4, 8, 16, 32, 64))
    n_rcnn = batch['gt_bboxes'].shape[1] + \
        cpu.cfg.model.train_cfg.rpn_proposal.max_per_img
    rs = np.random.RandomState(7)
    keys = {name: [tuple(rs.rand(n).astype(np.float32) for _ in range(2))
                   for _ in range(batch['img'].shape[0])]
            for name, n in (('rpn', n_rpn), ('rcnn', n_rcnn))}
    ref = _train_grads(cpu, batch, keys, 'cpu')
    reset_launch_counts()
    sound = _train_errors(ref, _train_grads(gpu, batch, keys, device))
    if device == 'cuda' and bool(window_attention_v4_bwd.launches) != v4:
        raise AssertionError(f'launches against the configuration: '
                             f'{launch_counts()}')
    if device == 'cuda':
        _check_tc('train-check', launch_counts(), False,
                  _tc_kernels(fused, v4=v4))
    _log_errors(f'{h}x{w} fp32 card vs CPU', *sound)
    control = _train_errors(ref, _train_grads(ctl, batch, keys, device))
    _log_errors(f'{h}x{w} control, bf16 card vs fp32 CPU', *control)
    for name in TRAIN_GRADS:
        if all(sound[1][part][name] is None for part in LOSS_PARTS):
            raise AssertionError(f'grad {name}: zero on the CPU')
    over = _check_train(*sound[:2], 'fp32 card vs CPU')
    if over:
        raise AssertionError(f'card vs CPU over the limits: {over}')
    over = _check_train(*control[:2], 'control')
    missed = [part for part in LOSS_PARTS
              if not any(f'of the {part} losses' in o for o in over)]
    if missed or not any(k in over for k in control[0] if 'loss' in k):
        raise AssertionError(f'the bf16 control passes the loss limit or '
                             f'the gradient limit of {missed}')


def _run_config(name, **flags):
    """Phases 4-7 in one configuration: serving launches and request
    latencies, training launches, step times, peak memory and busy
    share."""
    phase = '' if not flags else f'{name}-'
    serve, lat, serve_tc = phase_main(f'{phase}main', **flags)
    phase_check(phase=f'{phase}check', **flags)
    train, times, peak, busy, train_tc = phase_train(f'{phase}train',
                                                     **flags)
    phase_train_check(**flags)
    return dict(serve=serve, lat=lat, train=train, times=times, peak=peak,
                busy=busy, serve_tc=serve_tc, train_tc=train_tc)


# phase 3's further readings of a kernel's main row that the JSON line
# carries: the kernel's own device ms (rows 1, 14 and 15), row 14's
# head-major copy, row 1's first kernel off the vector path, and row 15's
# yardsticks' device ms and its blockwise path's ms
PHASE3_EXTRAS = ('device_ms', 'copy_device_ms', 'first_kernel',
                 'unfused_device_ms', 'blockwise_ms', 'blockwise_device_ms')


def main() -> int:
    # the default configuration is the config as it stands
    os.environ.pop('SWINDET_FUSED_MLP', None)
    os.environ.pop('SWINDET_WATTN_V4', None)
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    runs = {'default': _run_config('default')}
    for key, name, switch, flag in (
            ('fused', 'fused', 'SWINDET_FUSED_MLP', 'fused'),
            ('wattn_v4', 'wattn-v4', 'SWINDET_WATTN_V4', 'v4')):
        log(name, f'phases 4-7 again with {switch}=1')
        with env_switch(switch):
            runs[key] = _run_config(name, **{flag: True})
    for what, key, fmt in (('request latency (s)', 'lat', '.4f'),
                           ('training step (ms)', 'times', '.1f')):
        log('configs', f'{what}, median of the timed runs: ' + ', '.join(
            f'{c} {np.median(r[key]):{fmt}}' for c, r in runs.items()))
    log('configs', 'training peak memory (GiB): ' + ', '.join(
        f'{c} {r["peak"] / 2 ** 30:.2f}' for c, r in runs.items()))
    log('configs', 'training busy share: ' + ', '.join(
        f'{c} {r["busy"]:.3f}' for c, r in runs.items()))
    rows = []
    for fn in KERNEL_WRAPPERS:
        name = fn.__name__
        # NMS takes fp32 boxes in both configurations
        fp32 = kernels[name][torch.float32]
        main_row = kernels[name].get(torch.bfloat16, fp32)
        counts, tc = {}, {}
        for c, r in runs.items():
            pre = '' if c == 'default' else f'{c}_'
            counts[f'{pre}serve_launches'] = r['serve'][name]
            counts[f'{pre}train_launches'] = r['train'][name]
            if fn in TENSOR_CORE_KERNELS:
                tc[f'{pre}serve_tc_launches'] = r['serve_tc'][name]
                tc[f'{pre}train_tc_launches'] = r['train_tc'][name]
        if tc:
            tc = dict(tc_launches=sum(tc.values()), **tc)
        if 'shapes' in main_row:
            # the bf16 rows (NMS: fp32): every shape of the main path
            tc['shapes'] = main_row['shapes']
        rows.append(dict(
            name=name, route='cuda', **KERNELS[name],
            launches=sum(counts.values()), **counts, **tc,
            dtype='float32' if main_row is fp32 else 'bfloat16',
            shape=main_row['shape'], max_abs_err=main_row['max_abs_err'],
            ms=main_row['ms'], plain_ms=main_row['plain_ms'],
            bound_ms=main_row['bound_ms'], bound_by=main_row['bound_by'],
            library_ms=main_row['library_ms'],
            unfused_ms=main_row.get('unfused_ms'),
            fp32_max_abs_err=fp32['max_abs_err'], fp32_ms=fp32['ms'],
            fp32_plain_ms=fp32['plain_ms'],
            fp32_library_ms=fp32['library_ms'],
            **{k: main_row[k] for k in PHASE3_EXTRAS if k in main_row}))
    print(json.dumps({'kernels': rows}), flush=True)
    print(smi, flush=True)
    # the run uses one card, cuda:0, whatever the host exposes
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': 1}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
