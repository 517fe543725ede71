"""Greedy NMS over boxes already sorted by score.

Counterpart of ``swindet_tpu/ops/nms_pallas.py``. :func:`nms_sorted` runs
the hand-written kernel (``csrc/nms.cu``, replacing the Pallas ``_kernel``)
on a CUDA tensor and the plain version :func:`nms_sorted_reference` on a
CPU tensor. It takes the contract of ``nms_pallas_sorted`` (:137) with a
leading batch axis: score-sorted boxes, scores, validity and the sort
order; it returns the kept boxes with their scores in score order, their
indices into the unsorted inputs and the number kept, all on the device.
Keep set and order are those of ``swindet_tpu/core/nms.py:nms``: a box is
kept if it is valid and no kept box before it overlaps it by IoU over the
threshold, until ``max_out`` are kept.

The plain version resolves the greedy scan without a host round trip per
box: the IoU-over-threshold matrix of the sorted candidates is built
once, and the keep mask is the fixpoint of
``alive = init & ~any_j(alive[j] & over[j, i], j < i)``, reached by Jacobi
sweeps (a matrix-vector product each) in as many sweeps as the longest
chain of suppressions; the host reads one flag per burst of sweeps to see
whether the fixpoint is reached. The kernels read nothing on the host: an
over-threshold bitmask over the card, then a scan of one step per 64-box
block (``csrc/nms.cu``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
# Jacobi sweeps between two host checks for the fixpoint
SWEEPS_PER_CHECK = 16
# the scan keeps one bit per candidate in 48 KB of shared memory (its
# other buffers, about 1.3 KB, come on top)
MAX_CANDIDATES = 48 * 1024 * 8


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (..., K, 4) -> (..., M, K) IoU; degenerate boxes 0."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) \
        * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) \
        * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-10)


def greedy_keep(over: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """Keep mask of greedy NMS in sorted order. over (B, N, N) bool, true
    where box j may suppress box i (j < i and IoU over threshold); init
    (B, N) the candidates. Returns (B, N) bool."""
    n = init.shape[-1]
    over_f = over.float()
    alive = init
    for start in range(0, n + 1, SWEEPS_PER_CHECK):
        for _ in range(SWEEPS_PER_CHECK):
            prev = alive
            hit = torch.bmm(alive.float()[:, None, :], over_f)[:, 0] > 0
            alive = init & ~hit
        if torch.equal(alive, prev):
            break
    return alive


def nms_sorted_reference(boxes_s: torch.Tensor, score_s: torch.Tensor,
                         valid_s: torch.Tensor, order: torch.Tensor,
                         iou_threshold: float, max_out: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the IoU matrix, the fixpoint of the greedy scan and
    a compaction of the kept slots to the front."""
    b, n = score_s.shape
    dev = score_s.device
    ar = torch.arange(n, device=dev)
    over = (pairwise_iou(boxes_s, boxes_s) > iou_threshold) \
        & (ar[:, None] < ar[None, :])
    keep = greedy_keep(over, valid_s)

    # kept slots first, in score order
    pos = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    if n >= max_out:
        pos = pos[:, :max_out]
    else:
        pos = torch.cat([pos, pos.new_zeros((b, max_out - n))], dim=1)
    count = keep.sum(1).clamp(max=max_out)
    out_valid = torch.arange(max_out, device=dev)[None] < count[:, None]
    kept_boxes = torch.gather(boxes_s, 1, pos[..., None].expand(-1, -1, 4))
    kept_scores = torch.gather(score_s, 1, pos)
    dets = torch.cat([kept_boxes, kept_scores[..., None]], dim=-1)
    dets = torch.where(out_valid[..., None], dets, 0.0)
    inds = torch.where(out_valid, torch.gather(order, 1, pos), 0)
    return dets, inds, count


def nms_sorted(boxes_s: torch.Tensor, score_s: torch.Tensor,
               valid_s: torch.Tensor, order: torch.Tensor,
               iou_threshold: float, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS of score-sorted boxes_s (B, N, 4) fp32 with score_s
    (B, N) fp32, valid_s (B, N) bool and order (B, N) int64, the sort's
    permutation. Returns dets (B, max_out, 5) fp32 (x1, y1, x2, y2,
    score), inds (B, max_out) int64 into the unsorted inputs and count
    (B,) int64; slots past the count are zero."""
    if boxes_s.device.type == 'cpu':
        return nms_sorted_reference(boxes_s, score_s, valid_s, order,
                                    iou_threshold, max_out)
    if boxes_s.device.type != 'cuda':
        raise ValueError(f'nms_sorted: unsupported device {boxes_s.device}')
    b, n = score_s.shape
    for name, t, dtype, shape in (
            ('boxes_s', boxes_s, torch.float32, (b, n, 4)),
            ('score_s', score_s, torch.float32, (b, n)),
            ('valid_s', valid_s, torch.bool, (b, n)),
            ('order', order, torch.int64, (b, n))):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != boxes_s.device or not t.is_contiguous():
            raise ValueError(f'nms_sorted: {name} must be a contiguous '
                             f'{dtype} {shape} tensor on {boxes_s.device}')
    if n > MAX_CANDIDATES:
        raise ValueError(f'nms_sorted: {n} candidates, over '
                         f'{MAX_CANDIDATES}')
    if boxes_s.data_ptr() % 16:
        raise ValueError('nms_sorted: the kernels read a box in one 16-byte '
                         'load: boxes_s must start on a 16-byte boundary')
    dev = boxes_s.device
    words = -(-n // 64)
    # the over-threshold bitmask, and in row n each 64-box block's word of
    # invalid boxes
    mask = torch.empty((b, n + 1, words), dtype=torch.int64, device=dev)
    dets = torch.empty((b, max_out, 5), dtype=torch.float32, device=dev)
    inds = torch.empty((b, max_out), dtype=torch.int64, device=dev)
    count = torch.empty((b,), dtype=torch.int64, device=dev)
    fn = build.bind('nms', 'swindet_nms_sorted', _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(boxes_s.data_ptr(), score_s.data_ptr(),
                    valid_s.data_ptr(), order.data_ptr(), mask.data_ptr(),
                    dets.data_ptr(), inds.data_ptr(), count.data_ptr(), b, n,
                    max_out, iou_threshold, build.stream_ptr(dev))
    build.check_launch('nms_sorted', status)
    nms_sorted.launches += 1
    return dets, inds, count


nms_sorted.launches = 0
