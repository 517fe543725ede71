"""The training step (counterpart of ``swindet_tpu/engine/train_step.py``:
``parse_losses`` :45, ``make_train_step`` :60; reference
mmdet/models/detectors/base.py:185,220).

One step: set the schedule's learning rate, ``forward_train``, sum the
loss terms, backward, optional torch-exact gradient clipping, optimizer
step. A parameter the loss does not reach (a frozen ResNet stage's) gets
a zero gradient before the step, as every leaf of the JAX package's
gradient tree has one: weight decay and momentum then move it as they
move it there, where ``torch.optim`` would skip it. Counts and averaging
factors stay tensors through the step; the log values are read back to
the host once, at its end.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .optimizer import set_lr


def parse_losses(losses: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum every key containing 'loss' into the total; (total, log_vars)
    with each term summed to an fp32 scalar and 'loss' the total."""
    log_vars = {}
    total = None
    for name, value in losses.items():
        value = value.float().sum()
        log_vars[name] = value
        if 'loss' in name:
            total = value if total is None else total + value
    log_vars['loss'] = total
    return total, log_vars


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float],
                    grad_clip: Optional[dict] = None,
                    start_iter: int = 0) -> Callable:
    """Build ``step(batch, gen, sampler_keys=None) -> log_vars``.

    ``batch`` holds img, img_shapes, pad_shapes, gt_bboxes, gt_valid,
    gt_labels and gt_masks (and, for HTC's semantic branch,
    gt_semantic_seg), statically shaped and on the model's device;
    ``gen`` is a ``torch.Generator`` on that device for stochastic depth
    and sampling; ``sampler_keys`` injects the samplers' keys (see
    ``TwoStageDetector.forward_train``). ``log_vars`` maps 'loss', each
    loss term and 'grad_norm' (the global norm before clipping) to
    floats. The model is put in training mode. ``start_iter`` is the
    schedule's iteration at the first step (a resumed run's)."""
    model.train()
    params = [p for p in model.parameters() if p.requires_grad]
    max_norm = None
    if grad_clip:
        if int(grad_clip.get('norm_type', 2)) != 2:
            raise ValueError('only norm_type=2 grad clipping is supported')
        max_norm = float(grad_clip['max_norm'])
    iteration = [start_iter]

    def step(batch: Dict[str, torch.Tensor], gen: torch.Generator,
             sampler_keys: Optional[Dict[str, Sequence]] = None
             ) -> Dict[str, float]:
        set_lr(optimizer, schedule(iteration[0]))
        optimizer.zero_grad(set_to_none=True)
        seg = {} if 'gt_semantic_seg' not in batch \
            else dict(gt_semantic_seg=batch['gt_semantic_seg'])
        losses = model.forward_train(
            batch['img'], batch['img_shapes'], batch['pad_shapes'],
            batch['gt_bboxes'], batch['gt_valid'], batch['gt_labels'],
            batch.get('gt_masks'), gen=gen, sampler_keys=sampler_keys,
            **seg)
        total, log_vars = parse_losses(losses)
        total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if max_norm is None:
            log_vars['grad_norm'] = torch.nn.utils.get_total_norm(
                [p.grad for p in params if p.grad is not None])
        else:
            log_vars['grad_norm'] = torch.nn.utils.clip_grad_norm_(
                params, max_norm)
        optimizer.step()
        iteration[0] += 1
        names = list(log_vars)
        values = torch.stack([log_vars[k].detach().float().to(
            total.device) for k in names]).tolist()
        return dict(zip(names, values))

    return step
