"""Learning-rate schedules from ``lr_config`` (counterpart of
``swindet_tpu/engine/schedules.py:16``; reference mmcv LrUpdaterHook):
step, cosine or fixed policies with linear, constant or exponential
warm-up, as plain functions of the iteration."""
from __future__ import annotations

import math
from typing import Callable


def build_lr_schedule(lr_config: dict, base_lr: float,
                      iters_per_epoch: int) -> Callable[[int], float]:
    """``lr_config`` like ``dict(policy='step', warmup='linear',
    warmup_iters=500, warmup_ratio=0.001, step=[8, 11])`` (epochs, or
    iterations with ``by_epoch=False``) -> iteration -> lr."""
    cfg = dict(lr_config)
    policy = cfg.get('policy', 'step')
    warmup = cfg.get('warmup')
    warmup_iters = int(cfg.get('warmup_iters', 500))
    warmup_ratio = float(cfg.get('warmup_ratio', 0.1))
    by_epoch = cfg.get('by_epoch', True)

    if policy == 'step':
        steps = cfg['step']
        steps = [steps] if isinstance(steps, int) else list(steps)
        gamma = float(cfg.get('gamma', 0.1))
        bounds = [s * iters_per_epoch if by_epoch else s for s in steps]

        def regular(step):
            return base_lr * gamma ** sum(step >= b for b in bounds)
    elif policy in ('cosine', 'CosineAnnealing'):
        max_iters = int(cfg['max_iters'])
        min_lr = float(cfg.get('min_lr', 0.0))

        def regular(step):
            t = min(max(step / max_iters, 0.0), 1.0)
            return min_lr + (base_lr - min_lr) * 0.5 * (
                1 + math.cos(math.pi * t))
    elif policy == 'fixed':
        def regular(step):
            return base_lr
    else:
        raise KeyError(f'Unsupported lr policy {policy}')

    if warmup is None:
        return regular
    if warmup not in ('linear', 'constant', 'exp'):
        raise KeyError(f'Unsupported warmup {warmup}')

    def schedule(step):
        reg = regular(step)
        if step >= warmup_iters:
            return reg
        frac = min(max(step / warmup_iters, 0.0), 1.0)
        if warmup == 'linear':
            return reg * (warmup_ratio + (1.0 - warmup_ratio) * frac)
        if warmup == 'constant':
            return reg * warmup_ratio
        return reg * warmup_ratio ** (1.0 - frac)

    return schedule
