"""Optimizer construction from config (counterpart of
``swindet_tpu/engine/optimizer.py``: ``build_multiplier_trees`` :39,
``build_optimizer`` :120; the clip ``clip_by_global_norm_torch`` :71
reproduces ``torch.nn.utils.clip_grad_norm_``, which the training step
calls; reference mmcv DefaultOptimizerConstructor and the Swin configs'
``paramwise_cfg``).

Parameters with the same (``decay_mult``, ``lr_mult``) share one AdamW
or SGD parameter group, which carries the weight decay times
``decay_mult`` and the ``lr_mult``; the learning-rate schedule writes
``lr = schedule(step) * lr_mult`` into every group before each step
(:func:`set_lr`). Per parameter this is the update of mmcv's one group
per parameter, with two groups for the Swin configs instead of hundreds.
SGD is the JAX package's chain (:155-163): the decay added to the
gradient before the momentum trace, no dampening, ``nesterov`` from the
config; ``torch.optim.SGD`` computes the same.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def multipliers(name: str, paramwise_cfg: Optional[dict]
                ) -> Tuple[float, float]:
    """(decay_mult, lr_mult) of a parameter name: the longest
    ``custom_keys`` key contained in the name wins, ties alphabetical;
    (1, 1) when none matches."""
    custom_keys = dict((paramwise_cfg or {}).get('custom_keys', {}))
    for key in sorted(sorted(custom_keys), key=len, reverse=True):
        if key in name:
            c = custom_keys[key]
            return (float(c.get('decay_mult', 1.0)),
                    float(c.get('lr_mult', 1.0)))
    return 1.0, 1.0


def param_multipliers(model: torch.nn.Module, paramwise_cfg: Optional[dict]
                      ) -> Dict[str, Tuple[float, float]]:
    """name -> (decay_mult, lr_mult) over ``model.named_parameters()``."""
    return {name: multipliers(name, paramwise_cfg)
            for name, p in model.named_parameters() if p.requires_grad}


def build_optimizer(model: torch.nn.Module,
                    optimizer_cfg: dict) -> torch.optim.Optimizer:
    """cfg like ``dict(type='AdamW', lr=1e-4, betas=(0.9, 0.999),
    weight_decay=0.05, paramwise_cfg=...)`` or ``dict(type='SGD', lr=0.02,
    momentum=0.9, weight_decay=1e-4)`` -> ``torch.optim.AdamW`` or
    ``torch.optim.SGD`` with one group per (decay_mult, lr_mult), which
    keeps its ``lr_mult`` and the names of its parameters."""
    cfg = dict(optimizer_cfg)
    if cfg.get('type') not in ('AdamW', 'SGD'):
        raise NotImplementedError(f'build_optimizer: {cfg.get("type")} is '
                                  f'not ported (AdamW and SGD are)')
    base_lr = float(cfg['lr'])
    wd = float(cfg.get('weight_decay', 0.0))
    params = dict(model.named_parameters())
    groups: Dict[Tuple[float, float], dict] = {}
    for name, (dm, lm) in param_multipliers(
            model, cfg.get('paramwise_cfg')).items():
        group = groups.setdefault((dm, lm), dict(
            params=[], names=[], lr=base_lr * lm, weight_decay=wd * dm,
            lr_mult=lm))
        group['params'].append(params[name])
        group['names'].append(name)
    if cfg['type'] == 'SGD':
        return torch.optim.SGD(list(groups.values()), lr=base_lr,
                               momentum=float(cfg.get('momentum', 0.0)),
                               nesterov=bool(cfg.get('nesterov', False)),
                               weight_decay=wd)
    return torch.optim.AdamW(list(groups.values()), lr=base_lr,
                             betas=tuple(cfg.get('betas', (0.9, 0.999))),
                             eps=cfg.get('eps', 1e-8), weight_decay=wd)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write the schedule's lr times each group's ``lr_mult``."""
    for g in optimizer.param_groups:
        g['lr'] = lr * g.get('lr_mult', 1.0)
