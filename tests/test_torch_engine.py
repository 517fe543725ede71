"""The port's optimizer and learning-rate schedule against the JAX
package's (``swindet_tpu/engine/optimizer.py``, ``schedules.py``):

- a 10-step AdamW trajectory on a toy parameter set in fp64, with the same
  gradients on both sides, through linear warm-up, a step decay, a
  ``decay_mult=0`` key, an ``lr_mult`` key and the torch-exact gradient
  clip, to rel < 1e-6 after every step (as
  tests/test_engine/test_optim_trajectory_parity.py does against torch);
- the decay / lr partition over the full Swin-T Mask R-CNN
  ``named_parameters()`` against ``build_multiplier_trees`` over the JAX
  parameter tree.
"""
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from swindet_tpu.checkpoint import _flatten, flax_path_to_torch_key
from swindet_tpu.engine.optimizer import (build_multiplier_trees,
                                          build_optimizer as jax_build_opt)
from swindet_tpu.engine.schedules import build_lr_schedule as jax_schedule
from swindet_tpu.models import build_detector as jax_build_detector

from swindet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                      param_multipliers)
from swindet_tpu_torch.engine.optimizer import set_lr
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, 'configs/swin/mask_rcnn_swin_tiny_patch4_'
                        'window7_mstrain_480-800_adamw_1x_coco.py')
CUSTOM_KEYS = {
    'relative_position_bias_table': dict(decay_mult=0.),
    'norm': dict(decay_mult=0.),
    'rpn_head': dict(lr_mult=2.0),
}
NAMES = {
    'backbone.layers.0.blocks.0.mlp.fc1.weight': (6, 4),
    'backbone.layers.0.blocks.0.norm1.weight': (5,),
    'backbone.layers.0.blocks.0.attn.relative_position_bias_table': (7, 2),
    'rpn_head.rpn_conv.bias': (3,),
}
LR_CONFIG = dict(policy='step', warmup='linear', warmup_iters=4,
                 warmup_ratio=0.001, step=[2], gamma=0.1)


def _flax_tree(values):
    """torch names -> a nested dict whose flax paths map back to them
    (``flax_path_to_torch_key``): 'layers', '0' -> 'layers0', a norm's
    'weight' -> 'scale', any other 'weight' -> 'kernel'."""
    tree = {}
    for name, v in values.items():
        parts = name.split('.')
        path, i = [], 0
        while i < len(parts) - 1:
            if i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
                path.append(parts[i] + parts[i + 1])
                i += 2
            else:
                path.append(parts[i])
                i += 1
        leaf = parts[-1]
        if leaf == 'weight':
            leaf = 'scale' if 'norm' in path[-1] else 'kernel'
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _by_name(tree):
    return {flax_path_to_torch_key(p): np.asarray(v)
            for p, v in _flatten(tree).items()}


@pytest.mark.parametrize('max_norm', [None, 1e-2, 1e6])
def test_adamw_trajectory_matches_jax(max_norm):
    rs = np.random.RandomState(0)
    values = {n: rs.randn(*s) for n, s in NAMES.items()}
    grads = [{n: rs.randn(*s) * 3.0 for n, s in NAMES.items()}
             for _ in range(10)]
    grads[3] = {n: np.zeros(s) for n, s in NAMES.items()}   # wd alone
    base_lr, wd, iters_per_epoch = 1e-2, 0.05, 3
    opt_cfg = dict(type='AdamW', lr=base_lr, betas=(0.9, 0.999),
                   weight_decay=wd,
                   paramwise_cfg=dict(custom_keys=CUSTOM_KEYS))
    clip = None if max_norm is None else dict(max_norm=max_norm)

    model = torch.nn.Module()
    params = torch.nn.ParameterDict()
    for n, v in values.items():
        params[n.replace('.', '__')] = torch.nn.Parameter(
            torch.tensor(v, dtype=torch.float64))
    model.named_parameters = lambda: [
        (k.replace('__', '.'), p) for k, p in params.items()]
    opt = build_optimizer(model, opt_cfg)
    schedule = build_lr_schedule(LR_CONFIG, base_lr, iters_per_epoch)

    with jax.enable_x64():
        tree = _flax_tree(values)
        tx = jax_build_opt(tree, copy.deepcopy(opt_cfg),
                           jax_schedule(LR_CONFIG, base_lr, iters_per_epoch),
                           grad_clip=clip)
        state = tx.init(tree)
        for t in range(10):
            for name, p in model.named_parameters():
                p.grad = torch.tensor(grads[t][name])
            set_lr(opt, schedule(t))
            if max_norm is not None:
                torch.nn.utils.clip_grad_norm_(
                    [p for _, p in model.named_parameters()], max_norm)
            opt.step()
            updates, state = tx.update(_flax_tree(grads[t]), state, tree)
            tree = optax.apply_updates(tree, updates)
            want = _by_name(tree)
            for name, p in model.named_parameters():
                got = p.detach().numpy()
                scale = max(np.abs(want[name]).max(), 1e-12)
                err = np.abs(got - want[name]).max() / scale
                assert err < 1e-6, f'step {t} {name}: rel err {err:.2e}'
    moved = {n: np.abs(p.detach().numpy() - values[n]).max()
             for n, p in model.named_parameters()}
    assert min(moved.values()) > 1e-4


def test_lr_schedule_matches_jax():
    """The JAX schedule computes in fp32 (its cosine too) and the port's
    in Python floats, hence rel 1e-5."""
    cfgs = [dict(LR_CONFIG), dict(LR_CONFIG, warmup='constant'),
            dict(LR_CONFIG, warmup='exp'), dict(LR_CONFIG, warmup=None),
            dict(policy='cosine', max_iters=20, min_lr=1e-5,
                 warmup='linear', warmup_iters=3, warmup_ratio=0.1)]
    for cfg in cfgs:
        ours = build_lr_schedule(cfg, 0.02, 3)
        theirs = jax_schedule(cfg, 0.02, 3)
        for t in range(25):
            np.testing.assert_allclose(ours(t), float(theirs(t)), rtol=1e-5,
                                       err_msg=f'{cfg} step {t}')


def test_flagship_decay_partition_matches_jax():
    cfg = Config.fromfile(FLAGSHIP)
    paramwise = dict(custom_keys={k: dict(v) for k, v in
                                  cfg.optimizer['paramwise_cfg']
                                  ['custom_keys'].items()})
    model_cfg = dict(cfg.model)
    model_cfg.pop('pretrained', None)
    port = build_detector(copy.deepcopy(model_cfg))
    ours = param_multipliers(port, paramwise)

    module = jax_build_detector(copy.deepcopy(model_cfg))
    shapes = jax.eval_shape(
        lambda d: module.init({'params': jax.random.PRNGKey(0)}, d,
                              method='forward_dummy'),
        jnp.zeros((1, 64, 64, 3), jnp.float32))['params']
    decay, lr = build_multiplier_trees(shapes, paramwise)
    theirs = {flax_path_to_torch_key(p): (float(d), float(l))
              for (p, d), l in zip(_flatten(decay).items(),
                                   _flatten(lr).values())}
    assert ours == theirs
    assert sum(dm == 0.0 for dm, _ in ours.values()) > 50
    opt = build_optimizer(port, dict(cfg.optimizer))
    assert sorted(g['weight_decay'] for g in opt.param_groups) == [0.0, 0.05]
    assert sum(len(g['params']) for g in opt.param_groups) == len(ours)
