"""The port's training slice as a whole: ``forward_train`` of the tiny
Mask R-CNN against the JAX package's on the same numpy weights, batch and
sampler keys (fp32, CPU), its losses and the gradients of a fixed list of
parameters, then one ``make_train_step`` step. The comparison runs three
times: as configured, with the JAX package's fused-MLP switch
``SWINDET_FUSED_MLP=1`` set on both sides, and with its v4 window-attention
switch ``SWINDET_WATTN_V4=1`` set on both sides.

Sampler keys: the JAX samplers draw from a JAX PRNG and the port's from a
``torch.Generator``, which give different numbers, so both sides get the
same key arrays: on the JAX side ``RandomSampler._pos_keys`` /
``_neg_keys`` are patched (monkeypatch, no file changes) to return them,
on the port's side they go in through ``sampler_keys``. The JAX sampler's
extra pack noise (samplers.py:151) orders the slots only; every loss is a
sum or a masked mean over slots, so it does not move the losses.

Tolerances: losses at rel 1e-4 and gradients at rel 1e-3 of each
tensor's largest entry; the two frameworks sum in different orders, and
the gradients pass through more of them.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.core.bbox.samplers import RandomSampler as JaxSampler
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from tests.test_models.test_forward import tiny_maskrcnn_cfg
from tests.test_torch_checkpoint import jax_detector_params

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                      make_train_step)
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.layers import Mlp

H, W = 64, 96
GRAD_PARAMS = (
    'backbone.patch_embed.proj.weight',
    'backbone.layers.0.blocks.0.attn.qkv.weight',
    'backbone.layers.0.blocks.0.attn.relative_position_bias_table',
    'neck.fpn_convs.0.conv.weight',
    'rpn_head.rpn_conv.weight',
    'roi_head.bbox_head.fc_cls.weight',
    'roi_head.mask_head.convs.0.conv.weight',
)
# and the fused MLP's parameters, whose gradients come from its backward
FUSED_MLP_GRAD_PARAMS = (
    'backbone.layers.0.blocks.0.mlp.fc1.weight',
    'backbone.layers.0.blocks.0.mlp.fc1.bias',
    'backbone.layers.3.blocks.0.mlp.fc2.weight',
    'backbone.layers.3.blocks.0.mlp.fc2.bias',
)


# and the v4 attention's parameters, whose gradients come from its backward
WATTN_V4_GRAD_PARAMS = (
    'backbone.layers.0.blocks.0.attn.qkv.bias',
    'backbone.layers.1.blocks.0.attn.proj.weight',
    'backbone.layers.3.blocks.0.attn.proj.bias',
    'backbone.layers.3.blocks.0.attn.relative_position_bias_table',
)


def make_batch(seed=0, b=2, g=3, num_classes=4):
    """Gt boxes at fractional coordinates and filled-ellipse masks, so no
    mask-target sample sits exactly on the 0.5 threshold."""
    rs = np.random.RandomState(seed)
    img = rs.randn(b, H, W, 3).astype(np.float32)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    labels = np.zeros((b, g), np.int32)
    masks = np.zeros((b, g, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W] + 0.5
    for i in range(b):
        n = g - i
        cx = rs.uniform(0.25, 0.75, n) * W
        cy = rs.uniform(0.25, 0.75, n) * H
        bw = rs.uniform(16, 40, n)
        bh = rs.uniform(12, 32, n)
        boxes[i, :n] = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                 cy + bh / 2], -1)
        valid[i, :n] = True
        labels[i, :n] = rs.randint(0, num_classes, n)
        for j in range(n):
            masks[i, j] = (((xx - cx[j]) / (bw[j] / 2)) ** 2
                           + ((yy - cy[j]) / (bh[j] / 2)) ** 2) <= 1.0
    shapes = np.array([[H, W]] * b, np.int32)
    return dict(img=img, img_shapes=shapes, pad_shapes=shapes.copy(),
                gt_bboxes=boxes, gt_valid=valid, gt_labels=labels,
                gt_masks=masks)


def sampler_keys(n_rpn, n_rcnn, seed=5):
    rs = np.random.RandomState(seed)
    return {n: (rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32))
            for n in (n_rpn, n_rcnn)}


def _slice_run():
    """Both sides' losses and gradients of forward_train, each model built
    (and the JAX side traced) under the environment of the caller."""
    cfg = tiny_maskrcnn_cfg()
    jm, params = jax_detector_params(cfg, seed=0)
    batch = make_batch()
    n_rpn = 3 * sum((H // s + (H % s > 0)) * (W // s + (W % s > 0))
                    for s in (4, 8, 16, 32, 64))
    n_rcnn = 3 + cfg['train_cfg']['rpn_proposal']['max_per_img']
    keys = sampler_keys(n_rpn, n_rcnn)

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxSampler, '_pos_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][0]))
    mp.setattr(JaxSampler, '_neg_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][1]))
    try:
        args = [jnp.asarray(batch[k]) for k in (
            'img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
            'gt_labels', 'gt_masks')]

        def total(p):
            losses = jm.apply({'params': p}, *args, method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(1),
                                    'dropout': jax.random.PRNGKey(2)})
            return jax_parse_losses(losses)

        (_, want), grads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(params)
    finally:
        mp.undo()
    want = {k: float(v) for k, v in want.items()}
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, grads))

    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    port.train()
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    tkeys = {name: [tuple(torch.from_numpy(k) for k in keys[n])] * 2
             for name, n in (('rpn', n_rpn), ('rcnn', n_rcnn))}
    losses = port.forward_train(
        tb['img'], tb['img_shapes'], tb['pad_shapes'], tb['gt_bboxes'],
        tb['gt_valid'], tb['gt_labels'], tb['gt_masks'], sampler_keys=tkeys)
    total_loss = sum(v for k, v in losses.items() if 'loss' in k)
    total_loss.backward()
    got_grads = dict(port.named_parameters())
    return dict(cfg=cfg, port=port, batch=tb, keys=tkeys, want=want,
                got={k: float(v.detach()) for k, v in losses.items()},
                want_grads=want_grads, got_grads=got_grads)


@pytest.fixture(scope='module')
def slice_run():
    mp = pytest.MonkeyPatch()
    mp.delenv('SWINDET_FUSED_MLP', raising=False)
    mp.delenv('SWINDET_WATTN_V4', raising=False)
    try:
        return _slice_run()
    finally:
        mp.undo()


@pytest.fixture(scope='module')
def fused_slice_run():
    """The same with the JAX package's switch SWINDET_FUSED_MLP=1 on both
    sides: every Swin block's MLP goes through the fused op (the port's
    autograd Function and the plain backward kernel version; the JAX
    package's fused reference path, traced afresh)."""
    mp = pytest.MonkeyPatch()
    mp.setenv('SWINDET_FUSED_MLP', '1')
    mp.delenv('SWINDET_WATTN_V4', raising=False)
    try:
        run = _slice_run()
    finally:
        mp.undo()
    mlps = [m for m in run['port'].modules() if isinstance(m, Mlp)]
    assert len(mlps) == 4 and all(m.fused for m in mlps)
    return run


@pytest.fixture(scope='module')
def wattn_v4_slice_run():
    """The same with the JAX package's switch SWINDET_WATTN_V4=1 on both
    sides: every Swin block's qkv projection, attention and output
    projection go through the v4 op (the port's autograd Function and the
    plain version of the backward kernels; the JAX package's v4 reference
    path, traced afresh)."""
    from swindet_tpu_torch.models.backbones.swin import WindowAttention
    mp = pytest.MonkeyPatch()
    mp.setenv('SWINDET_WATTN_V4', '1')
    mp.delenv('SWINDET_FUSED_MLP', raising=False)
    try:
        run = _slice_run()
    finally:
        mp.undo()
    attns = [m for m in run['port'].modules()
             if isinstance(m, WindowAttention)]
    assert attns and all(m.v4 for m in attns)
    return run


def _check_losses(run):
    want, got = run['want'], run['got']
    assert set(got) | {'loss'} == set(want)
    assert want['loss_mask'] > 0 and want['loss_rpn_bbox'] > 0
    for name, value in got.items():
        assert np.isfinite(value)
        np.testing.assert_allclose(value, want[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _check_grad(run, name):
    got = run['got_grads'][name].grad.numpy()
    want = run['want_grads'][name].numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)


def test_forward_train_losses_match_jax(slice_run):
    _check_losses(slice_run)


@pytest.mark.parametrize('name', GRAD_PARAMS)
def test_forward_train_grads_match_jax(slice_run, name):
    _check_grad(slice_run, name)


def test_forward_train_losses_match_jax_fused_mlp(fused_slice_run):
    _check_losses(fused_slice_run)


@pytest.mark.parametrize('name', GRAD_PARAMS + FUSED_MLP_GRAD_PARAMS)
def test_forward_train_grads_match_jax_fused_mlp(fused_slice_run, name):
    _check_grad(fused_slice_run, name)


def test_forward_train_losses_match_jax_wattn_v4(wattn_v4_slice_run):
    _check_losses(wattn_v4_slice_run)


@pytest.mark.parametrize('name', GRAD_PARAMS + WATTN_V4_GRAD_PARAMS)
def test_forward_train_grads_match_jax_wattn_v4(wattn_v4_slice_run, name):
    _check_grad(wattn_v4_slice_run, name)


def test_train_step_moves_the_parameters(slice_run):
    port, cfg = slice_run['port'], slice_run['cfg']
    opt = build_optimizer(port, dict(
        type='AdamW', lr=1e-3, betas=(0.9, 0.999), weight_decay=0.05,
        paramwise_cfg=dict(custom_keys={
            'relative_position_bias_table': dict(decay_mult=0.),
            'norm': dict(decay_mult=0.)})))
    schedule = build_lr_schedule(dict(policy='step', warmup='linear',
                                      warmup_iters=10, warmup_ratio=0.1,
                                      step=[8, 11]), 1e-3, 100)
    step = make_train_step(port, opt, schedule)
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    log = step(slice_run['batch'], torch.Generator().manual_seed(0))
    assert {'loss', 'grad_norm', 'loss_rpn_cls', 'loss_mask'} <= set(log)
    assert all(np.isfinite(v) for v in log.values())
    assert log['grad_norm'] > 0
    moved = [k for k, v in port.named_parameters()
             if not torch.equal(v.detach(), before[k])]
    assert len(moved) == len(before)


def test_training_after_serving_in_one_process():
    """Index tables and anchors cached while serving (inference mode) can
    be reused by a training step."""
    cfg = tiny_maskrcnn_cfg()
    model = build_detector(cfg)
    model.init_weights(3)
    b = {k: torch.from_numpy(v.copy()) for k, v in make_batch(seed=1).items()}
    with torch.inference_mode():
        model.eval()
        model.simple_test(b['img'], b['img_shapes'], torch.ones(2, 4))
    model.train()
    losses = model.forward_train(
        b['img'], b['img_shapes'], b['pad_shapes'], b['gt_bboxes'],
        b['gt_valid'], b['gt_labels'], b['gt_masks'],
        gen=torch.Generator().manual_seed(0))
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    assert model.backbone.patch_embed.proj.weight.grad.abs().max() > 0


def test_drop_path_is_per_sample_and_seeded():
    """Stochastic depth as the JAX package's DropPath (layers.py:48): each
    sample's branch kept with probability 1 - p and scaled by 1 / (1 - p),
    the identity in eval mode; the draws come from the given generator."""
    from swindet_tpu_torch.models.layers import DropPath
    dp = DropPath(0.25).train()
    x = torch.ones(4000, 3, 5)
    y = dp(x, torch.Generator().manual_seed(0))
    kept = y[:, 0, 0] > 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert (y[~kept] == 0).all()
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    assert torch.equal(y, dp(x, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError):
        dp(x)
    assert dp.eval()(x) is x
