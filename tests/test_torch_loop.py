"""The port's training loop on the CPU: ``train_detector`` on a tiny Swin
Mask R-CNN (embed_dim 32, depths [1, 1, 1, 1]) reading a synthetic
COCO-style dataset from files through the flagship's train pipeline
shape (flip, both AutoAugment branches with the crop), at small scales.

- Its first iteration's log equals ``make_train_step`` on the loader's
  first batch, bit for bit, and every logged loss is finite.
- Two epochs in one run give the same parameters and optimizer state,
  bit for bit, as one epoch and a resumed second (the loader's draws are
  keyed by seed, epoch and index; the step's generator is reseeded from
  seed and epoch).
- Starting weights: a backbone-only checkpoint gets the 'backbone.'
  prefix and its bias tables are resized to the model's window.
- What is not ported raises and names its ROADMAP item.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from tests.test_models.test_forward import tiny_maskrcnn_cfg
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.apis import set_random_seed, train_detector
from swindet_tpu_torch.checkpoint import interp_bias_table, load_weights
from swindet_tpu_torch.datasets import (build_dataloader, build_dataset,
                                        derive_canvas)
from swindet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                      make_train_step)
from swindet_tpu_torch.engine.runner import epoch_seed
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.utils import Config

from chip_smoke import write_synthetic_coco

cap_torch_threads()

CLASSES = ('a', 'b', 'c', 'd')
SIZES = ((60, 90), (72, 100), (90, 60), (100, 72))
SCALES = [(128, 64), (128, 80)]
PIPELINE = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True, with_mask=True),
    dict(type='RandomFlip', flip_ratio=0.5),
    dict(type='AutoAugment', policies=[
        [dict(type='Resize', img_scale=SCALES, multiscale_mode='value',
              keep_ratio=True)],
        [dict(type='Resize', img_scale=[(128, 48), (128, 64)],
              multiscale_mode='value', keep_ratio=True),
         dict(type='RandomCrop', crop_type='absolute_range',
              crop_size=(40, 64), allow_negative_crop=True),
         dict(type='Resize', img_scale=SCALES, multiscale_mode='value',
              override=True, keep_ratio=True)]]),
    dict(type='Normalize', mean=[123.675, 116.28, 103.53],
         std=[58.395, 57.12, 57.375], to_rgb=True),
    dict(type='Pad', size_divisor=32),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels', 'gt_masks']),
]


def loop_cfg(root, work_dir, max_epochs, resume_from=None):
    model = tiny_maskrcnn_cfg()
    model['backbone']['drop_path_rate'] = 0.1
    return Config(dict(
        model=model, seed=3, work_dir=work_dir, resume_from=resume_from,
        data=dict(samples_per_gpu=2, workers_per_gpu=2, train=dict(
            type='CocoDataset', ann_file=os.path.join(root,
                                                      'annotations.json'),
            img_prefix=os.path.join(root, 'images'), classes=CLASSES,
            pipeline=copy.deepcopy(PIPELINE))),
        optimizer=dict(type='AdamW', lr=1e-4, betas=(0.9, 0.999),
                       weight_decay=0.05, paramwise_cfg=dict(custom_keys={
                           'relative_position_bias_table':
                               dict(decay_mult=0.0),
                           'norm': dict(decay_mult=0.0)})),
        optimizer_config=dict(grad_clip=None),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=3,
                       warmup_ratio=0.001, step=[8, 11]),
        runner=dict(type='EpochBasedRunner', max_epochs=max_epochs),
        checkpoint_config=dict(interval=1),
        log_config=dict(interval=1, hooks=[dict(type='TextLoggerHook')]),
        custom_hooks=[dict(type='NumClassCheckHook')],
        workflow=[('train', 1)]))


def _train(root, work_dir, max_epochs, timestamp, resume_from=None):
    """A run whose logs are named by ``timestamp``: the runner names them to
    the second, and two runs that share a work_dir and start within one
    second would append to the same files."""
    cfg = loop_cfg(root, work_dir, max_epochs, resume_from)
    dataset = build_dataset(cfg.data.train)
    return train_detector(build_detector(dict(cfg.model)), dataset, cfg,
                          timestamp=timestamp, device='cpu'), cfg, dataset


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """One epoch, the second resumed from it, and two epochs in one run."""
    root = str(tmp_path_factory.mktemp('coco'))
    write_synthetic_coco(root, SIZES, seed=0, class_names=CLASSES)
    set_random_seed(0)
    split = os.path.join(root, 'split')
    first, cfg, dataset = _train(root, split, 1, 'first')
    resumed, _, _ = _train(root, split, 2, 'resumed',
                           os.path.join(split, 'epoch_1.pth'))
    whole, _, _ = _train(root, os.path.join(root, 'whole'), 2, 'whole')
    return dict(root=root, cfg=cfg, dataset=dataset, first=first,
                resumed=resumed, whole=whole, split=split)


def test_train_detector_logs_what_make_train_step_gives(runs):
    first, cfg, dataset = runs['first'], runs['cfg'], runs['dataset']
    assert len(first.log_vars) == 2 and first.epoch == 1
    for log in first.log_vars:
        assert all(np.isfinite(v) for v in log.values()), log
    canvases = set(first.canvases)
    assert canvases <= {(96, 128), (128, 96), (128, 128)} and canvases
    # the same first step by hand: seeded weights, the loader's first
    # batch of epoch 0, the step's generator as the runner seeds it
    model = build_detector(dict(cfg.model))
    model.init_weights(cfg.seed)
    optimizer = build_optimizer(model, dict(cfg.optimizer))
    long, short = derive_canvas(cfg.data.train.pipeline)
    loader = build_dataloader(dataset, 2, 1, seed=cfg.seed,
                              canvas_long=long, canvas_short=short)
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 len(loader))
    step = make_train_step(model, optimizer, schedule)
    loader.set_epoch(0)
    batch = next(iter(loader))
    batch.pop('img_metas')
    gen = torch.Generator().manual_seed(epoch_seed(cfg.seed, 0))
    want = step({k: torch.from_numpy(v) for k, v in batch.items()}, gen)
    assert first.log_vars[0] == want
    with open(first.json_log) as f:
        lines = [json.loads(line) for line in f]
    assert [(r['epoch'], r['iter']) for r in lines] == [(1, 1), (1, 2)]
    assert lines[0]['loss'] == pytest.approx(want['loss'], rel=1e-6)
    assert len(first.times['data_time']) == len(first.times['step_time']) == 2


def test_resumed_run_equals_uninterrupted_run(runs):
    split, whole = runs['split'], os.path.join(runs['root'], 'whole')
    assert os.readlink(os.path.join(split, 'latest.pth')) == 'epoch_2.pth'
    with open(runs['resumed'].json_log) as f:
        assert {json.loads(line)['epoch'] for line in f} == {2}
    assert runs['resumed'].log_vars == runs['whole'].log_vars[2:]
    a = torch.load(os.path.join(split, 'epoch_2.pth'), weights_only=True)
    b = torch.load(os.path.join(whole, 'epoch_2.pth'), weights_only=True)
    assert a['meta']['epoch'] == b['meta']['epoch'] == 2
    assert a['meta']['iter'] == b['meta']['iter'] == 4
    assert a['meta']['CLASSES'] == list(CLASSES)
    assert a['state_dict'].keys() == b['state_dict'].keys()
    for k, v in a['state_dict'].items():
        assert torch.equal(v, b['state_dict'][k]), k
    for sa, sb in zip(a['optimizer']['state'].values(),
                      b['optimizer']['state'].values()):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    # and training moved the weights
    c = torch.load(os.path.join(split, 'epoch_1.pth'), weights_only=True)
    assert any(not torch.equal(v, c['state_dict'][k])
               for k, v in a['state_dict'].items())


def test_load_weights_takes_a_backbone_checkpoint(tmp_path):
    """Bare backbone keys get the 'backbone.' prefix, window-7 bias tables
    are resized to the model's window 12, the rest of the detector keeps
    its weights."""
    small = tiny_maskrcnn_cfg()
    src = build_detector(small)
    src.init_weights(1)
    bare = {k[len('backbone.'):]: v for k, v in src.state_dict().items()
            if k.startswith('backbone.')}
    path = str(tmp_path / 'backbone.pth')
    torch.save(dict(state_dict=bare, meta=dict(note='pretrain')), path)
    big = copy.deepcopy(small)
    big['backbone']['window_size'] = 12
    model = build_detector(big)
    model.init_weights(2)
    neck_before = model.neck.state_dict()
    assert load_weights(model, path) == dict(note='pretrain')
    got = model.state_dict()
    for k, v in bare.items():
        if k.endswith('relative_position_bias_table'):
            assert torch.equal(got[f'backbone.{k}'],
                               interp_bias_table(v, 23 * 23))
        else:
            assert torch.equal(got[f'backbone.{k}'], v), k
    for k, v in model.neck.state_dict().items():
        assert torch.equal(v, neck_before[k])


@pytest.mark.parametrize('what', ['validate', 'distributed', 'ema',
                                  'update_interval', 'cuda'])
def test_train_detector_refuses_what_is_not_ported(tmp_path, monkeypatch,
                                                   what):
    cfg = loop_cfg(str(tmp_path), str(tmp_path / 'work'), 1)
    kw = dict(device='cpu')
    if what in ('validate', 'distributed'):
        kw[what] = True
    if what == 'validate':
        # the eval hook is ported; its native batched loader is not
        monkeypatch.setenv('SWINDET_NATIVE_IMAGE', '1')
    elif what == 'ema':
        cfg.custom_hooks = [dict(type='EMAHook', momentum=0.0002)]
    elif what == 'update_interval':
        cfg.optimizer_config = dict(grad_clip=None, update_interval=2)
    else:
        if torch.cuda.is_available():
            pytest.skip('a CUDA device is present')
        kw['device'] = 'cuda'
    error = RuntimeError if what == 'cuda' else NotImplementedError
    with pytest.raises(error, match='ROADMAP|no CUDA device'):
        train_detector(None, None, cfg, **kw)


class _CountingDataset:
    """Sample i is (i, the sample generator's first draw); flags put the
    even indices in one aspect group and the odd in the other."""

    def __init__(self, n):
        self.flag = (np.arange(n) % 2).astype(np.uint8)

    def __len__(self):
        return len(self.flag)

    def get(self, idx, rng):
        return dict(img=np.full((4, 6, 3), idx, np.float32),
                    gt_bboxes=np.array([[0, 0, 1, rng.rand()]], np.float32),
                    gt_labels=np.array([idx]), img_metas={})


def test_loader_threads_keep_the_sampler_order():
    """More loader threads than cores, a short switch interval and a
    small prefetch window: every batch comes once, in the sampler's
    order, with its own samples' draws; closing the iterator early stops
    the threads."""
    import sys
    import threading
    from swindet_tpu_torch.datasets import DetDataLoader, sample_rng
    ds = _CountingDataset(41)
    loader = DetDataLoader(ds, 3, canvas_long=8, canvas_short=8,
                           with_mask=False, seed=5, num_workers=16,
                           prefetch=2)
    before = threading.active_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for epoch in range(2):
            loader.set_epoch(epoch)
            batches = list(loader.sampler)
            got = list(loader)
            assert len(got) == len(batches) == len(loader)
            for idxs, batch in zip(batches, got):
                assert batch['img'][:, 0, 0, 0].tolist() == idxs
                assert batch['gt_bboxes'][:, 0, 3].tolist() == [
                    np.float32(sample_rng(5, epoch, i).rand()) for i in idxs]
        it = iter(loader)
        next(it)
        it.close()
    finally:
        sys.setswitchinterval(interval)
    assert threading.active_count() == before



SWIN_T = dict(type='SwinTransformer', embed_dim=96, depths=[2, 2, 6, 2],
              num_heads=[3, 6, 12, 24], window_size=7, drop_path_rate=0.0)


def _padded_images(h=64, w=96, seed=0):
    """Two normalized images, each inside its own corner of a zero-padded
    (h, w) canvas, as the loader lays them out."""
    rs = np.random.RandomState(seed)
    img = np.zeros((2, h, w, 3), np.float32)
    img[0, :h // 2, :w // 2] = rs.randn(h // 2, w // 2, 3)
    img[1, :h * 3 // 4, :w // 3] = rs.randn(h * 3 // 4, w // 3, 3)
    return img


def _backbone_grads(backbone, img, seed=1):
    """Each parameter's gradient of a seeded linear function of the
    backbone's four outputs."""
    backbone.train()
    backbone.zero_grad(set_to_none=True)
    outs = backbone(torch.from_numpy(img))
    rs = np.random.RandomState(seed)
    loss = sum((o * torch.from_numpy(rs.randn(*o.shape).astype(np.float32)))
               .sum() for o in outs)
    loss.backward()
    return {n: p.grad for n, p in backbone.named_parameters()}


def test_zero_patch_bias_gradient_on_a_padded_canvas_matches_jax():
    """With the JAX package's own init (a zero patchify bias) every padded
    patch is a zero vector, which each LayerNorm scales by eps ** -0.5:
    the patch bias takes the largest gradient, and the JAX package reads
    the same gradients as the port (1e-3 of each tensor's largest entry)
    on those weights."""
    import jax
    import jax.numpy as jnp
    from swindet_tpu_torch.checkpoint import state_dict_from_jax
    from swindet_tpu_torch.models.builder import build_backbone
    from swindet_tpu.models.builder import build_backbone as jax_backbone
    cfg = tiny_maskrcnn_cfg()['backbone']
    jm = jax_backbone(dict(cfg))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        {'params': jax.random.PRNGKey(0)},
        jnp.zeros((1, 64, 64, 3), jnp.float32))['params'])
    sd = state_dict_from_jax(params)
    assert not sd['patch_embed.proj.bias'].any()
    img = _padded_images()
    port = build_backbone(dict(cfg))
    port.load_state_dict(sd, strict=True)
    got = _backbone_grads(port, img)
    shapes = [o.shape for o in jax.eval_shape(
        lambda x: jm.apply({'params': params}, x), jnp.asarray(img))]
    rs = np.random.RandomState(1)
    weights = [jnp.asarray(rs.randn(*s).astype(np.float32)) for s in shapes]

    def loss(p):
        outs = jm.apply({'params': p}, jnp.asarray(img))
        return sum((o * wt).sum() for o, wt in zip(outs, weights))
    want = state_dict_from_jax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss))(params)))
    assert want.keys() == got.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-3 * float(w.abs().max()),
                                   err_msg=name)
    norms = {n: float(w.norm()) for n, w in want.items()}
    assert max(norms, key=norms.get) == 'patch_embed.proj.bias'


def test_seeded_patch_bias_keeps_a_padded_canvas_gradient_small():
    """Swin-T at full width on a padded canvas: with the port's seeded
    init the gradient norm stays in the ten thousands (this loss sums
    100k outputs); with the patch bias zeroed, as the JAX package inits
    it, the padded patches' chain of LayerNorms takes the patch bias's
    gradient past 1e9."""
    from swindet_tpu_torch.models.builder import build_backbone
    backbone = build_backbone(dict(SWIN_T))
    backbone.init_weights(torch.Generator().manual_seed(0))
    assert backbone.patch_embed.proj.bias.abs().min() > 0
    img = _padded_images()
    grads = _backbone_grads(backbone, img)
    total = float(torch.stack([g.norm() for g in grads.values()]).norm())
    assert total < 1e6
    with torch.no_grad():
        backbone.patch_embed.proj.bias.zero_()
    zero = _backbone_grads(backbone, img)['patch_embed.proj.bias']
    assert not float(zero.norm()) < 1e9
