"""Training API (counterpart of ``swindet_tpu/apis/train.py``:
``set_random_seed`` :27, the weight initialisation :34-53,
``train_detector`` :56, the eval hook :175-213; reference
mmdet/apis/train.py:42): the loader, the optimizer and schedule, the
training step, resume, the runner and, with ``validate``, the eval hook,
on one device.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import random
import time
from typing import Optional, Union

import numpy as np
import torch

from ..checkpoint import load_weights, resume, save_checkpoint
from ..datasets.builder import build_dataloader, build_dataset, derive_canvas
from ..engine import build_lr_schedule, build_optimizer, make_train_step
from ..engine.runner import EpochBasedRunner
from ..utils.logger import LOG_FORMAT, get_root_logger
from .test import single_gpu_test


def set_random_seed(seed: int, deterministic: bool = False) -> None:
    """Seed Python's, numpy's and torch's global generators (the loader
    and the step draw from their own, seeded from the config's seed)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def init_detector_weights(model: torch.nn.Module, cfg, logger,
                          seed: int = 0) -> None:
    """Seeded weights, then ``model.pretrained`` (a backbone's or a
    whole detector's ``.pth``) and ``load_from`` over them."""
    model.init_weights(seed)
    pretrained = dict(cfg.model).get('pretrained')
    if pretrained:
        logger.info(f'Loading pretrained weights from {pretrained}')
        load_weights(model, pretrained, logger)
    if cfg.get('load_from'):
        logger.info(f'load_from {cfg.load_from}')
        load_weights(model, cfg.load_from, logger)


def _not_ported(what: str, item: int = 5):
    raise NotImplementedError(f'train_detector: {what} is not ported '
                              f'(ROADMAP §1 item {item})')


def train_detector(model: torch.nn.Module, dataset, cfg,
                   distributed: bool = False, validate: bool = False,
                   timestamp: Optional[str] = None,
                   meta: Optional[dict] = None,
                   device: Union[str, torch.device] = 'cuda'
                   ) -> EpochBasedRunner:
    """Train ``model`` (built from ``cfg.model``; its weights are set here
    from ``cfg.seed``, ``pretrained`` and ``load_from``) on ``dataset``
    for ``cfg.runner.max_epochs`` epochs on ``device``, resuming from
    ``cfg.resume_from`` when it is set. Writes the text log, the
    ``.log.json`` lines and ``epoch_N.pth`` / ``latest.pth`` to
    ``cfg.work_dir``. With ``validate``, every ``evaluation.interval``
    epochs the model is evaluated on ``cfg.data.val`` (test mode) by
    ``evaluation.metric``, logged as a ``mode: val`` line, and
    ``evaluation.save_best`` keeps the best checkpoint. Returns the runner,
    which holds each iteration's times, log values and eval results."""
    if distributed:
        _not_ported('distributed training (DDP)')
    if validate and os.environ.get('SWINDET_NATIVE_IMAGE') == '1':
        _not_ported('the native batched test loader '
                    '(SWINDET_NATIVE_IMAGE=1)', 4)
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('train_detector: no CUDA device; pass '
                           "device='cpu' to train on the CPU")
    timestamp = timestamp or time.strftime('%Y%m%d_%H%M%S')
    os.makedirs(cfg.work_dir, exist_ok=True)
    logger = get_root_logger(log_level=getattr(
        logging, str(cfg.get('log_level', 'INFO')), logging.INFO))
    log_file = logging.FileHandler(
        osp.join(cfg.work_dir, f'{timestamp}.log'), 'w')
    log_file.setFormatter(logging.Formatter(LOG_FORMAT))
    logger.addHandler(log_file)
    try:
        return _train(model, dataset, cfg, device, timestamp, meta, logger,
                      validate)
    finally:
        logger.removeHandler(log_file)
        log_file.close()


def _train(model, dataset, cfg, device, timestamp, meta, logger,
           validate):
    """train_detector's body, its text log file open."""
    workflow = cfg.get('workflow')
    if workflow:
        phases = {p[0] if isinstance(p, (tuple, list)) else p
                  for p in workflow}
        if phases - {'train'}:
            raise ValueError(f"workflow={workflow!r}: only [('train', N)] "
                             'is supported')
    for hook in cfg.get('custom_hooks') or []:
        if dict(hook).get('type') == 'EMAHook':
            _not_ported('EMAHook')
    opt_config = dict(cfg.get('optimizer_config', {}) or {})
    if int(opt_config.get('update_interval', 1)) > 1:
        _not_ported('gradient accumulation (update_interval > 1)')

    seed = cfg.get('seed', 0) or 0
    # the static canvas from the train pipeline's declared geometry; a
    # wrapper (RepeatDataset, ...) keeps it on its nested 'dataset'
    train_ds_cfg = cfg.data.train
    while 'pipeline' not in train_ds_cfg and 'dataset' in train_ds_cfg:
        train_ds_cfg = train_ds_cfg['dataset']
    pipeline = train_ds_cfg.get('pipeline', [])
    canvas_long, canvas_short = derive_canvas(pipeline)
    loader_cfg = dict(cfg.data.get('train_dataloader', {}))
    loader_cfg.setdefault('canvas_long', canvas_long)
    loader_cfg.setdefault('canvas_short', canvas_short)
    logger.info(f'Train canvas: {loader_cfg["canvas_long"]}x'
                f'{loader_cfg["canvas_short"]} (landscape; derived from '
                f'the pipeline)')
    loader = build_dataloader(
        dataset, samples_per_gpu=cfg.data.samples_per_gpu,
        workers_per_gpu=cfg.data.workers_per_gpu, seed=seed,
        with_mask=any('gt_masks' in str(p) for p in pipeline),
        **loader_cfg)

    init_detector_weights(model, cfg, logger, seed)
    model.to(device)
    optimizer = build_optimizer(model, dict(cfg.optimizer))
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 len(loader))
    resume_epoch = resume_iter = 0
    if cfg.get('resume_from'):
        ckpt_meta = resume(cfg.resume_from, model, optimizer)
        resume_epoch = int(ckpt_meta.get('epoch', 0))
        resume_iter = int(ckpt_meta.get('iter', 0))
        logger.info(f'Resumed from {cfg.resume_from} (epoch '
                    f'{resume_epoch}, iter {resume_iter})')
    step = make_train_step(model, optimizer, schedule,
                           opt_config.get('grad_clip'),
                           start_iter=resume_iter)
    meta = dict(meta or {}, CLASSES=getattr(dataset, 'CLASSES', None))

    def save_fn(path, ckpt_meta):
        save_checkpoint(path, model, optimizer, dict(meta, **ckpt_meta))

    eval_cfg = dict(cfg.get('evaluation', {}) or {})
    eval_fn = _eval_hook(model, cfg, eval_cfg, logger) if validate else None
    log_config = dict(cfg.get('log_config', {}) or {})
    runner = EpochBasedRunner(
        train_step=step, work_dir=cfg.work_dir, logger=logger,
        max_epochs=dict(cfg.runner)['max_epochs'], device=device,
        checkpoint_interval=dict(cfg.get('checkpoint_config', {})
                                 or {}).get('interval', 1),
        log_interval=log_config.get('interval', 50),
        save_fn=save_fn, meta=meta,
        tensorboard=any(dict(h).get('type') == 'TensorboardLoggerHook'
                        for h in log_config.get('hooks', [])),
        timestamp=timestamp, eval_fn=eval_fn,
        eval_interval=eval_cfg.get('interval', 1),
        save_best=eval_cfg.get('save_best'),
        save_best_rule=eval_cfg.get('rule', 'auto'))
    logger.info(f'Start training on {device}: batch '
                f'{cfg.data.samples_per_gpu}, {len(loader)} iters/epoch, '
                f'epochs {resume_epoch + 1}-{runner.max_epochs}')
    runner.run(loader, torch.Generator(device=device), seed, resume_epoch,
               resume_iter)
    return runner


def _eval_hook(model, cfg, eval_cfg, logger):
    """eval_fn(epoch) of the runner: ``single_gpu_test`` of the model, in
    eval mode and the config's dtype, on ``cfg.data.val`` in test mode,
    then the dataset's COCO metrics. It draws from no training generator,
    so a resumed run trains as an uninterrupted one."""
    val_dataset = build_dataset(dict(cfg.data.val, test_mode=True))
    batch_size = cfg.data.get('val_samples_per_gpu', cfg.data.samples_per_gpu)
    metric = eval_cfg.get('metric', 'bbox')

    def eval_fn(epoch):
        model.eval()
        try:
            results = single_gpu_test(model, val_dataset, batch_size,
                                      logger=logger)
        finally:
            model.train()
        return val_dataset.evaluate(results, metric=metric, logger=logger)
    return eval_fn
