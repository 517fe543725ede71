"""Epoch-based training runner (counterpart of
``swindet_tpu/engine/runner.py:24``; reference mmcv's EpochBasedRunner and
the hooks of mmdet/apis/train.py): draws the loader's batches, moves
them to the device, calls the training step, logs, and checkpoints. The
eval hook (and with it ``save_best``) is not ported (ROADMAP §1 item 5).

Each iteration's ``data_time`` (waiting for the loader) and
``step_time`` (``.to(device)`` and the step, which ends in a host read)
are kept in :attr:`EpochBasedRunner.times`; every ``log_interval``
iterations their means and the loss terms' go to the text log and as one
JSON line to ``<work_dir>/<timestamp>.log.json``.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of the step's generator in ``epoch``: a resumed run draws
    what an uninterrupted one draws."""
    return int(np.random.SeedSequence([int(seed), int(epoch)])
               .generate_state(1)[0])


class EpochBasedRunner:

    def __init__(self,
                 train_step: Callable,
                 work_dir: str,
                 logger,
                 max_epochs: int,
                 device: torch.device,
                 checkpoint_interval: int = 1,
                 log_interval: int = 50,
                 save_fn: Optional[Callable] = None,
                 meta: Optional[dict] = None,
                 tensorboard: bool = False,
                 timestamp: Optional[str] = None):
        self.train_step = train_step
        self.work_dir = work_dir
        self.logger = logger
        self.max_epochs = max_epochs
        self.device = torch.device(device)
        self.checkpoint_interval = checkpoint_interval
        self.log_interval = log_interval
        self.save_fn = save_fn
        self.meta = meta or {}
        self.epoch = 0
        self.iter = 0
        self.times: Dict[str, List[float]] = {'data_time': [],
                                              'step_time': []}
        self.log_vars: List[Dict[str, float]] = []
        # each iteration's canvas (H, W)
        self.canvases: List[Tuple[int, int]] = []
        os.makedirs(work_dir, exist_ok=True)
        timestamp = timestamp or time.strftime('%Y%m%d_%H%M%S')
        self.json_log = osp.join(work_dir, f'{timestamp}.log.json')
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(osp.join(work_dir, 'tf_logs'))
            except ImportError:
                self.logger.warning('tensorboardX unavailable; '
                                    'Tensorboard logging disabled')

    def _log_json(self, record: dict):
        with open(self.json_log, 'a') as f:
            f.write(json.dumps(record) + '\n')
        if self._tb is not None:
            mode = record.get('mode', 'train')
            for k, v in record.items():
                if k not in ('mode', 'epoch', 'iter') \
                        and isinstance(v, (int, float)):
                    self._tb.add_scalar(f'{mode}/{k}', v, self.iter)

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def run(self, loader, gen: torch.Generator, seed: int = 0,
            resume_epoch: int = 0, resume_iter: int = 0):
        """Train from epoch ``resume_epoch`` (and global iteration
        ``resume_iter``) to ``max_epochs``; ``gen`` is reseeded at each
        epoch's start from (``seed``, epoch)."""
        self.epoch, self.iter = resume_epoch, resume_iter
        total_iters = len(loader)
        while self.epoch < self.max_epochs:
            loader.set_epoch(self.epoch)
            gen.manual_seed(epoch_seed(seed, self.epoch))
            window: Dict[str, List[float]] = {}
            first = len(self.times['data_time'])
            t0 = time.perf_counter()
            for i, batch in enumerate(loader):
                batch.pop('img_metas', None)
                self.canvases.append(tuple(batch['img'].shape[1:3]))
                t1 = time.perf_counter()
                log_vars = self.train_step(self._to_device(batch), gen)
                t2 = time.perf_counter()
                self.iter += 1
                self.times['data_time'].append(t1 - t0)
                self.times['step_time'].append(t2 - t1)
                self.log_vars.append(log_vars)
                for k, v in log_vars.items():
                    window.setdefault(k, []).append(v)
                if (i + 1) % self.log_interval == 0 or i + 1 == total_iters:
                    n = len(next(iter(window.values())))
                    means = {k: float(np.mean(v)) for k, v in window.items()}
                    data_t = float(np.mean(self.times['data_time'][-n:]))
                    step_t = float(np.mean(self.times['step_time'][-n:]))
                    self.logger.info(
                        f'Epoch [{self.epoch + 1}/{self.max_epochs}]'
                        f'[{i + 1}/{total_iters}] data {data_t:.3f}s '
                        f'step {step_t:.3f}s ' + ' '.join(
                            f'{k}: {v:.4f}' for k, v in means.items()))
                    self._log_json(dict(mode='train', epoch=self.epoch + 1,
                                        iter=i + 1, data_time=data_t,
                                        step_time=step_t, **means))
                    window.clear()
                t0 = time.perf_counter()
            if len(self.times['data_time']) == first:
                raise RuntimeError('the loader gave no batch in an epoch')
            self.epoch += 1
            if self.save_fn and self.epoch % self.checkpoint_interval == 0:
                self._save()
        if self._tb is not None:
            self._tb.close()

    def _save(self) -> None:
        """Write ``epoch_N.pth`` and point the ``latest.pth`` symlink at it
        (reference epoch_based_runner.py:63)."""
        name = f'epoch_{self.epoch}.pth'
        path = osp.join(self.work_dir, name)
        self.save_fn(path, dict(self.meta, epoch=self.epoch, iter=self.iter))
        latest = osp.join(self.work_dir, 'latest.pth')
        if osp.lexists(latest):
            os.remove(latest)
        os.symlink(name, latest)
        self.logger.info(f'Saved checkpoint {path}')
