"""Epoch-based training runner (counterpart of
``swindet_tpu/engine/runner.py:24``; reference mmcv's EpochBasedRunner and
the hooks of mmdet/apis/train.py): draws the loader's batches, moves
them to the device, calls the training step, logs, checkpoints, and every
``eval_interval`` epochs runs the eval hook (``eval_fn``, :34-49 and
:138-152 there), keeping the best checkpoint by ``save_best``
(``_maybe_save_best`` :155-186).

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
                 timestamp: Optional[str] = None,
                 eval_fn: Optional[Callable] = None,
                 eval_interval: int = 1,
                 save_best: Optional[str] = None,
                 save_best_rule: str = 'auto'):
        self.train_step = train_step
        self.work_dir = work_dir
        self.logger = logger
        self.max_epochs = max_epochs
        self.device = torch.device(device)
        self.checkpoint_interval = checkpoint_interval
        self.log_interval = log_interval
        self.save_fn = save_fn
        self.meta = meta or {}
        # the eval hook: eval_fn(epoch) -> metrics; save_best names the
        # metric whose best value keeps a checkpoint ('auto': the first
        # numeric one), rule 'auto' is 'less' for a loss, else 'greater'
        # (reference mmcv EvalHook)
        self.eval_fn = eval_fn
        self.eval_interval = eval_interval
        self.save_best = save_best
        self.save_best_rule = save_best_rule
        self.best_score: Optional[float] = None
        self.eval_results: List[Dict[str, float]] = []
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
            if self.eval_fn and self.epoch % self.eval_interval == 0:
                self._evaluate()
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

    def _evaluate(self) -> None:
        """Run the eval hook, log its metrics (text, and the numeric ones
        as a ``mode: val`` JSON line) and keep the best checkpoint."""
        metrics = self.eval_fn(self.epoch)
        if not metrics:
            return
        self.logger.info('Eval: ' + ' '.join(f'{k}: {v}'
                                             for k, v in metrics.items()))
        numeric = {}
        for k, v in metrics.items():
            try:
                numeric[k] = float(v)
            except (TypeError, ValueError):
                pass  # the mAP_copypaste strings
        self.eval_results.append(numeric)
        self._log_json(dict(mode='val', epoch=self.epoch, iter=self.iter,
                            **numeric))
        self._maybe_save_best(numeric)

    def _maybe_save_best(self, numeric: Dict[str, float]) -> None:
        """Keep ``best_<key>_epoch_<n>.pth`` and the ``best_<key>`` link to
        it when the metric ``save_best`` improves."""
        if not (self.save_best and self.save_fn and numeric):
            return
        if self.save_best == 'auto':
            self.save_best = next(iter(numeric))
        if self.save_best_rule == 'auto':
            self.save_best_rule = ('less' if 'loss' in self.save_best
                                   else 'greater')
        if self.save_best not in numeric:
            raise KeyError(f'save_best: no metric {self.save_best!r} in '
                           f'{sorted(numeric)}')
        score = numeric[self.save_best]
        if self.best_score is not None and not (
                score > self.best_score if self.save_best_rule == 'greater'
                else score < self.best_score):
            return
        self.best_score = score
        key = self.save_best.replace('/', '_')
        name = f'best_{key}_epoch_{self.epoch}.pth'
        path = osp.join(self.work_dir, name)
        self.save_fn(path, dict(self.meta, epoch=self.epoch, iter=self.iter,
                                best_score=score))
        link = osp.join(self.work_dir, f'best_{key}')
        if osp.lexists(link):
            old = osp.join(self.work_dir, os.readlink(link))
            os.remove(link)
            if old != path and osp.isfile(old):
                os.remove(old)
        os.symlink(name, link)
        self.logger.info(f'Best {self.save_best} = {score:.4f} at epoch '
                         f'{self.epoch}; saved {path}')
