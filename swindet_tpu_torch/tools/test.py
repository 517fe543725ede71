"""Test / evaluation CLI of the port (counterpart of ``tools/test.py``;
reference mmdet tools/test.py:100-218), the same arguments plus
``--device``::

    python -m swindet_tpu_torch.tools.test CONFIG CHECKPOINT \
        --eval bbox segm [--out results.pkl] [--device cpu]

Builds ``data.test`` in test mode, runs ``single_gpu_test`` on the device
(the card unless ``--device cpu``), and writes, formats or evaluates the
results. Drawing results (``--show-dir``) and launchers other than
``none`` are not ported.
"""
from __future__ import annotations

import argparse
import os.path as osp
import pickle
import sys
import time
from typing import Optional, Sequence

import torch

from ..apis.inference import init_detector
from ..apis.test import single_gpu_test
from ..datasets import build_dataset
from ..utils import Config, DictAction, get_root_logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Test a detector')
    parser.add_argument('config')
    parser.add_argument('checkpoint')
    parser.add_argument('--out', help='output result pickle file')
    parser.add_argument('--eval', type=str, nargs='+',
                        help='metrics: bbox segm proposal')
    parser.add_argument('--format-only', action='store_true')
    parser.add_argument('--show-dir',
                        help='directory to save painted images')
    parser.add_argument('--show-score-thr', type=float, default=0.3)
    parser.add_argument('--samples-per-gpu', type=int, default=8)
    parser.add_argument('--cfg-options', nargs='+', action=DictAction)
    parser.add_argument('--eval-options', nargs='+', action=DictAction)
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'pytorch', 'slurm', 'mpi', 'jax'])
    parser.add_argument('--device', default='cuda',
                        help="the model's device: cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI on ``argv`` (the process's arguments when None).
    Returns dict(results, metrics, times): the per-image results, the
    metrics of ``--eval`` (or None) and the seconds of single_gpu_test's
    stages, of all of it ('test') and of the evaluation ('evaluate')."""
    args = parse_args(argv)
    if not (args.out or args.eval or args.format_only or args.show_dir):
        raise SystemExit('Please specify at least one of --out / --eval / '
                         '--format-only / --show-dir')
    if args.launcher != 'none':
        raise NotImplementedError(f'--launcher {args.launcher}: multi-GPU '
                                  f'testing is not ported (ROADMAP §1 '
                                  f'item 6)')
    if args.show_dir:
        raise NotImplementedError('--show-dir: drawing results '
                                  '(show_result) is not ported (ROADMAP '
                                  '§1 item 6)')
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError('tools.test: no CUDA device; pass --device cpu '
                           'to test on the CPU')
    cfg = Config.fromfile(args.config)
    if args.cfg_options is not None:
        cfg.merge_from_dict(args.cfg_options)
    logger = get_root_logger()
    model = init_detector(cfg, args.checkpoint, device=args.device)
    dataset = build_dataset(dict(cfg.data.test, test_mode=True))
    model.CLASSES = tuple(dataset.CLASSES or model.CLASSES)
    times: dict = {}
    t0 = time.perf_counter()
    results = single_gpu_test(model, dataset, args.samples_per_gpu,
                              logger=logger, times=times)
    times['test'] = time.perf_counter() - t0
    logger.info('test stages (s): ' + ', '.join(
        f'{k} {v:.3f}' for k, v in times.items()))
    if args.out:
        logger.info(f'writing results to {args.out}')
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
    if args.format_only:
        dataset.results2json(results, osp.splitext(args.out or
                                                   'results')[0])
    metrics = None
    if args.eval:
        t0 = time.perf_counter()
        metrics = dataset.evaluate(results, metric=args.eval, logger=logger,
                                   **dict(args.eval_options or {}))
        times['evaluate'] = time.perf_counter() - t0
        print(metrics)
    return dict(results=results, metrics=metrics, times=times)


if __name__ == '__main__':
    main(sys.argv[1:])
