"""Training CLI of the port (counterpart of ``tools/train.py``; reference
mmdet tools/train.py:86-183), the same arguments plus ``--device``::

    python -m swindet_tpu_torch.tools.train CONFIG [--work-dir DIR] \
        [--resume-from CKPT] [--no-validate] [--device cpu]

Trains ``cfg.data.train`` with ``train_detector`` on the device (the card
unless ``--device cpu``), evaluating on ``cfg.data.val`` each
``evaluation.interval`` epochs unless ``--no-validate``. ``--debug-nans``
turns on autograd's anomaly detection (the JAX package's jax_debug_nans).
Launchers other than ``none`` (DDP) are not ported.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import platform
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..apis.train import set_random_seed, train_detector
from ..datasets import build_dataset
from ..models import build_detector
from ..utils import Config, DictAction, get_root_logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Train a detector')
    parser.add_argument('config', help='train config file path')
    parser.add_argument('--work-dir', help='the dir to save logs/models')
    parser.add_argument('--resume-from',
                        help='checkpoint file to resume from')
    parser.add_argument('--no-validate', action='store_true',
                        help='skip validation during training')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--deterministic', action='store_true')
    parser.add_argument('--debug-nans', action='store_true',
                        help='raise at the first backward op that gives '
                             'NaN (autograd anomaly detection)')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        help='override config, xxx=yyy format')
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'pytorch', 'slurm', 'mpi', 'jax'])
    parser.add_argument('--device', default='cuda',
                        help='the device to train on: cuda (default) or cpu')
    return parser.parse_args(argv)


def collect_env() -> dict:
    env = {'sys.platform': sys.platform,
           'Python': sys.version.replace('\n', ''),
           'Machine': platform.machine(), 'PyTorch': torch.__version__,
           'CUDA': str(torch.version.cuda), 'NumPy': np.__version__}
    if torch.cuda.is_available():
        env['GPU 0'] = torch.cuda.get_device_name(0)
    return env


def _head_num_classes(cfg) -> list:
    if isinstance(cfg, dict):
        found = [cfg['num_classes']] if 'num_classes' in cfg else []
        return found + [n for v in cfg.values()
                        for n in _head_num_classes(v)]
    if isinstance(cfg, (list, tuple)):
        return [n for v in cfg for n in _head_num_classes(v)]
    return []


def check_num_classes(model_cfg: dict, dataset) -> None:
    """Raise when no head of the model declares the dataset's number of
    classes (reference NumClassCheckHook)."""
    classes = getattr(dataset, 'CLASSES', None)
    declared = _head_num_classes(model_cfg)
    if classes is not None and declared \
            and len(classes) not in declared:
        raise ValueError(f'num_classes mismatch: the model declares '
                         f'{sorted(set(declared))}, the dataset has '
                         f'{len(classes)} classes')


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI on ``argv`` (the process's arguments when None).
    Returns train_detector's runner."""
    args = parse_args(argv)
    if args.launcher != 'none':
        raise NotImplementedError(f'--launcher {args.launcher}: distributed '
                                  f'training (DDP) is not ported (ROADMAP '
                                  f'§1 item 5)')
    cfg = Config.fromfile(args.config)
    if args.cfg_options is not None:
        cfg.merge_from_dict(args.cfg_options)
    if args.work_dir is not None:
        cfg.work_dir = args.work_dir
    elif cfg.get('work_dir') is None:
        cfg.work_dir = osp.join(
            './work_dirs', osp.splitext(osp.basename(args.config))[0])
    if args.resume_from is not None:
        cfg.resume_from = args.resume_from
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    os.makedirs(osp.abspath(cfg.work_dir), exist_ok=True)
    cfg.dump(osp.join(cfg.work_dir, osp.basename(args.config)))
    timestamp = time.strftime('%Y%m%d_%H%M%S', time.localtime())
    logger = get_root_logger()
    env_info = '\n'.join(f'{k}: {v}' for k, v in collect_env().items())
    logger.info('Environment info:\n' + env_info)
    logger.info(f'Config:\n{cfg.pretty_text}')

    seed = args.seed if args.seed is not None else cfg.get('seed', 0)
    cfg.seed = seed
    set_random_seed(seed, deterministic=args.deterministic)
    meta = dict(env_info=env_info, config=cfg.pretty_text, seed=seed,
                exp_name=osp.basename(args.config))

    model_cfg = dict(cfg.model)
    model_cfg.pop('pretrained', None)
    if cfg.get('bf16'):
        model_cfg['dtype'] = 'bfloat16'
    model = build_detector(model_cfg)
    dataset = build_dataset(cfg.data.train)
    check_num_classes(dict(cfg.model), dataset)
    return train_detector(model, dataset, cfg,
                          validate=not args.no_validate,
                          timestamp=timestamp, meta=meta,
                          device=args.device)


if __name__ == '__main__':
    main(sys.argv[1:])
