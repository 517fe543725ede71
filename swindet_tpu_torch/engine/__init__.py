"""Training engine of the port: optimizer, learning-rate schedule and the
training step (counterpart of ``swindet_tpu/engine/``)."""
from .optimizer import build_optimizer, multipliers, param_multipliers
from .schedules import build_lr_schedule
from .train_step import make_train_step, parse_losses

__all__ = ['build_optimizer', 'multipliers', 'param_multipliers',
           'build_lr_schedule', 'make_train_step', 'parse_losses']
