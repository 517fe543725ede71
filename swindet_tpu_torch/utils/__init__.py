from .config import Config, ConfigDict, DictAction
from .logger import get_root_logger, print_log
from .registry import Registry, build_from_cfg

__all__ = ['Config', 'ConfigDict', 'DictAction', 'Registry',
           'build_from_cfg', 'get_root_logger', 'print_log']
