from .config import Config, ConfigDict
from .logger import get_root_logger, print_log
from .registry import Registry, build_from_cfg

__all__ = ['Config', 'ConfigDict', 'Registry', 'build_from_cfg',
           'get_root_logger', 'print_log']
