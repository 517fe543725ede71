"""Config: python-dict config files with ``_base_`` inheritance.

Re-implements the config surface the reference relies on (reference:
mmcv Config used at tools/train.py:89, configs/**/*.py): python files whose
top-level names become config keys, a ``_base_`` list of parent files
deep-merged in order, ``_delete_=True`` replacing instead of merging, and
``merge_from_dict`` for ``--cfg-options a.b.c=v`` CLI overrides, parsed
by :class:`DictAction` (``swindet_tpu/utils/config.py:269``).

No mmcv dependency; pure stdlib.
"""
from __future__ import annotations

import argparse
import ast
import os.path as osp
import pprint
import types
from typing import Any, Dict, Optional

DELETE_KEY = '_delete_'
BASE_KEY = '_base_'


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'")
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = wrap_cfg(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, wrap_cfg(value))


def wrap_cfg(obj: Any) -> Any:
    """Recursively convert plain dicts to ConfigDict."""
    if isinstance(obj, ConfigDict):
        return obj
    if isinstance(obj, dict):
        return ConfigDict({k: wrap_cfg(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(wrap_cfg(v) for v in obj)
    return obj


def _merge_a_into_b(a: dict, b: Any) -> Any:
    """Deep-merge dict ``a`` (child/override) into ``b`` (base).

    ``a[k] = dict(_delete_=True, ...)`` replaces ``b[k]`` entirely
    (reference semantics: mmcv Config._merge_a_into_b).
    """
    if not isinstance(a, dict):
        return a
    if a.pop(DELETE_KEY, False) or not isinstance(b, dict):
        return {k: _merge_a_into_b(v, None) if isinstance(v, dict) else v
                for k, v in a.items()}
    merged = dict(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in merged:
            merged[k] = _merge_a_into_b(v, merged[k])
        else:
            merged[k] = _merge_a_into_b(v, None) if isinstance(v, dict) else v
    return merged


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    """Execute a config .py file and return its top-level namespace."""
    with open(filename, encoding='utf-8') as f:
        source = f.read()
    # Validate syntax early for a clear error message.
    ast.parse(source, filename=filename)
    module = types.ModuleType('_cfg_')
    module.__file__ = filename
    # Allow `import os` etc. inside config files.
    code = compile(source, filename, 'exec')
    exec(code, module.__dict__)
    return {
        k: v for k, v in module.__dict__.items()
        if not k.startswith('__') and not isinstance(
            v, (types.ModuleType, types.FunctionType, type))
    }


def _load_cfg_dict(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f'Config file not found: {filename}')
    cfg_dict = _exec_pyfile(filename)

    base = cfg_dict.pop(BASE_KEY, None)
    if base is None:
        return cfg_dict
    base_files = [base] if isinstance(base, str) else list(base)
    base_dict: Dict[str, Any] = {}
    cfg_dir = osp.dirname(filename)
    for bf in base_files:
        b = _load_cfg_dict(osp.join(cfg_dir, bf))
        dup = set(base_dict) & set(b)
        if dup:
            raise KeyError(f'Duplicate keys {dup} in _base_ files of {filename}')
        base_dict.update(b)
    return _merge_a_into_b(cfg_dict, base_dict)


class Config:
    """Top-level config object (attribute + item access)."""

    def __init__(self, cfg_dict: Optional[dict] = None):
        object.__setattr__(self, '_cfg_dict', wrap_cfg(cfg_dict or {}))

    @staticmethod
    def fromfile(filename: str) -> 'Config':
        return Config(_load_cfg_dict(filename))

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._cfg_dict[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._cfg_dict

    def get(self, key: str, default: Any = None) -> Any:
        return self._cfg_dict.get(key, default)

    @property
    def pretty_text(self) -> str:
        """The config as a python file: one ``key = value`` line per
        top-level key, which ``fromfile`` reads back."""
        return ''.join(f'{k} = {pprint.pformat(v)}\n'
                       for k, v in _unwrap(self._cfg_dict).items())

    def dump(self, filename: str) -> None:
        with open(filename, 'w') as f:
            f.write(self.pretty_text)

    # --------------------------------------------------------------- merging
    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge ``{'a.b.c': v}``-style CLI options into the config
        (reference semantics: tools/train.py:90 ``cfg.merge_from_dict``).
        Integer keys index into lists.
        """
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            parts = full_key.split('.')
            for k in parts[:-1]:
                d = d.setdefault(k, {})
            d[parts[-1]] = v
        merged = _merge_options(option_cfg, _unwrap(self._cfg_dict))
        object.__setattr__(self, '_cfg_dict', wrap_cfg(merged))


def _merge_options(a: dict, b: Any) -> Any:
    if isinstance(b, list):
        out = list(b)
        for k, v in a.items():
            idx = int(k)
            if idx >= len(out):
                raise IndexError(f'index {idx} out of range for list of '
                                 f'length {len(out)}')
            out[idx] = (_merge_options(v, out[idx])
                        if isinstance(v, dict) else v)
        return out
    if not isinstance(b, dict):
        return {k: v for k, v in a.items()} if isinstance(a, dict) else a
    out = dict(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in out and isinstance(out[k], (dict, list)):
            out[k] = _merge_options(v, out[k])
        else:
            out[k] = v
    return out


def _unwrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _unwrap(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unwrap(v) for v in obj)
    return obj


class DictAction(argparse.Action):
    """argparse action for ``KEY=VALUE`` pairs with dotted keys and
    python-literal values (reference: mmcv DictAction used by
    tools/train.py:55-64)."""

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, _, val = kv.partition('=')
            options[key] = parse_value(val)
        setattr(namespace, self.dest, options)


def parse_value(val: str) -> Any:
    """A CLI value string as a python literal (int, float, bool, None,
    tuple, list or str)."""
    try:
        return ast.literal_eval(val)
    except (ValueError, SyntaxError):
        pass
    low = val.lower()
    if low in ('true', 'false'):
        return low == 'true'
    if low in ('none', 'null'):
        return None
    if ',' in val:
        return tuple(parse_value(v) for v in val.split(','))
    return val
