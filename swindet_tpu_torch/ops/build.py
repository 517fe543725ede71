"""Build and load the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, which is loaded with ``ctypes``.
A library is named after a hash of its source, the shared headers and the
compiler flags, so an edited source is rebuilt and an unchanged one is
reused. Libraries go to ``build/kernels/`` at the root of the checkout.
Nothing is built when this module is imported: the first wrapper that
launches a kernel builds its library, and :func:`build` builds them all at
once, one ``nvcc`` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
KERNELS = ('layer_norm', 'window_attention', 'conv3x3', 'roi_align', 'nms',
           'fused_mlp', 'window_attention_v4')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-lineinfo', '-shared', '-Xcompiler', '-fPIC')

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def nvcc_path() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = Path(cuda_home) / 'bin' / 'nvcc'
    if cand.is_file():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'swindet_tpu_torch need the CUDA toolkit')
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f'{name}.cu', *sorted(CSRC.glob('*.cuh'))):
        h.update(part.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source in parallel. Raises with the compiler's output if
    any build fails. Returns name -> library path."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs: Dict[str, Tuple[subprocess.Popen, str]] = {}
    try:
        for name, path in todo.items():
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, str(CSRC / f'{name}.cu')]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f'--- {name} (nvcc exit {proc.returncode})\n'
                              f'{log}')
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))


@functools.lru_cache(maxsize=None)
def bind(name: str, symbol: str, argtypes: tuple):
    """C entry point ``symbol`` of library ``name`` with its argument
    types declared; it returns the launch's CUDA status."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(kernel: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f'{kernel} kernel launch failed with CUDA error '
                           f'{status}')


def check_aligned(kernel: str, *tensors: torch.Tensor) -> None:
    """The tensor-core kernels (TMA boxes or cp.async copies) and the
    RoIAlign kernels (vector loads) read tensors in 16-byte pieces, from
    16-byte aligned bases."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f'{kernel}: tensors must start on a 16-byte '
                             f'boundary')


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor, kernel: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f'{kernel} kernel takes float32 or bfloat16, got '
                        f'{t.dtype}')
    return DTYPE_CODES[t.dtype]
