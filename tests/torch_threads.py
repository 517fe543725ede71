"""The torch CPU thread cap of the port's tests (``tests/test_torch_*.py``).

Every pytest-xdist worker imports every test module at collection, and
each worker would otherwise run torch's intra-op pool at the machine's
full core count beside XLA's own pool: six workers on eight cores then
oversubscribe the machine many times over, and the port's tests run
several times slower. So each test_torch_* module calls
:func:`cap_torch_threads` at import, which holds the cap for the whole
session of that process. ``DEFAULT_THREADS`` is torch's own count before
the cap, for the tests whose exactness depends on torch's summation order
(:func:`default_threads`).
"""
import contextlib

import torch

# torch's intra-op threads a worker runs the port's tests with
TORCH_THREADS = 1
DEFAULT_THREADS = torch.get_num_threads()


def cap_torch_threads() -> None:
    torch.set_num_threads(TORCH_THREADS)


@contextlib.contextmanager
def default_threads():
    """Run the block at torch's default thread count, then restore the
    cap."""
    before = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)
