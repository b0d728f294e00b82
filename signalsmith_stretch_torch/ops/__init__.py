"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

Each wrapper here, and wavefront.sweep, runs its kernel on a CUDA tensor
and its plain version on a CPU tensor, or on any device inside `plain()`."""
import contextlib
import contextvars

import torch

_PLAIN = contextvars.ContextVar("sst_plain", default=False)


@contextlib.contextmanager
def plain(on: bool = True):
    """The plain versions inside the block when `on`; plain(False) leaves
    an enclosing plain() in force."""
    token = _PLAIN.set(_PLAIN.get() or bool(on))
    try:
        yield
    finally:
        _PLAIN.reset(token)


def runs_plain(where) -> bool:
    """Whether a wrapper runs its plain version on a tensor or device."""
    dev = where.device if isinstance(where, torch.Tensor) else where
    return torch.device(dev).type == "cpu" or _PLAIN.get()
