"""signalsmith-stretch offline rendering in PyTorch, with hand-written CUDA
kernels for Hopper (csrc/).

`SignalsmithStretch` is the library object (presets, pitch and formant
setters, `exact` with automation); `models.StretchModel.build(...).batched
(clips)` renders a batch of clips; `python -m signalsmith_stretch_torch.cli`
is the command line.  Everything renders on the card (device="cuda", the
default) or, when asked for, on the CPU with the plain PyTorch versions of
the kernels.
"""
from .api import SignalsmithStretch  # noqa: F401
from .config import StretchConfig  # noqa: F401

__version__ = "0.1.0"
__all__ = ["SignalsmithStretch", "StretchConfig"]
