"""The least time a stage's work can take on one H100, from the shapes of
its arguments and its result.

The peaks and `bound_ms` are copied from chip_smoke.py: NVIDIA's data sheet
for the H100 SXM at its full 700 W, HBM at 3.35 TB/s and float32 outside
the tensor cores at 67 TFLOP/s.  A stage's bytes are each input byte read
once and each output byte written once; the stages measured here
(the plan and the sweep) are counted by their bytes alone."""
from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound_ms(nbytes, flops):
    """The least time for the work: bytes at the HBM rate or flops at the
    float32 rate, whichever is longer; and which of the two it is."""
    tb, to = nbytes / PEAK_BYTES, flops / PEAK_F32
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def nbytes(value) -> int:
    """The bytes of every tensor in value (a tensor, or nested tuples,
    lists and dicts of them)."""
    if hasattr(value, "element_size") and hasattr(value, "numel"):
        return value.element_size() * value.numel()
    if isinstance(value, dict):
        return sum(nbytes(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return sum(nbytes(v) for v in value)
    return 0


def stage_bound_ms(args, result) -> float:
    """A stage call's byte bound: its tensor arguments read once and its
    result written once."""
    return bound_ms(nbytes(args) + nbytes(result), 0)[0]
