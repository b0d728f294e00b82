"""Energy slew smoothing along bins (kernel C, csrc/scan.cu).

y_b = y_{b-1} + (x_b - y_{b-1}) * slew, serial in the reference's order
(signalsmith-stretch.h:816-848).  On a CPU tensor the wrappers run the plain
PyTorch loop; on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0          # kernel launches of iir_forward / iir_backward


def iir_plain(x: torch.Tensor, init: torch.Tensor, slew: float,
              backward: bool = False):
    """Plain version: a loop over bins.  x [..., B], init [...] ->
    (y [..., B], final [...]) where final is the last value computed."""
    B = x.shape[-1]
    y = torch.empty_like(x)
    v = init
    for b in (range(B - 1, -1, -1) if backward else range(B)):
        v = v + (x[..., b] - v) * slew
        y[..., b] = v
    return y, v


def iir(x: torch.Tensor, init: torch.Tensor, slew: float,
        backward: bool = False):
    """Kernel wrapper: x [R, B] f32, init [R] f32 -> (y, final)."""
    global launches
    if x.device.type == "cpu":
        return iir_plain(x, init, slew, backward)
    _build.require_cuda(x, init)
    if x.dtype != torch.float32 or init.dtype != torch.float32:
        raise TypeError("iir: float32 tensors expected")
    if x.dim() != 2 or init.shape != x.shape[:1]:
        raise ValueError(f"iir: x [R, B] and init [R] expected, got "
                         f"{tuple(x.shape)} and {tuple(init.shape)}")
    B = x.shape[-1]
    y = torch.empty_like(x)
    fin = torch.empty_like(init)
    rc = _build.entry("scan")(
        x.data_ptr(), init.data_ptr(), y.data_ptr(), fin.data_ptr(),
        init.numel(), B, slew, int(backward),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "sst_iir")
    launches += 1
    return y, fin


def iir_forward(x: torch.Tensor, init: torch.Tensor, slew: float):
    """Forward along the last axis -> (y, y[..., -1])."""
    return iir(x, init, slew)


def iir_backward(x: torch.Tensor, init: torch.Tensor, slew: float):
    """Backward along the last axis -> (y, y[..., 0])."""
    return iir(x, init, slew, backward=True)
