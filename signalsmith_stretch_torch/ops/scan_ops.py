"""Serial scans along bins: kernels C, E and F.

- C (csrc/scan.cu), the energy slew smoothing
  y_b = y_{b-1} + (x_b - y_{b-1}) * slew (signalsmith-stretch.h:816-848);
- E (csrc/decay.cu), the formant envelope's decay passes
  y_b = op(x_b, d * y_{b-1}) with op the C++ std::max / std::min, which
  keeps x_b when the product is NaN (:984-1007);
- F (csrc/top3.cu), the pitch estimator's top-3 local-maximum insertion
  (:931-948; plain version `spectral._top3_local_maxima`).

Each runs serially in the reference's order.  On a CPU tensor the wrappers
run the plain PyTorch loop; on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import _build
from .. import spectral

launches = 0          # kernel launches of iir_forward / iir_backward (C)
decay_launches = 0    # kernel launches of the decay scans (E)
top3_launches = 0     # kernel launches of top3_local_maxima (F)


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


def decay_plain(x: torch.Tensor, init: torch.Tensor, coef: torch.Tensor,
                is_min: bool, backward: bool = False):
    """Plain version of the decay scans: a loop over bins.  x [R, B], init
    and the per-row coefficient coef [R] -> (y [R, B], final [R])."""
    B = x.shape[-1]
    y = torch.empty_like(x)
    v = init
    for b in (range(B - 1, -1, -1) if backward else range(B)):
        a, t = x[:, b], coef * v
        v = torch.where(t < a, t, a) if is_min else torch.where(a < t, t, a)
        y[:, b] = v
    return y, v


def decay(x: torch.Tensor, init: torch.Tensor, coef: torch.Tensor,
          is_min: bool, backward: bool = False):
    """Kernel wrapper (E): x [R, B] f32, init and coef [R] f32 ->
    (y, final), y_b = min or max(x_b, coef * y_{b-1}) along the last axis
    (backward: from the last bin down), final the last value computed."""
    global decay_launches
    if x.device.type == "cpu":
        return decay_plain(x, init, coef, is_min, backward)
    _build.require_cuda(x, init, coef)
    if not x.dtype == init.dtype == coef.dtype == torch.float32:
        raise TypeError("decay: float32 tensors expected")
    if x.dim() != 2 or init.shape != x.shape[:1] or coef.shape != init.shape:
        raise ValueError(f"decay: x [R, B], init and coef [R] expected, got "
                         f"{tuple(x.shape)}, {tuple(init.shape)} and "
                         f"{tuple(coef.shape)}")
    y = torch.empty_like(x)
    fin = torch.empty_like(init)
    rc = _build.entry("decay")(
        x.data_ptr(), init.data_ptr(), coef.data_ptr(), y.data_ptr(),
        fin.data_ptr(), x.shape[0], x.shape[1], int(is_min), int(backward),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "sst_decay")
    decay_launches += 1
    return y, fin



def top3_local_maxima(metric: torch.Tensor):
    """Kernel wrapper (F): metric [R, B] f32 -> (i0, v0, i1, v1, i2, v2),
    each [R], indices int32 and values f32."""
    global top3_launches
    if metric.device.type == "cpu":
        return spectral._top3_local_maxima(metric)
    _build.require_cuda(metric)
    if metric.dtype != torch.float32 or metric.dim() != 2:
        raise TypeError("top3_local_maxima: a float32 [R, B] metric expected")
    R, B = metric.shape
    if B < 3:
        raise ValueError(f"top3_local_maxima: {B} bins, at least 3 expected")
    idx = torch.empty((3, R), dtype=torch.int32, device=metric.device)
    val = torch.empty((3, R), dtype=torch.float32, device=metric.device)
    rc = _build.entry("top3")(
        metric.data_ptr(), idx.data_ptr(), val.data_ptr(), R, B,
        torch.cuda.current_stream(metric.device).cuda_stream)
    _build.check(rc, "sst_top3")
    top3_launches += 1
    return idx[0], val[0], idx[1], val[1], idx[2], val[2]
