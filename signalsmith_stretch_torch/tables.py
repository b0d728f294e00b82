"""The render's constant tables on a device: read-only host arrays of a
plan (the schedule's and what is derived from them) or of a configuration
(the rotor, the STFT basis, the WOLA weights), each copied once a device,
keyed by the array's identity, and dropped when the array is collected.
A table that changes is a new array."""
from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

_copies: dict = {}
_lock = threading.Lock()


def _to(value, dev: torch.device):
    if isinstance(value, tuple):
        return tuple(_to(v, dev) for v in value)
    if isinstance(value, np.ndarray):
        return torch.tensor(value, device=dev)
    return value


def on_device(a: np.ndarray, device, derive=None, *args):
    """`a`, or derive(a, *args) (a module-level function; a tuple's arrays
    copied, its other items kept), on `device`: made on the first call for
    (a, device, derive, args), dropped when `a` is collected."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (id(a), dev, derive, args)
    with _lock:
        got = _copies.get(key)
        if got is None:
            got = _to(a if derive is None else derive(a, *args), dev)
            weakref.finalize(a, _copies.pop, key, None).atexit = False
            _copies[key] = got
    return got


def prepare(plan, controls, flags, device):
    """Make on `device` every table a render of `plan` under `controls` and
    `flags` reads (engine.render_exact, kernels or plain versions)."""
    from . import engine, planner, stft
    from .config import MAX_CLEAN_STRETCH
    from .ops import dft, idft, interp
    if not plan.sched.valid:
        return
    arrays, basis, sil = plan.arrays, plan.basis, plan.silence
    for a in (plan.re_rows, plan.consts.rotor, plan.weight, basis.window,
              basis.twist, *arrays.values()):
        on_device(a, device)
    on_device(arrays["frame_starts"], device, engine.window_index)
    dft.consts(basis, device)
    idft.consts(basis, device)
    on_device(arrays["tf"], device, planner.draw_bounds)
    if not flags.mapped and not (arrays["tf"] > MAX_CLEAN_STRETCH).any():
        for shift in (arrays["tf"], arrays["ltf"]):
            on_device(shift, device, interp.shift_taps, basis.bands)
    if flags.process_formants and controls.automated:
        on_device(controls.formant_base_freq, device, planner.base_bands,
                  plan.consts.fft_samples)
    on_device(basis.twist, device, stft.twist_planes)
    if sil is not None and sil.possible:
        on_device(sil.pre_weight, device)
        on_device(sil.pm_weight, device)
        if sil.pass_idx is not None:
            on_device(sil.pass_idx, device, np.asarray, np.int64)
