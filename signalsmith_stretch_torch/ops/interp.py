"""Fractional-bin interpolation (kernel A, csrc/interp.cu).

`interp_multi` is the port of the TPU kernel
signalsmith_stretch_tpu/ops/pallas/interp.py:interp_multi: several position
sets over one stack of planes, each set reading the first `nsel` planes as
a lerp or as raw (lo, hi) taps, zero outside [0, W0).  On a CPU tensor, or
inside ops.plain(), it runs the plain version (`_interp_gather` per plane);
on a CUDA tensor it launches the kernel or raises.  `pack` and `unpack` lay
complex and real rows out as planes the way the JAX package's windowed
interpolator does.  `_interp_shift_static` is the gather-free form for
positions b - shift[k] with host-known shifts (the unmapped planner's
votes).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..tables import on_device
from . import _build, runs_plain

launches = 0          # kernel launches of interp_multi
MAX_SETS = 8          # position sets one launch takes (csrc/interp.cu)


def _interp_gather(rows: torch.Tensor, pos: torch.Tensor, taps: bool = False):
    """rows [..., W0], pos [..., B] (leading dims equal) -> lerp [..., B],
    or the (lo, hi) taps, zero outside [0, W0).  lo, hi - lo, * frac and +
    are separate ops, so each rounds on its own."""
    W0 = rows.shape[-1]
    low = torch.floor(pos)
    frac = pos - low
    # validity from the float floor, as the kernel: a NaN position reads 0
    vlo = (low >= 0) & (low < W0)
    vhi = (low >= -1) & (low < W0 - 1)
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    li = torch.where(vlo, low, 0).to(torch.int64)
    hi_i = torch.where(vhi, low + 1, 0).to(torch.int64)
    lo = torch.where(vlo, torch.gather(rows, -1, li), zero)
    hi = torch.where(vhi, torch.gather(rows, -1, hi_i), zero)
    if taps:
        return lo, hi
    return lo + (hi - lo) * frac


def interp_multi_plain(planes: torch.Tensor, pos_sets):
    """Plain version of interp_multi (same contract)."""
    results = []
    for pos, nsel, taps in pos_sets:
        sel = planes[:, :nsel]
        p = pos[:, None, :].expand(-1, nsel, -1)
        results.append(_interp_gather(sel, p, taps))
    return results, 0


def _is_stacked(pos: torch.Tensor, pos_sets) -> bool:
    """pos is contiguous [rows, len(pos_sets), B] and pos[:, k] is the very
    tensor of set k (same storage, shape and strides)."""
    if not (pos.is_contiguous() and pos.dim() == 3
            and pos.shape[1] == len(pos_sets)):
        return False
    return all(p.data_ptr() == pos[:, k].data_ptr()
               and p.shape == pos[:, k].shape
               and p.stride() == pos[:, k].stride()
               for k, (p, _, _) in enumerate(pos_sets))


def interp_multi(planes: torch.Tensor, pos_sets, pos=None):
    """planes [rows, n, W0] f32; pos_sets: list of (pos [rows, B] f32, nsel,
    taps).  Returns (per-set results, violations): set k gives [rows, nsel, B]
    (lerp) or a (lo, hi) pair of them (taps).  There is no capacity window
    on this card, so violations is always 0.  pos, if given, is the sets'
    positions already stacked, a contiguous [rows, len(pos_sets), B] f32
    tensor whose slice pos[:, k] is set k's (kernel G writes them so): the
    kernel reads it as it is, with no stack."""
    global launches
    if runs_plain(planes):
        return interp_multi_plain(planes, pos_sets)
    if not 0 < len(pos_sets) <= MAX_SETS:
        raise ValueError(f"interp_multi: 1..{MAX_SETS} position sets expected")
    rows, n, W0 = planes.shape
    B = pos_sets[0][0].shape[1]
    if pos is None:
        pos = torch.stack([p for p, _, _ in pos_sets], 1).contiguous()
    elif not _is_stacked(pos, pos_sets):
        raise ValueError("interp_multi: pos must be a contiguous [rows, sets, "
                         "B] tensor whose slice pos[:, k] is set k's "
                         "positions")
    _build.require_cuda(planes, pos)
    if planes.dtype != torch.float32 or pos.dtype != torch.float32:
        raise TypeError("interp_multi: float32 planes and positions expected")
    if pos.shape != (rows, len(pos_sets), B):
        raise ValueError(f"interp_multi: positions {tuple(pos.shape)} do not "
                         f"match {rows} rows")
    meta, o = [], 0
    for _, nsel, taps in pos_sets:
        if not 0 < nsel <= n:
            raise ValueError(f"interp_multi: nsel {nsel} outside 1..{n}")
        meta += [nsel, int(bool(taps)), o]
        o += 2 * nsel if taps else nsel
    out = torch.empty((rows, o, B), dtype=torch.float32, device=planes.device)
    meta_c = (ctypes.c_int * len(meta))(*meta)      # read on the host
    rc = _build.entry("interp")(
        planes.data_ptr(), pos.data_ptr(), meta_c, out.data_ptr(), rows, n,
        W0, B, len(pos_sets), o,
        torch.cuda.current_stream(planes.device).cuda_stream)
    _build.check(rc, "sst_interp_multi")
    launches += 1
    results, o = [], 0
    for _, nsel, taps in pos_sets:
        if taps:
            results.append((out[:, o:o + nsel], out[:, o + nsel:o + 2 * nsel]))
            o += 2 * nsel
        else:
            results.append(out[:, o:o + nsel])
            o += nsel
    return results, 0


def pack(rows_list, specs):
    """Stack rows into interp_multi's planes the way the JAX package's
    windowed interpolator does: a complex row packs as its real and
    imaginary planes.  rows_list: [R, W0] tensors (float32 or complex64);
    specs: list of (pos [R, B], n_rows), each set reading the FIRST n_rows
    rows.  Returns (planes [R, n, W0], pos_sets, kinds)."""
    planes, kinds, offsets = [], [], []
    for r in rows_list:
        offsets.append(len(planes))
        if r.is_complex():
            planes += [r.real, r.imag]
            kinds.append("c")
        else:
            planes.append(r)
            kinds.append("f")
    offsets.append(len(planes))
    pos_sets = [(pos, offsets[n_rows], False) for pos, n_rows in specs]
    return torch.stack(planes, 1), pos_sets, kinds


def unpack(results, specs, kinds):
    """Per-set interp_multi results -> per-set lists of [R, B] tensors,
    complex where the packed row was."""
    outs = []
    for (_, n_rows), vals in zip(specs, results):
        out, i = [], 0
        for k in kinds[:n_rows]:
            if k == "c":
                out.append(torch.complex(vals[:, i], vals[:, i + 1]))
                i += 2
            else:
                out.append(vals[:, i])
                i += 1
        outs.append(out)
    return outs


def shift_taps(shift: np.ndarray, B: int):
    """The static tap choice of `_interp_shift_static` for one float32
    shift vector: the distinct tap shifts, a bin mask for each shift after
    the first, and the fractions.  A plan's time factors are the same for
    every render, so this numpy work (tens of ms at 48 kHz) is done once
    (on_device)."""
    b = np.arange(B, dtype=np.float32)
    shift = np.asarray(shift, np.float32)
    p = (b[None, :] - shift[:, None]).astype(np.float32)
    li = np.floor(p)
    frac = (p - li).astype(np.float32)
    s_lo = np.arange(B, dtype=np.int64)[None, :] - li.astype(np.int64)
    assert (s_lo >= 1).all(), "static shift interp expects shift >= 0.5"
    svals = [int(s) for s in np.unique(s_lo)]
    return svals, tuple(s_lo == s for s in svals[1:]), frac


def _interp_shift_static(rows: torch.Tensor, shift_np: np.ndarray):
    """rows [..., nB, B] interpolated at positions float32(b) - shift_np[k].

    The shifts are host-side float32 (the schedule's time factors are
    static), so floor, frac and the per-bin tap choice are numpy with the
    same IEEE float32 ops, and the device work is a select/lerp over a few
    statically shifted row views (one per distinct tap shift)."""
    B = rows.shape[-1]
    svals, masks, frac = on_device(shift_np, rows.device, shift_taps, B)

    views = {}

    def view(s):
        if s not in views:
            views[s] = torch.nn.functional.pad(rows[..., :max(B - s, 0)],
                                               (min(s, B), 0))
        return views[s]

    v_lo = view(svals[0])
    v_hi = view(svals[0] - 1)
    for s, m in zip(svals[1:], masks):
        v_lo = torch.where(m, view(s), v_lo)
        v_hi = torch.where(m, view(s - 1), v_hi)
    return v_lo + (v_hi - v_lo) * frac
