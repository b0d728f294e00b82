"""The prediction coefficients of the offline planner (kernel J,
csrc/coefficients.cu).

The last phase of `planner.plan_spectral` (signalsmith-stretch.h:722-803;
the JAX package's planner.py:562-690): the chain coefficient c1 of every
channel, the loudest channel mc, and the four vote coefficients a1, a2, d1,
d2 that the diagonal sweep reads.  `coefficients` launches J once on a CUDA
tensor (or raises); on a CPU tensor, or inside ops.plain(), it runs
`coefficients_plain`, the same arithmetic as PyTorch operations.  Every
complex product is written as separate float32 products and sums, which is
how the CPU rounds torch's complex multiply and how J rounds (built with
--fmad=false): the card's own complex multiply may contract into fused
multiply-adds.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import NOISE_FLOOR
from ..tables import on_device
from . import _build, runs_plain

launches = 0          # kernel launches of coefficients


def _cmul(a, b):
    """a * b, each product and sum a float32 op of its own."""
    return torch.complex(a.real * b.real - a.imag * b.imag,
                         a.real * b.imag + a.imag * b.real)


def _cmulc(a, b):
    """a * conj(b), each product and sum a float32 op of its own."""
    return torch.complex(a.real * b.real + a.imag * b.imag,
                         a.imag * b.real - a.real * b.imag)


def _sel(mc, items):
    out = torch.zeros_like(items[0])
    for c, it in enumerate(items):
        out = torch.where(mc == c, it, out)
    return out


def shift_up(x, n):
    """x[..., b] -> x[..., b+n] (zeros beyond the end)."""
    return F.pad(x[..., n:], (0, n))


def where0(cond, x):
    return torch.where(cond, x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def coefficients_plain(pi, prev_i, pe, votes, rotor, new, longv: int):
    """Plain version of `coefficients` (same contract)."""
    B = pi[0].shape[-1]
    dev = rotor.device
    ch = len(pi)
    pe_prev = [F.pad(x[:, :-1], (0, 0, 1, 0)) for x in pe]
    if new.all():
        rotor_eff = rotor
    else:
        rotor_eff = torch.where(
            on_device(np.asarray(new, np.bool_), dev)[:, None],
            rotor, torch.ones((), dtype=rotor.dtype, device=dev))  # [nB, B]
    c1 = []
    for c in range(ch):
        u = _cmul(rotor_eff, _cmulc(pi[c], prev_i[c]))
        den = torch.maximum(pe_prev[c], pe[c]) + NOISE_FLOOR
        c1.append(torch.complex(u.real / den, u.imag / den))

    mc = torch.argmax(torch.stack(pe, 0), 0).to(torch.int32)
    pi_max = _sel(mc, pi)
    b_idx = torch.arange(B, device=dev)
    sd, ld = votes[:2]
    d1 = where0(b_idx > 0, _cmulc(pi_max, _sel(mc, sd)))
    d2 = where0(b_idx >= longv, _cmulc(pi_max, _sel(mc, ld)))
    if len(votes) == 4:
        # the votes drawn above 2x: the up votes are their own lookups
        up_short, up_long = _sel(mc, votes[2]), _sel(mc, votes[3])
    else:
        # both vote branches use the same binTimeFactor, so the up
        # positions are the down positions shifted one (or longv) bins up
        # (:764-786)
        up_short = _sel(mc, [shift_up(x, 1) for x in sd])
        up_long = _sel(mc, [shift_up(x, longv) for x in ld])
    pi_up1 = _sel(mc, [shift_up(x, 1) for x in pi])
    pi_upl = _sel(mc, [shift_up(x, longv) for x in pi])
    c1_up1 = _sel(mc, [shift_up(x, 1) for x in c1])
    c1_upl = _sel(mc, [shift_up(x, longv) for x in c1])
    a1 = where0(b_idx < B - 1, _cmulc(c1_up1, _cmulc(pi_up1, up_short)))
    a2 = where0(b_idx < B - longv, _cmulc(c1_upl, _cmulc(pi_upl, up_long)))
    return a1, a2, d1, d2, mc


def coefficients(pi, prev_i, pe, votes, rotor, new, longv: int):
    """The prediction coefficients of a batch.  pi, prev_i: ch complex64
    [batch, nB, B] planes (the prediction inputs and the rotated previous
    inputs), pe: ch float32 planes (the prediction energies), votes: the
    vote lookups (short down, long down), or with the up votes drawn above
    2x (short down, long down, short up, long up), each ch complex64
    planes; any clip and block strides, unit bin stride.  rotor: [B]
    complex64 on the planes' device; new: the schedule's [nB] new_spectrum
    flags (numpy); longv: the long vertical step.  Returns (a1, a2, d1,
    d2) complex64 and mc int32, each [batch, nB, B] and contiguous."""
    global launches
    if runs_plain(rotor):
        return coefficients_plain(pi, prev_i, pe, votes, rotor, new, longv)
    ch = len(pi)
    if ch < 1 or len(prev_i) != ch or len(pe) != ch or len(votes) not in (
            2, 4) or any(len(v) != ch for v in votes):
        raise ValueError("coefficients: ch planes each of pi, prev_i, pe "
                         "and of 2 or 4 vote sets expected")
    batch, nB, B = pi[0].shape
    dev = rotor.device
    planes = [p if p.stride(-1) == 1 else p.contiguous()
              for p in [*pi, *prev_i, *pe, *(p for v in votes for p in v)]]
    _build.require_cuda(rotor)
    if any(p.device != dev for p in planes):
        raise ValueError("coefficients: inputs on more than one device")
    if (any(p.dtype != torch.complex64
            for p in planes[:2 * ch] + planes[3 * ch:])
            or any(p.dtype != torch.float32 for p in planes[2 * ch:3 * ch])
            or rotor.dtype != torch.complex64):
        raise TypeError("coefficients: complex64 inputs, votes and rotor, "
                        "float32 energies expected")
    if any(p.shape != (batch, nB, B) for p in planes) or rotor.shape != (B,):
        raise ValueError("coefficients: [batch, nB, B] planes and a [B] "
                         "rotor expected")
    if longv < 1 or len(new) != nB:
        raise ValueError(f"coefficients: LV {longv}, {len(new)} block flags "
                         f"for {nB} blocks")
    # the plane table, (pointer, clip stride, block stride) in bytes, in
    # device memory: any channel count.  Copied from pinned memory, so the
    # copy does not hold the host (the caching host allocator keeps the
    # block until the copy has run)
    table = torch.tensor([(p.data_ptr(), p.stride(0) * p.element_size(),
                           p.stride(1) * p.element_size()) for p in planes],
                         dtype=torch.int64)
    table = table.pin_memory().to(dev, non_blocking=True)
    new = np.asarray(new, np.bool_)
    fresh = None if new.all() else on_device(new, dev).data_ptr()
    # mc before the four planes: in this order a render's later calls find
    # every block in the caching allocator's pool (cli_dev's allocation
    # guard at 1.25x +3 semitones; the other order makes one segment more
    # in the second call)
    mc = torch.empty((batch, nB, B), dtype=torch.int32, device=dev)
    out = torch.empty((4, batch, nB, B), dtype=torch.complex64, device=dev)
    rc = _build.entry("coefficients")(
        table.data_ptr(), rotor.data_ptr(), fresh,
        *(o.data_ptr() for o in out), mc.data_ptr(), batch, nB, B, ch,
        longv, int(len(votes) == 4),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sst_coefficients")
    launches += 1
    return out[0], out[1], out[2], out[3], mc
