"""The offline render above 2x in plain PyTorch: the randomised unmapped
plan, with render.py's analysis, sweep and synthesis.

Above maxCleanStretch = 2 (signalsmith-stretch.h:509, 639-640) the
reference stops using one time factor for every bin of a block: each bin's
votes read the input at positions drawn per bin (:747-757, 764-786).  A
frozen copy of the plain path of signalsmith_stretch_torch's planner
(planner.py `plan_spectral`, unmapped, above 2x; ops/coefficients.py
`coefficients_plain`) for the benchmark's configurations:

- the per-bin draws btf1 (down votes) and btf2 (up votes) of each clip,
  from its seed (draws.py);
- the four vote position sets about the identity map: b - btf1,
  b - LV*btf1, b+1 - btf2 and b+LV - LV*btf2, the shifted bins zero above
  the top (their positions go negative: the lookup reads 0 there, and a1,
  a2 mask those bins);
- a plain lookup of every channel's input at each set (spectral.interp);
- the chain coefficient c1, the loudest channel and the vote coefficients
  a1, a2, d1, d2, with the drawn up votes in place of the shifted down
  votes.

All arithmetic is float32, every complex product written as separate
float32 products and sums (as the port's plain version and its kernel
round them).  `render` turns TF32 off for matrix products and
convolutions.  `q` rounds each stage's outputs to the precision the render
is computed in (the identity for float32; spectral.round_bf16 for the
control).  Departures
from the C++: the draws are JAX's Threefry bits (draws.py), not
`std::default_random_engine`'s.  It imports nothing of the port.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import draws, spectral
from . import render as base
from .geometry import NOISE_FLOOR

def _cmul(a, b):
    """a * b, each product and sum a float32 op of its own."""
    return torch.complex(a.real * b.real - a.imag * b.imag,
                         a.real * b.imag + a.imag * b.real)


def _cmulc(a, b):
    """a * conj(b), each product and sum a float32 op of its own."""
    return torch.complex(a.real * b.real + a.imag * b.imag,
                         a.imag * b.real - a.real * b.imag)


def _chains(spectra, prev_spectra, arrays, rotor):
    """The input and prevInput chains over the block schedule (:332-376,
    806-812): (input, rotated prevInput), each [batch, nB, ch, B]."""
    dev = spectra.device
    nB = spectra.shape[1]
    new, reanalyse = arrays["new_spectrum"], arrays["reanalyse"]

    def blocks(z, idx):
        return z[:, torch.as_tensor(idx, device=dev)]

    def bmask(keep):
        return torch.as_tensor(keep, device=dev)[None, :, None, None]

    idx = np.arange(nB)
    src_input = np.maximum.accumulate(np.where(new, idx, -1))
    m_prev = np.concatenate([[-1], src_input[:-1]])
    if (src_input == idx).all():
        input_eff = spectra
    else:
        input_eff = spectral.where0(bmask(src_input >= 0),
                                    blocks(spectra, np.maximum(src_input, 0)))
    if reanalyse.all():
        prev_base = prev_spectra
    else:
        base_idx = np.where(new & ~reanalyse, np.maximum(m_prev, 0),
                            np.maximum(src_input, 0))
        base_valid = np.where(new & ~reanalyse, m_prev >= 0, src_input >= 0)
        prev_base = torch.where(bmask(reanalyse), prev_spectra,
                                blocks(spectra, base_idx))
        prev_base = spectral.where0(bmask(base_valid | reanalyse), prev_base)
    if new.all():
        prev_eff = prev_base * rotor
    else:
        prev_eff = torch.where(bmask(new), prev_base * rotor, prev_base)
    return input_eff, prev_eff


def vote_positions(B: int, btf1, btf2, longv: int, device):
    """The four vote position sets [R, B] (short and long down, short and
    long up), each product and subtraction a float32 op of its own."""
    base = torch.arange(B, dtype=torch.float32, device=device)
    return [base - btf1, base - float(longv) * btf1,
            spectral.shift_up(base, 1) - btf2,
            spectral.shift_up(base, longv) - float(longv) * btf2]


def plan_spectral(spectra: torch.Tensor, prev_spectra: torch.Tensor,
                  arrays: dict, controls: spectral.Controls,
                  consts: spectral.SpectralConsts,
                  seeds) -> base.SweepInputs:
    """spectra/prev_spectra [batch, nB, ch, B] complex64, one seed a clip
    -> SweepInputs of the randomised unmapped plan."""
    if controls.mapped:
        raise ValueError("the randomised reference covers the unmapped plan")
    batch, nB, ch, B = spectra.shape
    seeds = [int(s) for s in seeds]
    if len(seeds) != batch:
        raise ValueError(f"{len(seeds)} seeds for {batch} clips")
    dev = spectra.device
    longv = consts.long_vertical_step
    new = arrays["new_spectrum"]
    R = batch * nB
    rotor = torch.as_tensor(consts.rotor, device=dev)
    input_eff, prev_eff = _chains(spectra, prev_spectra, arrays, rotor)
    in_energy = (input_eff.real * input_eff.real
                 + input_eff.imag * input_eff.imag)     # [batch, nB, ch, B]
    pe = [in_energy[:, :, c] for c in range(ch)]
    pi = [input_eff[:, :, c] for c in range(ch)]
    prev_i = [prev_eff[:, :, c] for c in range(ch)]

    btf1, btf2 = (t.reshape(R, B) for t in draws.factors(
        seeds, arrays["time_factor"], B, dev))
    pos = vote_positions(B, btf1, btf2, longv, dev)
    del btf1, btf2
    # votes[k][c]: channel c's input at position set k
    votes = [[spectral.interp(p.reshape(R, B), at).reshape(batch, nB, B)
              for p in pi] for at in pos]
    del pos

    pe_prev = [F.pad(x[:, :-1], (0, 0, 1, 0)) for x in pe]
    if new.all():
        rotor_eff = rotor
    else:
        rotor_eff = torch.where(torch.as_tensor(new, device=dev)[:, None],
                                rotor, torch.ones((), dtype=rotor.dtype,
                                                  device=dev))
    c1 = []
    for c in range(ch):
        u = _cmul(rotor_eff, _cmulc(pi[c], prev_i[c]))
        den = torch.maximum(pe_prev[c], pe[c]) + NOISE_FLOOR
        c1.append(torch.complex(u.real / den, u.imag / den))

    # the main prediction's coefficients (:722-803), the up votes drawn
    mc = torch.argmax(torch.stack(pe, 0), 0).to(torch.int32)
    sel, up, where0 = spectral.sel, spectral.shift_up, spectral.where0
    pi_max = sel(mc, pi)
    b_idx = torch.arange(B, device=dev)
    sd, ld, su, lu = votes
    d1 = where0(b_idx > 0, _cmulc(pi_max, sel(mc, sd)))
    d2 = where0(b_idx >= longv, _cmulc(pi_max, sel(mc, ld)))
    pi_up1 = sel(mc, [up(x, 1) for x in pi])
    pi_upl = sel(mc, [up(x, longv) for x in pi])
    c1_up1 = sel(mc, [up(x, 1) for x in c1])
    c1_upl = sel(mc, [up(x, longv) for x in c1])
    a1 = where0(b_idx < B - 1, _cmulc(c1_up1, _cmulc(pi_up1, sel(mc, su))))
    a2 = where0(b_idx < B - longv,
                _cmulc(c1_upl, _cmulc(pi_upl, sel(mc, lu))))
    return base.SweepInputs(a1=a1, a2=a2, d1=d1, d2=d2, mc=mc,
                            pe=tuple(pe), pi=tuple(pi))


def render(audio: torch.Tensor, plan: base.ExactPlan,
           controls: spectral.Controls, seeds,
           q=spectral.identity) -> torch.Tensor:
    """audio [batch, ch, in] float32, one seed a clip -> [batch, ch, out]:
    exact() of each clip above 2x, with the silence bypass.  TF32 is off
    for the call (and put back after it)."""
    if not plan.sched.valid:
        return audio.new_zeros(audio.shape[:2] + (plan.sched.out_samples,))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        audio = q(audio)
        spectra, prev = base.analyze_stage(audio, plan)
        inputs = base._q_inputs(plan_spectral(
            q(spectra), q(prev), plan.arrays, controls, plan.consts, seeds),
            q)
        del spectra, prev
        out_specs = q(base.sweep(inputs, plan.consts.long_vertical_step))
        del inputs
        return q(base.synthesis_stage(out_specs, plan, audio=audio))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
