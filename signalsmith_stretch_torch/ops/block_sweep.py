"""One block's bin sweep (kernel H, csrc/block_sweep.cu).

`block_sweep` is the port of signalsmith_stretch_tpu/spectral.py:
_sweep_scan, the streaming engine's main-prediction recursion over the B
bins of one block (signalsmith-stretch.h:722-803).  For each bin b in
order, with mc = max_ch[b] the bin's loudest channel:

  phase    = pu + [b > 0] out[mc, b-1] st + [b >= LV] out[mc, b-LV] lt
  out_main = makeOutput(pe_max, pi_max, phase)
  out[c]   = out_main for c = mc, else makeOutput(pe[c], pi[c], out_main ct[c])

summed and multiplied in JAX's order, and rounded where XLA on the CPU
rounds: the compiled scan contracts each complex product x*y into two
fused multiply-adds, re = fma(xr, yr, -(xi*yi)) and im = fma(xi, yr,
xr*yi), and each squared magnitude r*r + i*i into fma(r, r, i*i)
(tests/test_torch_block.py holds the plain version bit-equal to the
compiled `_sweep_scan`).  The kernel rounds at the same places
(`__fmaf_rn`); everything else is one IEEE float32 operation each.

On a CPU tensor, or inside ops.plain(), the wrapper runs `block_sweep_plain`;
on a CUDA tensor it launches the kernel or raises.  The plain version is a
loop over bins, in numpy float32 on a CPU copy of its inputs (for a CUDA
tensor too: the card would run each of its small steps as a kernel launch).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build, runs_plain

f32 = np.float32
launches = 0          # kernel launches of block_sweep
NOISE_FLOOR = np.float32(1e-15)
# the kernel's tile of bins, its stage slots (csrc/block_sweep.cu TILE,
# SLOTS), and the shared memory ceiling on this card
TILE, SLOTS = 32, 3
SMEM_MAX = 227 * 1024


class BlockSweepInputs(NamedTuple):
    """One block's sweep inputs (JAX `_sweep_scan`'s, bin-major planes)."""
    st: torch.Tensor      # [B] complex64 short down-vote twist
    lt: torch.Tensor      # [B] complex64 long down-vote twist
    pu: torch.Tensor      # [B] complex64 the up votes (phase_up)
    pe_max: torch.Tensor  # [B] f32 the loudest channel's prediction energy
    pi_max: torch.Tensor  # [B] complex64 and its prediction input
    max_ch: torch.Tensor  # [B] int32 the loudest channel
    ct: torch.Tensor      # [ch, B] complex64 channel-lock twists
    pe: torch.Tensor      # [ch, B] f32 prediction energies
    pi: torch.Tensor      # [ch, B] complex64 prediction inputs


def _fma(a, b, c):
    """a * b + c on float32 numpy arrays, rounded once: the product is exact
    in float64, the sum is taken in float64 rounded to odd (its two-sum
    error decides the last bit), then rounded to float32 (prng.fma_f32's
    method)."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    odd = s.view(np.int64) & 1
    s = np.where((err != 0) & (odd == 0),
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _fma1(a, b, c) -> np.float32:
    """_fma on float32 scalars: the float64 sum rounded to float32, and
    where that sum is exactly halfway between two float32 values and not
    exact, the one on the side of its two-sum error."""
    p, c = float(a) * float(b), float(c)
    s = p + c
    r = f32(s)
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    if err != 0.0 and float(r) != s:
        nb = np.nextafter(r, f32(np.inf) if s > float(r) else f32(-np.inf))
        if (float(r) + float(nb)) * 0.5 == s and (err > 0) == (nb > r):
            r = nb
    return r


def _cmul(xr, xi, yr, yi):
    """x * y as XLA compiles it on the CPU: (fma(xr, yr, -(xi*yi)),
    fma(xi, yr, xr*yi)); numpy arrays."""
    return _fma(xr, yr, -(xi * yi)), _fma(xi, yr, xr * yi)


def _cmul1(xr, xi, yr, yi):
    """_cmul on float32 scalars."""
    return _fma1(xr, yr, -(xi * yi)), _fma1(xi, yr, xr * yi)


def _make_output(pe, fr, fi, phr, phi):
    """makeOutput (JAX spectral._make_output) on numpy arrays: scale the
    phase to the energy, falling back to the input phase when it is
    weak."""
    pn = _fma(phr, phr, phi * phi)
    weak = pn <= NOISE_FLOOR
    fn = _fma(fr, fr, fi * fi)
    p2r = np.where(weak, fr, phr)
    p2i = np.where(weak, fi, phi)
    pn2 = np.where(weak, fn + NOISE_FLOOR, pn)
    # the root of the float32 quotient in float64, rounded: IEEE sqrtf
    s = np.sqrt((pe / pn2).astype(np.float64)).astype(np.float32)
    return _cmul(p2r, p2i, s, np.zeros_like(s))


def _make_output1(pe, fr, fi, phr, phi):
    """_make_output on float32 scalars."""
    pn = _fma1(phr, phr, phi * phi)
    fn = _fma1(fr, fr, fi * fi)
    if pn <= NOISE_FLOOR:
        phr, phi, pn = fr, fi, fn + NOISE_FLOOR
    s = f32(math.sqrt(float(pe / pn)))
    return _cmul1(phr, phi, s, f32(0))


def _planes(z: torch.Tensor):
    z = z.detach().cpu().numpy()
    return np.ascontiguousarray(z.real, np.float32), \
        np.ascontiguousarray(z.imag, np.float32)


def block_sweep_plain(x: BlockSweepInputs, longv: int) -> torch.Tensor:
    """Plain version of `block_sweep` (same contract), on a CPU copy.

    A loop over bins carries the lead channel's outputs as float32
    scalars; a locked output that a later bin's votes read (when the lead
    changes) is taken on the spot, and all the locked outputs are then
    formed at once, vectorised over channels and bins: the same IEEE
    operations on the same values, so the same bits."""
    ch, B = x.pe.shape
    str_, sti = _planes(x.st)
    ltr, lti = _planes(x.lt)
    pur, pui = _planes(x.pu)
    pmr, pmi = _planes(x.pi_max)
    ctr, cti = _planes(x.ct)
    pir, pii = _planes(x.pi)
    pem = x.pe_max.detach().cpu().numpy().astype(np.float32)
    pe = x.pe.detach().cpu().numpy().astype(np.float32)
    mc = x.max_ch.detach().cpu().numpy().astype(np.int64)
    main_r = np.zeros(B, np.float32)
    main_i = np.zeros(B, np.float32)
    zero = f32(0)

    def out(c, k):
        """Channel c's output at bin k < b: the lead's, or locked to it."""
        if mc[k] == c:
            return main_r[k], main_i[k]
        tr, ti = _cmul1(main_r[k], main_i[k], ctr[c, k], cti[c, k])
        return _make_output1(pe[c, k], pir[c, k], pii[c, k], tr, ti)

    with np.errstate(all="ignore"):
        for b in range(B):
            m = mc[b]
            # the votes of bins b-1 and b-LV in this bin's loudest channel,
            # 0 where the bin has none (the window starts as zeros)
            v1r = v1i = v2r = v2i = zero
            if b > 0:
                dr, di = out(m, b - 1)
                v1r, v1i = _cmul1(dr, di, str_[b], sti[b])
            if b >= longv:
                dr, di = out(m, b - longv)
                v2r, v2i = _cmul1(dr, di, ltr[b], lti[b])
            phr = (pur[b] + v1r) + v2r
            phi = (pui[b] + v1i) + v2i
            main_r[b], main_i[b] = _make_output1(pem[b], pmr[b], pmi[b], phr,
                                                 phi)
        # every channel locked to the lead: makeOutput(pe, pi, out_main*ct)
        tr, ti = _cmul(main_r[None], main_i[None], ctr, cti)
        kr, ki = _make_output(pe, pir, pii, tr, ti)
    lead = np.arange(ch)[:, None] == mc[None]
    out_r = np.where(lead, main_r[None], kr)
    out_i = np.where(lead, main_i[None], ki)
    return torch.complex(torch.from_numpy(out_r),
                         torch.from_numpy(out_i)).to(x.pe.device)


def tile_bins(longv: int) -> tuple:
    """The kernel's tile of bins and its dynamic shared memory in bytes:
    SLOTS stage slots of TILE bins, each bin two 64-byte records (the
    chain's and the early lock's, a record's pad between them), its lead
    (8 bytes) and loudest channel (4); then the leads' ring, H x 32 lanes
    x 8 bytes for H the least power of two above LV.  Any channel count:
    the helper warps read every channel's inputs from device memory.
    Raises if the ring does not fit SMEM_MAX."""
    ring = 2
    while ring <= longv:
        ring *= 2
    smem = SLOTS * (TILE * (2 * 64 + 8 + 4) + 64) + ring * 32 * 8
    if smem > SMEM_MAX:
        raise ValueError(f"block_sweep: LV {longv} does not fit the kernel's "
                         f"shared memory ({SMEM_MAX} bytes)")
    return TILE, smem


def _check(x: BlockSweepInputs, longv: int):
    ch, B = x.pe.shape
    _build.require_cuda(*x)
    flat = (x.st, x.lt, x.pu, x.pi_max)
    if (any(t.dtype != torch.complex64 for t in flat + (x.ct, x.pi))
            or x.pe_max.dtype != torch.float32 or x.pe.dtype != torch.float32
            or x.max_ch.dtype != torch.int32):
        raise TypeError("block_sweep: complex64 twists and inputs, float32 "
                        "energies and int32 channels expected")
    if (any(t.shape != (B,) for t in flat + (x.pe_max, x.max_ch))
            or x.ct.shape != (ch, B) or x.pi.shape != (ch, B)):
        raise ValueError("block_sweep: [B] and [ch, B] planes expected, got "
                         f"{[tuple(t.shape) for t in x]}")
    if ch < 1 or B < 1 or longv < 1:
        raise ValueError(f"block_sweep: ch {ch}, B {B}, LV {longv}")


def _launch(entry, x: BlockSweepInputs, longv: int, *extra):
    ch, B = x.pe.shape
    tile, smem = tile_bins(longv)
    out = torch.empty((ch, B), dtype=torch.complex64, device=x.pe.device)
    rc = _build.entry(entry)(
        *[t.data_ptr() for t in x], out.data_ptr(), ch, B, longv, tile,
        smem, *extra, torch.cuda.current_stream(x.pe.device).cuda_stream)
    _build.check(rc, f"block sweep entry {entry!r}")
    return out


def block_sweep(x: BlockSweepInputs, longv: int) -> torch.Tensor:
    """Kernel wrapper (H): one block's sweep inputs -> outputs [ch, B]
    complex64, one launch of one CTA (the chain warp and three helper
    warps)."""
    global launches
    if runs_plain(x.pe):
        return block_sweep_plain(x, longv)
    _check(x, longv)
    out = _launch("block_sweep", x, longv)
    launches += 1
    return out


# the timed entry's phases (csrc/block_sweep.cu sst_block_sweep_timed): the
# chain warp waiting for staged inputs, running its bins, and the helpers'
# tail after its last bin (the chain waiting on the consumers); the
# helpers staging tiles, forming the outputs, and waiting for leads
PHASES = ("inputs_wait", "chain", "consumers_wait", "helpers_stage",
          "helpers_out", "helpers_idle")


def phase_stamps(x: BlockSweepInputs, longv: int) -> torch.Tensor:
    """The kernel's timed entry, which the main path never calls: the same
    outputs, and the clock64() cycles of each of PHASES, the start and end
    on the global timer (ns) and the SM, as [1, len(PHASES) + 3] int64 on
    the card.  Not counted in `launches`."""
    _check(x, longv)
    stamps = torch.zeros((1, len(PHASES) + 3), dtype=torch.int64,
                         device=x.pe.device)
    _launch("block_sweep_timed", x, longv, stamps.data_ptr())
    return stamps


FLOOR_UNROLL = 8      # csrc/block_sweep.cu U


def chain_floor(x: BlockSweepInputs) -> torch.Tensor:
    """The dependency floor of H's work on this card (entry
    `sst_block_sweep_floor`, never on the main path): one thread runs only
    the lead recursion, lead = makeOutput(pe_max, pi_max, (pu + lead*st) +
    h*lt) with h the lead FLOOR_UNROLL bins earlier, over B bins rounded
    up to FLOOR_UNROLL, its inputs (FLOOR_UNROLL bins of x's planes,
    spread over the block) in registers.  Returns [1, 4] int64 on the card: the cycles,
    the start and end on the global timer (ns) and the bins run."""
    _check(x, 1)
    B = x.pe.shape[1]
    bins = -(-B // FLOOR_UNROLL) * FLOOR_UNROLL
    last = torch.empty(1, dtype=torch.complex64, device=x.pe.device)
    stamps = torch.zeros((1, 4), dtype=torch.int64, device=x.pe.device)
    rc = _build.entry("block_sweep_floor")(
        *[t.data_ptr() for t in x[:5]], B, bins, last.data_ptr(),
        stamps.data_ptr(),
        torch.cuda.current_stream(x.pe.device).cuda_stream)
    _build.check(rc, "block sweep entry 'block_sweep_floor'")
    return stamps
