"""The diagonal phase sweep (kernel B, csrc/sweep.cu).

The only true recurrent state of the spectral processor is Band.output.  With
the planner's coefficients (planner.py) the main-prediction vote sum is

  phase[k,b] = d1*out[k,b-1] + d2*out[k,b-LV] + a1*out[k-1,b+1] + a2*out[k-1,b+LV]

for the max-energy channel, whose output the other channels are then
phase-locked to.  On the diagonal t = b + k*(LV+1) every dependency lies on
diagonals t-1 and t-LV, so a clip takes B + (nB-1)*(LV+1) sequential steps.
`sweep` launches the kernel on a CUDA tensor, one CTA per clip on the
schedule of `sweep_schedule`; on a CPU tensor, or inside ops.plain(), it
runs `sweep_plain`, a loop over diagonals vectorised over clips and rows in
explicit float32 real/imag arithmetic with the kernel's operation order.
"""
from __future__ import annotations

from collections import deque

import torch
import torch.nn.functional as F

from . import spectral
from .config import NOISE_FLOOR
from .ops import _build, runs_plain
from .planner import SweepInputs

launches = 0          # kernel launches of sweep
SWEEP_MAX_THREADS = 512   # threads of one CTA (csrc/sweep.cu MAX_THREADS)


def sweep_schedule(nB: int, B: int, longv: int,
                   max_threads: int = SWEEP_MAX_THREADS):
    """The kernel's schedule for one clip of nB rows of B bins: (threads,
    sigma, diagonals).  Thread j walks rows j, j+threads, ...; cell (k, b)
    runs on diagonal b + k*sigma.  sigma = LV+1, the tightest step the
    recursion allows, unless the clip has more rows than threads: then
    sigma is raised until threads*sigma >= B, so that a thread finishes one
    row before its next row starts."""
    threads = min(-(-nB // 32) * 32, max_threads)
    sigma = longv + 1
    if nB > threads:
        sigma = max(sigma, -(-B // threads))
    return threads, sigma, B + (nB - 1) * sigma


def _make_output_pair(pe, pir, pii, phr, phi):
    """makeOutput on float32 real/imag planes: scale the phase to the
    prediction energy, falling back to the input phase when it is weak."""
    pn = phr * phr + phi * phi
    weak = pn <= NOISE_FLOOR
    fn = pir * pir + pii * pii
    p2r = torch.where(weak, pir, phr)
    p2i = torch.where(weak, pii, phi)
    pn2 = torch.where(weak, fn + NOISE_FLOOR, pn)
    # IEEE float32 root, as the kernel's sqrtf: torch's vectorised CPU sqrt
    # is off by one ulp in ~0.5% of cases, the float64 root rounded is not
    s = torch.sqrt((pe / pn2).double()).float()
    return p2r * s, p2i * s


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _skew(x: torch.Tensor, step: int) -> torch.Tensor:
    """[..., nB, B] -> [..., nB, D] with S[k, b + k*step] = x[k, b]."""
    nB, B = x.shape[-2:]
    D = B + (nB - 1) * step
    T = D + step
    flat = F.pad(x, (0, T - B)).reshape(x.shape[:-2] + (nB * T,))
    return flat[..., :nB * D].reshape(x.shape[:-2] + (nB, D))


def _unskew(s: torch.Tensor, step: int, bands: int) -> torch.Tensor:
    """Inverse of _skew: [..., nB, D] -> [..., nB, bands]."""
    nB, D = s.shape[-2:]
    flat = F.pad(s.reshape(s.shape[:-2] + (nB * D,)), (0, nB * step))
    return flat.reshape(s.shape[:-2] + (nB, D + step))[..., :bands]


def sweep_plain(inputs: SweepInputs, longv: int) -> torch.Tensor:
    """Plain version of `sweep`: [batch, ch, nB, B] complex64 outputs."""
    batch, nB, B = inputs.a1.shape
    ch = len(inputs.pi)
    step = longv + 1
    dev = inputs.a1.device
    planes = []
    for z in (inputs.a1, inputs.a2, inputs.d1, inputs.d2):
        planes += [z.real, z.imag]
    planes += [inputs.mc.to(torch.float32)]
    planes += list(inputs.pe)
    planes += [p.real for p in inputs.pi] + [p.imag for p in inputs.pi]
    sk = _skew(torch.stack(planes, 1), step)          # [batch, P, nB, D]
    D = sk.shape[-1]
    out_r = torch.empty((batch, ch, nB, D), dtype=torch.float32, device=dev)
    out_i = torch.empty_like(out_r)
    zero = torch.zeros((batch, ch, nB), dtype=torch.float32, device=dev)
    ring = deque([(zero, zero)] * longv, maxlen=longv)   # diagonals t-LV..t-1
    chans = torch.arange(ch, device=dev)[None, :, None]

    def shift_k(x):            # row k reads row k-1 (zeros above row 0)
        return F.pad(x[..., :-1], (1, 0))

    for t in range(D):
        x = sk[..., t]                                  # [batch, P, nB]
        a1r, a1i, a2r, a2i, d1r, d1i, d2r, d2i = x[:, :8].unbind(1)
        m = x[:, 8].to(torch.int64)[:, None]            # [batch, 1, nB]
        pe = x[:, 9:9 + ch]
        pir, pii = x[:, 9 + ch:9 + 2 * ch], x[:, 9 + 2 * ch:9 + 3 * ch]

        def sel(v):
            return torch.gather(v, 1, m)[:, 0]

        (l_r, l_i), (p_r, p_i) = ring[0], ring[-1]
        v1 = _cmul(d1r, d1i, sel(p_r), sel(p_i))                 # out[k, b-1]
        v2 = _cmul(d2r, d2i, sel(l_r), sel(l_i))                 # out[k, b-LV]
        v3 = _cmul(a1r, a1i, sel(shift_k(l_r)), sel(shift_k(l_i)))  # [k-1, b+1]
        v4 = _cmul(a2r, a2i, sel(shift_k(p_r)), sel(shift_k(p_i)))  # [k-1, b+LV]
        phr = ((v1[0] + v2[0]) + v3[0]) + v4[0]
        phi = ((v1[1] + v2[1]) + v3[1]) + v4[1]
        pim_r, pim_i = sel(pir), sel(pii)
        lr, li = _make_output_pair(sel(pe), pim_r, pim_i, phr, phi)
        # the other channels, locked to the lead: out_m * pi_c * conj(pi_m)
        ctr = pir * pim_r[:, None] + pii * pim_i[:, None]
        cti = pii * pim_r[:, None] - pir * pim_i[:, None]
        tr, ti = _cmul(lr[:, None], li[:, None], ctr, cti)
        kr, ki = _make_output_pair(pe, pir, pii, tr, ti)
        lead = chans == m
        o_r = torch.where(lead, lr[:, None], kr)
        o_i = torch.where(lead, li[:, None], ki)
        ring.append((o_r, o_i))
        out_r[..., t] = o_r
        out_i[..., t] = o_i
    return torch.complex(_unskew(out_r, step, B), _unskew(out_i, step, B))


def sweep(inputs: SweepInputs, longv: int) -> torch.Tensor:
    """SweepInputs ([batch, nB, B] leaves) -> outputs [batch, ch, nB, B]
    complex64."""
    global launches
    if runs_plain(inputs.a1):
        return sweep_plain(inputs, longv)
    batch, nB, B = inputs.a1.shape
    ch = len(inputs.pi)
    if len(inputs.pe) != ch or ch < 1:
        raise ValueError(f"sweep: {ch} channels of inputs and "
                         f"{len(inputs.pe)} of energies")
    # the planes as the planner left them: any clip and row strides, unit
    # bin stride
    planes = [p if p.stride(-1) == 1 else p.contiguous() for p in
              [inputs.a1, inputs.a2, inputs.d1, inputs.d2, inputs.mc,
               *inputs.pe, *inputs.pi]]
    dev = planes[0].device
    if any(p.device != dev for p in planes):
        raise ValueError("sweep: inputs on more than one device")
    if (any(z.dtype != torch.complex64 for z in planes[:4] + planes[5 + ch:])
            or any(p.dtype != torch.float32 for p in planes[5:5 + ch])
            or planes[4].dtype != torch.int32):
        raise TypeError("sweep: complex64 coefficients and inputs, float32 "
                        "energies and int32 channels expected")
    if any(p.shape != (batch, nB, B) for p in planes):
        raise ValueError("sweep: inconsistent plane shapes")
    if longv < 1:
        raise ValueError(f"sweep: long vertical step {longv} < 1")
    threads, sigma, _ = sweep_schedule(nB, B, longv)
    out = torch.empty((batch, ch, nB, B), dtype=torch.complex64, device=dev)
    # scratch: the inputs and the outputs skewed within groups of 32 rows,
    # [batch][ceil(nB/32)][B + 31*sigma][words][32]
    groups, diags = -(-nB // 32), B + 31 * sigma
    stage = torch.empty((batch, groups, diags, 9 + 3 * ch, 32),
                        dtype=torch.float32, device=dev)
    skewed = torch.empty((batch, groups, diags, ch, 32),
                         dtype=torch.complex64, device=dev)
    # the plane table, (pointer, clip stride, row stride) a plane, in device
    # memory: any channel count fits.  Copied from pinned memory, so the
    # copy does not hold the host (the caching host allocator keeps the
    # block until the copy has run)
    table = torch.tensor([(p.data_ptr(), p.stride(0), p.stride(1))
                          for p in planes], dtype=torch.int64)
    table = table.pin_memory().to(dev, non_blocking=True)
    rc = _build.entry("sweep")(
        table.data_ptr(), out.data_ptr(), stage.data_ptr(), skewed.data_ptr(),
        batch, nB, B, ch, longv, threads, sigma,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sst_sweep")
    launches += 1
    return out

