"""The offline render in plain PyTorch: schedule, analysis, the batched
planner, the diagonal sweep and the synthesis.

A frozen copy of the plain path of signalsmith_stretch_torch (engine.py,
planner.py, wavefront.py) for the benchmark's configurations: the built-in
frequency map with its tonality limit or no map, no formants, stretches up
to 2x.  The reference's exact() (signalsmith-stretch.h:467-491) as a static
block schedule on the host and batched tensor stages.  It imports nothing
of the port.  `q` rounds each stage's outputs to the precision the render
is computed in (the identity for float32; spectral.round_bf16 for the
control).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import schedule, spectral, stft
from .geometry import MAX_CLEAN_STRETCH, NOISE_FLOOR, StretchConfig

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class ExactPlan:
    """Everything static needed to render one (config, in_len, out_len) shape."""
    cfg: StretchConfig
    sched: schedule.ExactSchedule
    basis: stft.StftBasis
    consts: spectral.SpectralConsts
    weight: np.ndarray          # [ring_len] float32, floored WOLA weights
    frame_idx: np.ndarray       # [nBlocks, block] timeline indices
    re_rows: np.ndarray         # indices of blocks needing re-analysis
    re_frame_idx: np.ndarray    # [nRe, block] timeline indices for those
    arrays: dict                # per-block flag/factor arrays
    silence: "SilencePlan" = None


@dataclasses.dataclass(frozen=True)
class SilencePlan:
    """Static data for the silence bypass (signalsmith-stretch.h:240-278).

    In exact() the counter starts at 0 (reset, :56), so the pre-roll process
    always runs normally; the main process bypasses iff its whole input
    segment and the pre-roll segment are below the noise floor and the
    pre-roll already pushed the counter past 2*block (surplus >= 2*block);
    the flush zero-input process bypasses iff the main segment was silent and
    the counter crosses 2*block by then.  Bypassed stages write passthrough
    or zeros, never touch the ring and do not advance the output read head,
    so the bypass tails re-read a restricted-block ring at an un-advanced
    head.  Only the two energy tests depend on the audio.
    """
    possible: bool                      # any bypass statically reachable
    main_possible: bool                 # surplus >= 2*block
    flush_possible_pre: bool            # surplus + main_in >= 2*block
    flush_possible_alone: bool          # main_in >= 2*block
    pass_idx: np.ndarray                # [main_out] int32 into audio, or None
    pre_spans: tuple                    # ((k, a, b, off), ...) block slices
    pre_weight: np.ndarray              # [2*T] float32 restricted WOLA weight
    pm_spans: tuple                     # the same for pre-roll + main blocks
    pm_weight: np.ndarray


def _tail_window(basis: stft.StftBasis, out_pos: np.ndarray, ring_len: int,
                 w0: int, width: int):
    """Static contributions of the given blocks to ring[w0:w0+width]:
    spans (block row k, ring start a, ring end b, block-local offset) and the
    restricted floored WOLA weight over the window."""
    block = basis.block_samples
    spans = []
    for k, p in enumerate(out_pos):
        p = int(p)
        a, b = max(w0, p), min(w0 + width, p + block)
        if a < b:
            spans.append((k, a, b, a - p))
    weight = stft.wola_weight(basis, ring_len, out_pos)[w0:w0 + width]
    return tuple(spans), weight


def build_silence_plan(sch: schedule.ExactSchedule, basis: stft.StftBasis,
                       arrays: dict) -> SilencePlan:
    block = sch.cfg.block_samples
    main_possible = sch.surplus >= 2 * block and sch.main_out > 0
    flush_pre = sch.surplus + sch.main_in >= 2 * block
    flush_alone = sch.main_in >= 2 * block
    possible = (main_possible or
                ((flush_pre or flush_alone) and sch.flush_block_out > 0))
    if not possible:
        return SilencePlan(False, False, False, False, None, (),
                           np.zeros(0, np.float32), (), np.zeros(0, np.float32))
    L, T = sch.preroll_len, sch.tail_len
    # bypass passthrough: outputs[i] = inputs[seekLength + i % mainIn] (:253-256)
    if sch.main_in > 0:
        pass_idx = (sch.seek_length
                    + np.arange(sch.main_out, dtype=np.int64) % sch.main_in
                    ).astype(np.int32)
    else:
        pass_idx = None
    out_pos = arrays["out_pos"]
    n_pre, n_pm = sch.n_preroll_blocks, sch.n_preroll_blocks + sch.n_main_blocks
    pre_spans, pre_weight = _tail_window(basis, out_pos[:n_pre], sch.ring_len,
                                         L, 2 * T)
    pm_spans, pm_weight = _tail_window(basis, out_pos[:n_pm], sch.ring_len,
                                       L + sch.main_out, 2 * T)
    return SilencePlan(True, main_possible, flush_pre, flush_alone, pass_idx,
                       pre_spans, pre_weight, pm_spans, pm_weight)


def build_exact_plan(cfg: StretchConfig, in_samples: int,
                     out_samples: int) -> ExactPlan:
    sch = schedule.build_exact_schedule(cfg, in_samples, out_samples)
    basis = stft.StftBasis.for_config(cfg)
    consts = spectral.SpectralConsts.for_config(cfg)
    if not sch.valid:
        return ExactPlan(cfg, sch, basis, consts, np.zeros(1, np.float32),
                         np.zeros((0, 0), np.int32), np.zeros(0, np.int32),
                         np.zeros((0, 0), np.int32), {})
    arrays = schedule.block_arrays(sch)
    block = cfg.block_samples
    ends = arrays["analysis_end"]
    base = np.arange(block, dtype=np.int32)
    frame_idx = (ends[:, None] - block + base[None, :]).astype(np.int32)
    # analysis of the previous frame, one interval back (:335-341)
    re_rows = np.where(arrays["reanalyse"])[0].astype(np.int32)
    re_frame_idx = (ends[re_rows, None] - cfg.interval_samples - block
                    + base[None, :]).astype(np.int32)
    # frames may reach before the timeline start (conceptual zero history)
    weight = stft.wola_weight(basis, sch.ring_len, arrays["out_pos"])
    return ExactPlan(cfg, sch, basis, consts, weight, frame_idx, re_rows,
                     re_frame_idx, arrays,
                     silence=build_silence_plan(sch, basis, arrays))


def _build_timeline(audio: torch.Tensor, plan: ExactPlan) -> torch.Tensor:
    """audio [batch, ch, in_samples] -> virtual input timeline
    [batch, ch, timeline_len]."""
    parts = []
    for seg in plan.sched.segments:
        if seg.kind == "zeros":
            parts.append(audio.new_zeros(audio.shape[:2] + (seg.length,)))
        else:
            parts.append(audio[..., seg.src_offset:seg.src_offset + seg.length])
    return torch.cat(parts, -1)


def gather_frames(timeline: torch.Tensor, starts: np.ndarray,
                  block: int) -> torch.Tensor:
    """Frame windows: timeline [batch, ch, T] -> [batch, nF, ch, block].

    One strided view of every window (`unfold`) indexed at the static frame
    starts; starts may be negative for the first frames (zero history)."""
    T = timeline.shape[-1]
    front = max(0, -int(starts.min()))
    back = max(0, int(starts.max()) + block - T)
    windows = F.pad(timeline, (front, back)).unfold(-1, block, 1)
    idx = torch.as_tensor(starts.astype(np.int64) + front,
                          device=timeline.device)
    return windows[:, :, idx].transpose(1, 2)


def analyze_stage(audio: torch.Tensor, plan: ExactPlan):
    """Timeline + frames + modified-DFT analysis (torch.fft).
    Returns (spectra, prev_spectra), both [batch, nB, ch, B] complex64;
    prev_spectra holds the re-analysis one interval back for the blocks in
    plan.re_rows, else 0."""
    timeline = _build_timeline(audio, plan)
    block = plan.cfg.block_samples
    nB = plan.frame_idx.shape[0]
    if not len(plan.re_rows):
        spectra = stft.analyze(gather_frames(timeline, plan.frame_idx[:, 0],
                                             block), plan.basis)
        return spectra, torch.zeros_like(spectra)
    # one window gather + one batched DFT for main and re-analysis frames
    starts = np.concatenate([plan.frame_idx[:, 0], plan.re_frame_idx[:, 0]])
    both = stft.analyze(gather_frames(timeline, starts, block), plan.basis)
    spectra = both[:, :nB]
    if len(plan.re_rows) == nB:     # fixed-rate renders re-analyse every block
        return spectra, both[:, nB:]
    prev = torch.zeros_like(spectra)
    prev[:, torch.as_tensor(plan.re_rows, device=audio.device)] = both[:, nB:]
    return spectra, prev


def _overlap_add(blocks_t: torch.Tensor, out_pos: np.ndarray,
                 ring_len: int, block: int, interval: int) -> torch.Tensor:
    """blocks_t [batch, ch, nB, block] -> ring [batch, ch, ring_len].

    Blocks sit every `interval` samples.  Blocks k = g, g+m, g+2m, ... (with
    m = ceil(block/interval)) never overlap, so each group is its blocks laid
    end to end (a reshape), and the ring is the sum of the m group strips,
    added in group order."""
    batch, ch, n_b, _ = blocks_t.shape
    first = int(out_pos[0])
    m = -(-block // interval)
    pad = m * interval - block
    total = blocks_t.new_zeros((batch, ch, ring_len))
    for g in range(m):
        grp = blocks_t[:, :, g::m]
        n_g = grp.shape[2]
        if not n_g:
            continue
        flat = F.pad(grp, (0, pad)).reshape(batch, ch, n_g * m * interval)
        ofs = first + g * interval
        seg = max(0, min(n_g * m * interval, ring_len - ofs))
        if seg:
            total[..., ofs:ofs + seg] += flat[..., :seg]
    return total


def _bypass_tail(blocks_t, spans, weight, w0: int, T: int, L: int, preroll):
    """Flush tail (:444-454) read at an un-advanced head `w0` from a ring
    holding only the given block spans (bypassed stages never ran their
    synthesis).  The outputSeek pre-roll cancellation (:198-203) lives at
    ring [L, 2L) and is included where the window overlaps it."""
    buf = blocks_t.new_zeros(blocks_t.shape[:2] + (2 * T,))
    for k, a, b, off in spans:
        buf[..., a - w0:b - w0] += blocks_t[:, :, k, off:off + (b - a)]
    lo, hi = max(w0, L), min(w0 + 2 * T, 2 * L)
    if lo < hi:   # -preroll[L-1-(j-L)] at ring position j
        buf[..., lo - w0:hi - w0] -= preroll[..., 2 * L - hi:2 * L - lo].flip(-1)
    t = buf / torch.as_tensor(weight, device=buf.device)
    return t[..., :T] - t[..., T:].flip(-1)


def synthesis_stage(out_specs: torch.Tensor, plan: ExactPlan,
                    audio: torch.Tensor = None) -> torch.Tensor:
    """Inverse FFT + overlap-add + WOLA-normalised assembly: out_specs
    [batch, ch, nB, B] complex64 -> [batch, ch, out_samples].  With `audio`
    given, the silence bypass (:240-278) selects, per clip, between the
    normal assembly and passthrough/zeros with restricted-ring tails;
    without it the bypass is off."""
    cfg, sch = plan.cfg, plan.sched
    blocks_t = stft.synthesize(out_specs, plan.basis)   # [batch, ch, nB, block]
    ring = _overlap_add(blocks_t, plan.arrays["out_pos"], sch.ring_len,
                        cfg.block_samples, cfg.interval_samples)
    w = torch.as_tensor(plan.weight, device=ring.device)
    L = sch.preroll_len
    preroll = ring[..., :L] / w[:L]
    # outputSeek: negate + reverse the pre-roll into the ring (:198-203)
    ring[..., L:2 * L] -= preroll.flip(-1)

    def read(a, n):
        return ring[..., a:a + n] / w[a:a + n]

    main = read(L, sch.main_out)
    fz0 = L + sch.main_out
    flush_zero = read(fz0, sch.flush_block_out)
    head = fz0 + sch.flush_block_out
    T = sch.tail_len
    tail = read(head, T) - read(head + T, T).flip(-1)

    sil = plan.silence
    if audio is not None and sil is not None and sil.possible:
        # total-energy scans (:231-238), per clip
        def silent(start, length):
            seg = audio[..., start:start + max(length, 0)]
            return ((seg * seg).sum((1, 2)) < NOISE_FLOOR)[:, None, None]

        pre_silent = silent(sch.seek_samples, sch.surplus)
        main_silent = silent(sch.seek_length, sch.main_in)
        no = torch.zeros_like(main_silent)
        main_b = (main_silent & pre_silent) if sil.main_possible else no
        fp, fa = sil.flush_possible_pre, sil.flush_possible_alone
        if fp == fa:
            flush_b = main_silent & fp
        else:   # only reachable when the pre-roll was silent too (fp, not fa)
            flush_b = main_silent & pre_silent & fp
        if sil.pass_idx is not None:
            passthrough = audio[..., torch.as_tensor(sil.pass_idx.astype(np.int64),
                                                     device=audio.device)]
        else:
            passthrough = torch.zeros_like(main)
        main = torch.where(main_b, passthrough, main)
        if sch.flush_block_out > 0:
            flush_zero = torch.where(flush_b, torch.zeros_like(flush_zero),
                                     flush_zero)
            tail_pm = _bypass_tail(blocks_t, sil.pm_spans, sil.pm_weight,
                                   L + sch.main_out, T, L, preroll)
            tail = torch.where(flush_b, tail_pm, tail)
        if sil.main_possible and T > 0:
            tail_pre = _bypass_tail(blocks_t, sil.pre_spans, sil.pre_weight,
                                    L, T, L, preroll)
            tail = torch.where(main_b, tail_pre, tail)
    return torch.cat([main, flush_zero, tail], -1)




# ---------------------------------------------------------------------------
# the batched planner (:642-803) and the diagonal sweep
# ---------------------------------------------------------------------------
class SweepInputs(NamedTuple):
    """Per-(block, bin) sweep inputs of a batch, each [batch, nB, B]."""
    a1: torch.Tensor      # complex64 up-short vote coefficient
    a2: torch.Tensor      # complex64 up-long
    d1: torch.Tensor      # complex64 down-short
    d2: torch.Tensor      # complex64 down-long
    mc: torch.Tensor      # int32 max-energy channel
    pe: tuple             # ch x f32 prediction energies
    pi: tuple             # ch x complex64 prediction inputs


def plan_spectral(spectra: torch.Tensor, prev_spectra: torch.Tensor,
                  arrays: dict, controls: spectral.Controls,
                  consts: spectral.SpectralConsts) -> SweepInputs:
    """spectra/prev_spectra [batch, nB, ch, B] complex64 -> SweepInputs."""
    batch, nB, ch, B = spectra.shape
    dev = spectra.device
    longv = consts.long_vertical_step
    new = arrays["new_spectrum"]
    reanalyse = arrays["reanalyse"]
    tf = np.maximum(arrays["time_factor"], f32(1.0 / MAX_CLEAN_STRETCH))
    if (tf > f32(MAX_CLEAN_STRETCH)).any():
        raise ValueError("the reference covers stretches up to 2x")
    rotor = torch.as_tensor(consts.rotor, device=dev)

    def blocks(z, idx):
        return z[:, torch.as_tensor(idx, device=dev)]

    def bmask(keep):
        return torch.as_tensor(keep, device=dev)[None, :, None, None]

    # the input/prevInput chains over the block schedule (:332-376, 806-812)
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

    in_energy = (input_eff.real * input_eff.real
                 + input_eff.imag * input_eff.imag)     # [batch, nB, ch, B]
    ltf = (f32(longv) * tf).astype(f32)
    R = batch * nB

    def rows(z):
        return z.reshape(R, B)

    if controls.mapped:
        energy = in_energy[:, :, 0]
        for c in range(1, ch):
            energy = energy + in_energy[:, :, c]
        energy = energy.reshape(R, B).contiguous()
        sm = spectral.iir_chain(energy, consts.slew, spectral.SMOOTHING)
        input_bin, freq_grad = spectral.peaks_and_map(energy, sm, controls,
                                                      consts)
        t1 = torch.as_tensor(tf.astype(f32), device=dev).repeat(batch)[:, None]
        t2 = torch.as_tensor(ltf, device=dev).repeat(batch)[:, None]
        pos = [input_bin, input_bin - t1, input_bin - t2]

        def look(z, p):
            return spectral.interp(rows(z), p).reshape(batch, nB, B)

        pos_grad = torch.clamp(freq_grad.reshape(batch, nB, B), min=0)
        pi = [look(input_eff[:, :, c], pos[0]) for c in range(ch)]
        prev_i = [look(prev_eff[:, :, c], pos[0]) for c in range(ch)]
        pe = [look(in_energy[:, :, c], pos[0]) * pos_grad for c in range(ch)]
        votes = [[look(input_eff[:, :, c], pos[k]) for c in range(ch)]
                 for k in (1, 2)]
    else:
        pe = [in_energy[:, :, c] for c in range(ch)]
        pi = [input_eff[:, :, c] for c in range(ch)]
        prev_i = [prev_eff[:, :, c] for c in range(ch)]
        votes = [[spectral.interp_shift(p, tf) for p in pi],
                 [spectral.interp_shift(p, ltf) for p in pi]]

    pe_prev = [F.pad(x[:, :-1], (0, 0, 1, 0)) for x in pe]
    if new.all():
        rotor_eff = rotor
    else:
        rotor_eff = torch.where(torch.as_tensor(new, device=dev)[:, None],
                                rotor, torch.ones((), dtype=rotor.dtype,
                                                  device=dev))
    c1 = [spectral.cdivr(rotor_eff * (pi[c] * torch.conj(prev_i[c])),
                         torch.maximum(pe_prev[c], pe[c]) + NOISE_FLOOR)
          for c in range(ch)]

    # the main prediction's coefficients (:722-803)
    mc = torch.argmax(torch.stack(pe, 0), 0).to(torch.int32)
    sel, up = spectral.sel, spectral.shift_up
    pi_max = sel(mc, pi)
    b_idx = torch.arange(B, device=dev)
    sd, ld = votes
    d1 = spectral.where0(b_idx > 0, pi_max * torch.conj(sel(mc, sd)))
    d2 = spectral.where0(b_idx >= longv, pi_max * torch.conj(sel(mc, ld)))
    up_short = sel(mc, [up(x, 1) for x in sd])
    up_long = sel(mc, [up(x, longv) for x in ld])
    pi_up1 = sel(mc, [up(x, 1) for x in pi])
    pi_upl = sel(mc, [up(x, longv) for x in pi])
    c1_up1 = sel(mc, [up(x, 1) for x in c1])
    c1_upl = sel(mc, [up(x, longv) for x in c1])
    a1 = spectral.where0(b_idx < B - 1,
                         c1_up1 * torch.conj(pi_up1 * torch.conj(up_short)))
    a2 = spectral.where0(b_idx < B - longv,
                         c1_upl * torch.conj(pi_upl * torch.conj(up_long)))
    return SweepInputs(a1=a1, a2=a2, d1=d1, d2=d2, mc=mc, pe=tuple(pe),
                       pi=tuple(pi))


def _make_output_pair(pe, pir, pii, phr, phi):
    """makeOutput on float32 planes: the phase scaled to the prediction
    energy, or the input phase where the phase is weak."""
    pn = phr * phr + phi * phi
    weak = pn <= NOISE_FLOOR
    fn = pir * pir + pii * pii
    p2r = torch.where(weak, pir, phr)
    p2i = torch.where(weak, pii, phi)
    pn2 = torch.where(weak, fn + NOISE_FLOOR, pn)
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
    nB, D = s.shape[-2:]
    flat = F.pad(s.reshape(s.shape[:-2] + (nB * D,)), (0, nB * step))
    return flat.reshape(s.shape[:-2] + (nB, D + step))[..., :bands]


def sweep(inputs: SweepInputs, longv: int) -> torch.Tensor:
    """The phase recursion over all blocks, on diagonals t = b + k*(LV+1)
    (each dependency lies on diagonals t-1 and t-LV), vectorised over clips
    and rows: [batch, ch, nB, B] complex64 outputs."""
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
    ring = deque([(zero, zero)] * longv, maxlen=longv)
    chans = torch.arange(ch, device=dev)[None, :, None]

    def shift_k(x):            # row k reads row k-1 (zeros above row 0)
        return F.pad(x[..., :-1], (1, 0))

    for t in range(D):
        x = sk[..., t]                                  # [batch, P, nB]
        a1r, a1i, a2r, a2i, d1r, d1i, d2r, d2i = x[:, :8].unbind(1)
        m = x[:, 8].to(torch.int64)[:, None]
        pe = x[:, 9:9 + ch]
        pir, pii = x[:, 9 + ch:9 + 2 * ch], x[:, 9 + 2 * ch:9 + 3 * ch]

        def pick(v):
            return torch.gather(v, 1, m)[:, 0]

        (l_r, l_i), (p_r, p_i) = ring[0], ring[-1]
        v1 = _cmul(d1r, d1i, pick(p_r), pick(p_i))                 # [k, b-1]
        v2 = _cmul(d2r, d2i, pick(l_r), pick(l_i))                 # [k, b-LV]
        v3 = _cmul(a1r, a1i, pick(shift_k(l_r)), pick(shift_k(l_i)))
        v4 = _cmul(a2r, a2i, pick(shift_k(p_r)), pick(shift_k(p_i)))
        phr = ((v1[0] + v2[0]) + v3[0]) + v4[0]
        phi = ((v1[1] + v2[1]) + v3[1]) + v4[1]
        pim_r, pim_i = pick(pir), pick(pii)
        lr, li = _make_output_pair(pick(pe), pim_r, pim_i, phr, phi)
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


def _q_inputs(x: SweepInputs, q) -> SweepInputs:
    return SweepInputs(q(x.a1), q(x.a2), q(x.d1), q(x.d2), x.mc,
                       tuple(q(v) for v in x.pe), tuple(q(v) for v in x.pi))


def render(audio: torch.Tensor, plan: ExactPlan,
           controls: spectral.Controls, q=spectral.identity) -> torch.Tensor:
    """audio [batch, ch, in] float32 -> [batch, ch, out]: exact() of each
    clip, with the silence bypass."""
    if not plan.sched.valid:
        return audio.new_zeros(audio.shape[:2] + (plan.sched.out_samples,))
    audio = q(audio)
    spectra, prev = analyze_stage(audio, plan)
    inputs = _q_inputs(plan_spectral(q(spectra), q(prev), plan.arrays,
                                     controls, plan.consts), q)
    del spectra, prev
    out_specs = q(sweep(inputs, plan.consts.long_vertical_step))
    del inputs
    return q(synthesis_stage(out_specs, plan, audio=audio))
