"""Batched spectral planner: stages a-f of processSpectrum for all blocks.

Builds the per-(block, bin) SweepInputs (reference signalsmith-stretch.h:
642-803) that the diagonal sweep (wavefront.py) consumes, for every clip of
a batch at once, in complex64:

  - effective input / prevInput chains over the static block schedule
    (:332-376, 806-812), with the fixed-rate shortcuts (every block new,
    every block re-analysed) and the general gathers;
  - for frequency-mapped renders: cross-channel energy, the slew smoothing
    (kernel C, its four passes in one launch), peaks and the output map
    (kernel G, one launch; under a custom map its runs entry, the callable
    and its out entry), and the prediction lookups at the mapped positions
    in one multi-set interpolation (kernel A);
  - for formant renders (:970-1036): the pitch estimate (top-3 scan, kernel
    F, and the two freqEstimate chains over blocks in one launch of kernel
    C) unless a base frequency is given, the envelope's eight decay passes
    (kernel E, one launch), and the envelope ratio that rescales the input
    energies;
  - the prediction energies; above 2x (randomised phases, :747-757) the
    votes read per-bin positions drawn from each clip's seed (prng.py), in
    one launch of kernel A; then the c1 chain coefficient, the loudest
    channel and the four vote coefficients a1, a2, d1, d2 of the main
    prediction (:722-803) in one launch (kernel J).

Controls may be scalars or per-block [nB] arrays (automation); the peaks
map (G), the formant targets and the given formant base then take each
block's values.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import prng, spectral
from .config import MAX_CLEAN_STRETCH
from .ops import coefficients, draws, interp, peaks, scan_ops
from .tables import on_device
from .utils.profiling import span

f32 = np.float32


class SweepInputs(NamedTuple):
    """Per-(block, bin) sweep inputs of a batch, each [batch, nB, B]."""
    a1: torch.Tensor      # complex64 up-short vote coefficient
    a2: torch.Tensor      # complex64 up-long
    d1: torch.Tensor      # complex64 down-short
    d2: torch.Tensor      # complex64 down-long
    mc: torch.Tensor      # int32 max-energy channel
    pe: tuple             # ch x f32 prediction energies
    pi: tuple             # ch x complex64 prediction inputs


def _cdivr(a, den):
    """complex / real, component-wise (what XLA's complex division gives for
    a zero imaginary divisor; torch's complex division rounds differently)."""
    return torch.complex(a.real / den, a.imag / den)


def _formant_targets(controls: spectral.Controls, compensation: bool, B: int,
                     N: int, device: torch.device, custom_map=None):
    """The envelope lookup's static positions (:1011-1036): the target band
    of each bin (inverse formant map, after the pitch map when compensating:
    the custom map if one is set) as JAX's clipped take reads it: low and
    high indices into the envelope padded with two zeros, the fraction, and
    the target_band < 0 mask, each [B], or [nB, B] for per-block controls.
    Float32 on the CPU (a custom map runs on `device`), computed once per
    (controls, custom map, shape, device).  The cache keys on the callable
    itself and holds it, so its id cannot be reused while the entry
    lives."""
    if not compensation:
        custom_map = None
    return _formant_targets_cached(controls.key(), compensation, B, N,
                                   device, custom_map)


@functools.lru_cache(maxsize=8)
def _formant_targets_cached(key: tuple, compensation: bool, B: int, N: int,
                            device: torch.device, custom_map):
    controls = spectral.Controls.from_key(key)
    band_freq = (torch.arange(B, dtype=torch.float32) + 0.5) / N
    if custom_map is not None:
        out_f = spectral.custom_map_freq(custom_map,
                                         band_freq.to(device)).cpu()
    elif compensation:
        out_f = spectral.map_freq(band_freq, controls)
    else:
        out_f = band_freq
    target = spectral.inv_map_formant(out_f, controls) * float(N) - 0.5
    tb = target.clamp(max=B)
    floor_band = torch.floor(tb)
    lo = floor_band.to(torch.int64)
    return tuple(t.to(device) for t in (lo.clamp(0, B + 1),
                                        (lo + 1).clamp(0, B + 1),
                                        tb - floor_band, target < 0))


def draw_bounds(tf: np.ndarray):
    """Above 2x (:747-757): the draws' bounds tf and lo_d = 4 * random_tf
    - tf as [nB] float32, and the blocks whose binTimeFactor is drawn
    (random_tf = tf > 2, [nB] bool), JAX's expressions (planner.py:
    483-488), in draws.draws_factors' order."""
    tf = np.asarray(tf, f32)
    random_tf = tf > f32(MAX_CLEAN_STRETCH)
    lo_d = (f32(MAX_CLEAN_STRETCH) * 2 * random_tf.astype(f32) - tf).astype(
        f32)
    return tf, lo_d, random_tf


@functools.lru_cache(maxsize=8)
def _clip_keys(seeds: tuple, device: torch.device) -> torch.Tensor:
    """The clips' keys prng.key(seed) as [batch, 2] uint32 on `device`,
    copied once per (seeds, device)."""
    keys = np.array([prng.key(s) for s in seeds], np.uint32).reshape(-1, 2)
    return torch.as_tensor(keys, device=device)


def _random_time_factors(tf: np.ndarray, seeds, B: int,
                         flags: spectral.SpectralFlags, device):
    """The per-bin time factors of the randomised regime, btf1 and btf2
    [batch, nB, B] float32: for each clip, draws (2, nB, B) uniform in
    [lo_d, tf) from prng.key(seed) in the blocks above 2x, tf elsewhere.
    On the card that is one launch of kernel I (ops/draws.draws_factors).
    A flags.random_engine takes the draws' place, a call a clip."""
    tf_t, lo_d, random_tf = on_device(tf, device, draw_bounds)
    if flags.random_engine is None:
        return draws.draws_factors(
            _clip_keys(tuple(int(s) for s in seeds), device), tf_t, lo_d,
            random_tf, B)
    nB = len(tf)
    drawn = torch.stack([
        spectral.draw_uniform(flags, prng.key(seed), (2, nB, B),
                              lo_d.view(1, nB, 1), tf_t.view(1, nB, 1))
        for seed in seeds])
    return draws.select_blocks(drawn, random_tf, tf_t)


def base_bands(base, N: int):
    """Formant bases (one, or [nB] under automation): the blocks that give
    one, and each as a band, base * N - 0.5 in float32."""
    base = np.asarray(base, f32)
    return base > 0, (base * f32(N) - f32(0.5)).astype(f32)


def _formant_ratio(metric: torch.Tensor, batch: int,
                   controls: spectral.Controls, flags: spectral.SpectralFlags,
                   consts: spectral.SpectralConsts, dbg, estimate=None):
    """The formant envelope ratio (:970-1036): metric [R, B] (the
    cross-channel energy, rows block-major per clip) -> (ratio [R, B],
    (freqEstimateWeighted, freqEstimateWeight) after each clip's last
    block, each [batch], or None when no estimate runs).  `estimate`: the
    two values before each clip's first block (default zeros, the
    reference's reset), as a stream carries them from block to block."""
    R, B = metric.shape
    nB = R // batch
    dev = metric.device

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

    base = controls.formant_base_freq
    if flags.formant_auto:
        # no base frequency given (in some block): pitch estimate
        # (:927-968), the top-3 scan (kernel F), the harmonic heuristic and
        # the freqEstimateWeighted chains over blocks (C): the weighted
        # estimates and the weights of every clip, stacked as independent
        # rows of one forward pass
        pe_est, weight = spectral._peak_estimate(
            *scan_ops.top3_local_maxima(metric))
        rows = torch.cat([pe_est.to(torch.float32) * weight, weight])
        init = zeros(2 * batch) if estimate is None else torch.cat(estimate)
        chains, final = scan_ops.iir_chain(rows.reshape(2 * batch, nB), init,
                                           0.25, (False,))
        few, fw = chains[:batch], chains[batch:]
        state = (final[:batch], final[batch:])
        if dbg is not None:
            dbg.update(freq_estimate_weighted=few, freq_weight=fw)
        freq_estimate = (few / (fw + float(f32(1e-30)))).reshape(R)
        if controls.automated and (np.asarray(base) > 0).any():
            # the blocks whose automation gives a base take it (JAX
            # planner.py:395-399)
            use, given = on_device(base, dev, base_bands, consts.fft_samples)
            freq_estimate = torch.where(use.repeat(batch), given.repeat(batch),
                                        freq_estimate)
    elif controls.automated:
        state = None
        freq_estimate = on_device(base, dev, base_bands,
                                  consts.fft_samples)[1].repeat(batch)
    else:
        state = None
        freq_estimate = torch.full((R,), float(base_bands(
            base, consts.fft_samples)[1]), dtype=torch.float32, device=dev)

    # envelope: two max steps with the decay, two min steps with its
    # inverse, each a backward then a forward pass, each pass starting from
    # the previous one's last value: eight passes in one launch (E)
    decay = 1 - 1 / (freq_estimate * 0.5 + 1)
    inv_decay = 1 / decay
    passes = [(coef, is_min, backward)
              for coef, is_min in ((decay, False), (inv_decay, True))
              for _ in range(2) for backward in (True, False)]
    env, _ = scan_ops.decay_chain(metric, zeros(R), passes)

    lo_i, hi_i, frac, below = _formant_targets(
        controls, flags.formant_compensation, B, consts.fft_samples, dev,
        flags.custom_map)
    env_pad = F.pad(env, (0, 2))
    if lo_i.dim() == 1:
        lo, hi = env_pad[:, lo_i], env_pad[:, hi_i]
    else:
        # per-block targets [nB, B]: a clipped gather along each row
        env_b = env_pad.reshape(batch, nB, B + 2)
        lo, hi = (torch.gather(env_b, 2, i.expand(batch, nB, B)).reshape(R, B)
                  for i in (lo_i, hi_i))
        frac, below = frac.repeat(batch, 1), below.repeat(batch, 1)
    target_e = torch.where(below, torch.zeros((), device=dev),
                           lo + (hi - lo) * frac)
    ratio = target_e / (env + float(f32(1e-30)))
    if dbg is not None:
        dbg.update(metric=metric, freq_estimate=freq_estimate, env=env,
                   ratio=ratio)
    return ratio, state


def _random_vote_positions(base, btf1, btf2, longv: int):
    """The randomised regime's four vote position sets (JAX planner.py:
    529-532, 589-596): base less btf1 and less longv*btf1 (down), base
    shifted one and longv bins up less btf2 and less longv*btf2 (up), each
    product and subtraction a float32 op of its own.  The shift zero-fills
    the top bins, whose positions go negative: A reads 0 there, and a1/a2
    mask those bins."""
    return [base - btf1, base - float(longv) * btf1,
            coefficients.shift_up(base, 1) - btf2,
            coefficients.shift_up(base, longv) - float(longv) * btf2]


def _lookup(rows_list, specs, pos, batch: int, dbg):
    """One multi-set interpolation (kernel A) of rows_list at the position
    sets of specs, (pos [R, B], rows read), whose positions are the slices
    of the stacked pos [R, sets, B]: per set the looked-up rows as [batch,
    nB, B] tensors, complex where the row is."""
    planes, pos_sets, kinds = interp.pack(rows_list, specs)
    results, _ = interp.interp_multi(planes, pos_sets, pos=pos)
    if dbg is not None:
        dbg.update(interp=(planes, pos_sets), pos=pos)
    return [[v.reshape(batch, -1, v.shape[-1]) for v in o]
            for o in interp.unpack(results, specs, kinds)]


def plan_spectral(spectra: torch.Tensor, prev_spectra: torch.Tensor,
                  arrays: dict, controls: spectral.Controls,
                  flags: spectral.SpectralFlags,
                  consts: spectral.SpectralConsts, debug: bool = False,
                  seeds=None):
    """spectra/prev_spectra [batch, nB, ch, B] complex64; arrays = a plan's
    (the schedule's numpy flags and engine.plan_tables' tables);
    seeds, one integer a clip (default 0, 1, ...), seed the randomised
    regime above 2x.  Returns SweepInputs, or (SweepInputs, dict of
    intermediates) with debug=True."""
    batch, nB, ch, B = spectra.shape
    dev = spectra.device
    longv = consts.long_vertical_step
    new = arrays["new_spectrum"]
    reanalyse = arrays["reanalyse"]
    tf, ltf = arrays["tf"], arrays["ltf"]
    any_random = bool((tf > f32(MAX_CLEAN_STRETCH)).any())
    if controls.automated and len(controls.freq_multiplier) != nB:
        raise ValueError(f"per-block controls of "
                         f"{len(controls.freq_multiplier)} blocks for a plan "
                         f"of {nB}")
    dbg = {}
    rotor = on_device(consts.rotor, dev)

    def blocks(z, idx):
        return z[:, on_device(arrays[idx], dev)]

    def bmask(keep):
        return on_device(arrays[keep], dev)[None, :, None, None]

    # ---- static input/prevInput chains (:332-376, 806-812) ----------------
    with span("sst.plan.inputs"):
        if new.all():     # every block's input is its own
            input_eff = spectra
        else:
            input_eff = coefficients.where0(bmask("input_valid"),
                                            blocks(spectra, "input_idx"))
        if reanalyse.all():
            prev_base = prev_spectra
        else:
            prev_base = torch.where(bmask("reanalyse"), prev_spectra,
                                    blocks(spectra, "base_idx"))
            prev_base = coefficients.where0(bmask("base_keep"), prev_base)
        if new.all():
            prev_eff = prev_base * rotor
        else:
            prev_eff = torch.where(bmask("new_spectrum"), prev_base * rotor,
                                   prev_base)

        in_energy = (input_eff.real * input_eff.real
                     + input_eff.imag * input_eff.imag)  # [batch, nB, ch, B]
    R = batch * nB

    def rows(z):
        return z.reshape(R, B)

    if any_random:
        # ---- random binTimeFactors (:747-757) per bin, from each clip's
        # seed: btf1 for the down votes, btf2 for the up votes -------------
        seeds = range(batch) if seeds is None else [int(x) for x in seeds]
        if len(seeds) != batch:
            raise ValueError(f"{len(seeds)} seeds for {batch} clips")
        with span("sst.plan.draws"):
            btf1, btf2 = (rows(t) for t in _random_time_factors(
                tf, seeds, B, flags, dev))
        if debug:
            dbg.update(btf1=btf1, btf2=btf2)
    if flags.mapped or flags.process_formants:
        # cross-channel energy, before the formant ratio
        with span("sst.plan.energy"):
            energy = in_energy[:, :, 0]
            for c in range(1, ch):
                energy = energy + in_energy[:, :, c]
            energy = energy.reshape(R, B).contiguous()

    if flags.mapped:
        # ---- smoothing + peaks + output map (:816-917) --------------------
        # two steps, each a down then an up pass, each pass from the
        # previous one's last value: four passes in one launch (kernel C)
        with span("sst.plan.smooth"):
            sm, _ = scan_ops.iir_chain(
                energy, torch.zeros(R, dtype=torch.float32, device=dev),
                consts.slew, (True, False, True, False))
        # the peaks and output map in one launch (kernel G), which also
        # writes kernel A's three position sets: input_bin, input_bin - tf
        # and input_bin - longv*tf of each row's block (:744-786)
        with span("sst.plan.peaks"):
            tf_d, ltf_d = on_device(tf, dev), on_device(ltf, dev)
            if flags.custom_map is not None:
                # a custom map (a Python callable) runs between G's runs
                # entry and its out entry, on the card
                pos, freq_grad = peaks.peaks_positions_custom(
                    energy, sm, tf_d, ltf_d, flags.custom_map, consts)
            else:
                pos, freq_grad = peaks.peaks_positions(
                    energy, sm, tf_d, ltf_d, controls, consts)
        if debug:
            dbg.update(energy=energy, smoothed=sm, input_bin=pos[:, 0],
                       freq_grad=freq_grad, pos=pos, shifts=(tf_d, ltf_d))

    if flags.process_formants:
        # ---- formants (:970-1036): every later read of in_energy (the
        # interp rows, the unmapped prediction energies) sees the ratio ----
        with span("sst.plan.formant"):
            ratio, _ = _formant_ratio(energy, batch, controls, flags, consts,
                                      dbg if debug else None)
            in_energy = in_energy * ratio.reshape(batch, nB, 1, B)

    if any_random:
        with span("sst.plan.positions"):
            if flags.mapped:
                # the four vote sets beside G's input_bin
                pos = torch.stack([pos[:, 0]] + _random_vote_positions(
                    pos[:, 0], btf1, btf2, longv), 1)
            else:
                # per-bin vote positions about the identity map, b less
                # the drawn factors
                base = torch.arange(B, dtype=torch.float32, device=dev)
                pos = torch.stack(_random_vote_positions(base, btf1, btf2,
                                                         longv), 1)

    with span("sst.plan.lookup"):
        if flags.mapped:
            # ---- prediction lookups at the mapped positions (:697-719) ----
            # one multi-set call (kernel A) on G's position sets: the
            # prelim lookups of input, prevInput and energy at input_bin,
            # and the vote taps of the input at input_bin - tf and
            # input_bin - longv*tf; in the randomised regime the four vote
            # sets at the drawn factors
            rows_list = ([rows(input_eff[:, :, c]) for c in range(ch)]
                         + [rows(prev_eff[:, :, c]) for c in range(ch)]
                         + [rows(in_energy[:, :, c]) for c in range(ch)])
            specs = [(pos[:, 0], 3 * ch)] + [(pos[:, k], ch)
                                              for k in range(1, pos.shape[1])]
            vals, *votes = _lookup(rows_list, specs, pos, batch,
                                   dbg if debug else None)
            pos_grad = torch.clamp(freq_grad.reshape(batch, nB, B), min=0)
            pi = vals[:ch]
            prev_i = vals[ch:2 * ch]
            pe = [v * pos_grad for v in vals[2 * ch:]]
        else:
            pe = [in_energy[:, :, c] for c in range(ch)]
            pi = [input_eff[:, :, c] for c in range(ch)]
            prev_i = [prev_eff[:, :, c] for c in range(ch)]
            if any_random:
                # four sets over the input's planes (kernel A)
                votes = _lookup([rows(p) for p in pi],
                                [(pos[:, k], ch) for k in range(4)], pos,
                                batch, dbg if debug else None)
            else:
                votes = [[interp._interp_shift_static(p, tf) for p in pi],
                         [interp._interp_shift_static(p, ltf) for p in pi]]

    # ---- the chain and vote coefficients (:722-803): one launch (kernel J)
    with span("sst.plan.coefficients"):
        a1, a2, d1, d2, mc = coefficients.coefficients(pi, prev_i, pe, votes,
                                                       rotor, new, longv)
    if debug:
        dbg.update(coefficients=(pi, prev_i, pe, votes, rotor, new, longv))

    result = SweepInputs(a1=a1, a2=a2, d1=d1, d2=d2, mc=mc,
                         pe=tuple(pe), pi=tuple(pi))
    return (result, dbg) if debug else result
