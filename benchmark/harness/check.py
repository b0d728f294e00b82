"""The numbers that decide `correct`, each against its limit.

Offline renders: `chaos_gap`.  The render is chaotic against rounding
(docs/PARITY.md): two float32 renders that differ anywhere by an ulp
drift apart over a clip.  So each sampled clip is compared segment by
segment with the reference's render of it, and the gap is measured
against the reference's own drift on a probe: the same clip moved by
PROBE_ULPS ulps at every sample (signs drawn from the seed), about the
size of the card's analysis rounding against cuFFT (3e-6 of a spectrum's
peak).  chaos_gap is the largest, over clips and segments, of
rms(program - reference) / max(rms(probe - reference), FLOOR * the
clip's rms): near 1 where the program drifts as float32 does, far above
where it rounds coarser (the control, in bfloat16) or is wrong.

Streams (the node): the reference steps each sampled quantum from the
program's own state before it, so no drift builds up: `quantum_gap` is
the largest rms(program - reference) of those quanta's outputs over the
buffer's rms; `state_gap` the largest gap of the state after them (the
carry, the WOLA tail and weights, the input history): each field's
90th percentile of |program - reference| over the field's largest rms
in the sample.  The planner's discrete decisions (a peak kept or not,
the loudest channel, a weak prediction) flip on rounding in a few bins,
and in near-silent blocks in many, which an rms of the block's own
would read as the whole field's gap; the bfloat16 control, or a state
left unchanged, moves every bin of the loud blocks.  A host scalar that
differs reads 1e9.  `start_gap` is
`quantum_gap` over the node's first quanta: the first from the
reference's own initial state, the others from the program's states."""
from __future__ import annotations

import math

import numpy as np

PROBE_ULPS = 32
FLOOR = 1e-5
SEGMENT_SECONDS = 0.25
MISMATCH = 1e9
Q_STATE = 0.9


def probe(audio: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """audio moved by PROBE_ULPS ulps at every sample, signs drawn."""
    sign = rng.integers(0, 2, audio.shape).astype(np.float32) * 2 - 1
    return (audio + sign * np.float32(PROBE_ULPS)
            * np.spacing(audio)).astype(np.float32)


def _seg_rms(x: np.ndarray, seg: int) -> np.ndarray:
    """[n, ch, T] -> [n, segments] rms over channels and each segment."""
    n, ch, T = x.shape
    k = -(-T // seg)
    pad = np.zeros((n, ch, k * seg), np.float64)
    pad[..., :T] = x
    sq = (pad * pad).reshape(n, ch, k, seg).sum((1, 3))
    counts = np.full(k, seg * ch, np.float64)
    counts[-1] = (T - (k - 1) * seg) * ch
    return np.sqrt(sq / counts)


def chaos_gap(prog: np.ndarray, ref: np.ndarray, ref_probe: np.ndarray,
              rate: int) -> float:
    """The largest segment ratio over clips (arrays [n, ch, T])."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.isfinite(prog).all():
        return MISMATCH
    seg = int(SEGMENT_SECONDS * rate)
    ep = _seg_rms(prog - ref, seg)
    eq = _seg_rms(np.asarray(ref_probe, np.float64) - ref, seg)
    level = np.sqrt((ref * ref).mean((1, 2)))[:, None]
    den = np.maximum(eq, np.maximum(FLOOR * level, 1e-30))
    return float((ep / den).max())


def rel_gap(a, b, level: float) -> float:
    """rms(a - b) / level (a mismatch of shape or a non-finite a reads
    MISMATCH)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        return MISMATCH
    return float(np.sqrt(((a - b) ** 2).mean()) / max(level, 1e-30))


def state_gaps(pairs) -> dict:
    """{field: gap} over (program state, reference state) pairs, each a
    dict of fields: a tensor field's largest Q90 of |program - reference|
    over the field's largest rms among the reference's states (a near-
    silent block's decisions, which flip on rounding, weigh as little as
    its signal); a host scalar 0 where every pair agrees, else
    MISMATCH."""
    scale, worst = {}, {}
    for prog, ref in pairs:
        for k, r in ref.items():
            if isinstance(r, np.ndarray):
                scale[k] = max(scale.get(k, 0.0),
                               float(np.sqrt(np.mean(np.abs(
                                   np.asarray(r, np.complex128)) ** 2))))
    for prog, ref in pairs:
        for k, r in ref.items():
            p = prog[k]
            if not isinstance(r, np.ndarray):
                g = 0.0 if p == r else MISMATCH
            elif p.shape != r.shape or not np.isfinite(p).all():
                g = MISMATCH
            else:
                d = np.abs(np.asarray(p, np.complex128)
                           - np.asarray(r, np.complex128))
                g = float(np.quantile(d, Q_STATE)) / (scale[k] or 1.0)
            worst[k] = max(worst.get(k, 0.0), g)
    return worst


def decide(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limited number."""
    return {k: {"value": float(numbers[k]), "limit": float(limits[k]["limit"])}
            for k in limits if not k.startswith("_")}


def correct(checks: dict) -> bool:
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in checks.values())
