"""The clips the traffic is made of: synth_clip's kinds, mixed in pairs.

`synth_clip` and `KINDS` are copied from
signalsmith_stretch_torch/utils/evaluation.py (itself a copy of the JAX
package's): deterministic mono clips of eight characters (harmonic, sweep,
noise, transients, chords, vibrato, voice, silence edges).  The traffic's
clips are pairs of kinds: a run's seed draws each kind's noise, the order
of the pairs, the slice of each kind a clip takes, the gains and the
delay between the channels; every seed gets the same set of pairs, so
every seed gives the program the same kinds of work.
"""
from __future__ import annotations

import itertools

import numpy as np

KIND_SEEDS = {"harmonic": 101, "sweep": 202, "noise": 303, "transients": 404,
              "chords": 505, "vibrato": 606, "voice": 707,
              "silence_edges": 808}
KINDS = list(KIND_SEEDS)
# the original 4 kinds, for callers wanting the round-2 quick corpus
KINDS_BASIC = ["harmonic", "sweep", "noise", "transients"]


def synth_clip(kind: str, rate: int, seconds: float,
               seed: int | None = None) -> np.ndarray:
    """Deterministic mono test clip [1, n] float32 of the given character.

    The richer kinds approximate what the reference's real-music system
    corpus (cmd/CMakeLists.txt:12-18, network-fetched) exercises and the
    basic four don't: dense polyphonic peak structure (chords), moving
    partials (vibrato), speech-like formant tracks over a pitch contour
    (voice), and hard silence boundaries (silence_edges)."""
    rng = np.random.default_rng(KIND_SEEDS[kind] if seed is None else seed)
    t = np.arange(int(rate * seconds)) / rate
    if kind == "harmonic":
        sig = sum((0.5 / (i + 1)) * np.sin(2 * np.pi * 130 * (i + 1) * t + i)
                  for i in range(6))
    elif kind == "sweep":
        sig = 0.5 * np.sin(2 * np.pi * (100 * t + 400 * t * t))
    elif kind == "noise":
        sig = 0.3 * rng.standard_normal(t.shape)
    elif kind == "transients":
        sig = np.zeros_like(t)
        sig[::1600] = 1.0
        k = np.exp(-np.arange(200) / 30.0)
        sig = np.convolve(sig, k)[:t.size] * 0.5
    elif kind == "chords":
        # two alternating triads, 4 harmonics each: dense polyphonic peaks
        roots = np.where((t % 1.0) < 0.5, 196.0, 220.0)       # G3 / A3
        sig = np.zeros_like(t)
        for ratio in (1.0, 1.25992105, 1.49830708):           # root/maj3/5th
            for h in range(1, 5):
                sig += (0.22 / h) * np.sin(
                    2 * np.pi * np.cumsum(roots * ratio * h) / rate)
    elif kind == "vibrato":
        # 5.5 Hz vibrato (+-3%) on a 4-harmonic 220 Hz tone + slow tremolo
        f0 = 220.0 * (1.0 + 0.03 * np.sin(2 * np.pi * 5.5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / rate
        sig = sum((0.4 / h) * np.sin(h * phase) for h in range(1, 5))
        sig *= 1.0 + 0.2 * np.sin(2 * np.pi * 1.3 * t)
    elif kind == "voice":
        # speech-like: glottal-ish pulse train on a pitch contour, shaped by
        # two formant resonators gliding between vowel targets (a -> i)
        f0 = 120.0 * 2 ** (0.3 * np.sin(2 * np.pi * 0.8 * t))
        phase = np.cumsum(f0) / rate
        pulses = ((phase % 1.0) < 0.08).astype(np.float64)
        x = pulses - np.mean(pulses)

        def resonate(x, fc, bw):
            # 2-pole resonator with a per-sample gliding centre frequency
            r = np.exp(-np.pi * bw / rate)
            b1 = 2 * r * np.cos(2 * np.pi * fc / rate)      # [n]
            b2 = -r * r
            y = np.zeros_like(x)
            for i in range(2, x.size):   # slow but deterministic host code
                y[i] = x[i] + b1[i] * y[i - 1] + b2 * y[i - 2]
            return y

        glide = 1 - t / t[-1]
        sig = 0.4 * resonate(x, 700 * glide + 300 * (1 - glide), 110.0) \
            + 0.25 * resonate(x, 1100 * glide + 2200 * (1 - glide), 140.0)
        sig = 0.5 * sig / (np.abs(sig).max() + 1e-9)
    elif kind == "silence_edges":
        # tone bursts separated by hard zeros: silence-boundary behaviour
        env = (((t % 0.5) < 0.27) & (t > 0.1)).astype(np.float64)
        sig = env * 0.5 * np.sin(2 * np.pi * 330 * t)
        return sig[None, :].astype(np.float32)   # no dither: keep true zeros
    else:
        raise ValueError(kind)
    sig = sig + 0.01 * rng.standard_normal(t.shape)
    return sig[None, :].astype(np.float32)


SILENT = "silence_edges"


def kind_bank(rate: int, seconds: float, seed: int) -> dict:
    """Each kind once, `seconds` long (mono float32), its noise drawn from
    the run's seed."""
    ss = np.random.SeedSequence(seed % 2 ** 64)
    kid = ss.spawn(len(KINDS))
    return {k: synth_clip(k, rate, seconds,
                          seed=int(s.generate_state(1)[0]))
            for k, s in zip(KINDS, kid)}


def pair_list(rng: np.random.Generator, count: int, silent_every: int):
    """count pairs of kinds: every silent_every-th pair is gated by the
    silence edges' envelope (hard zeros between bursts), the others are
    the pairs of the other kinds, all of them before any repeats, each
    round in the seed's order."""
    loud = [k for k in KINDS if k != SILENT]
    pairs = list(itertools.combinations(loud, 2))
    out, pool = [], []
    for i in range(count):
        if not pool:
            pool = [pairs[j] for j in rng.permutation(len(pairs))]
        a, b = pool.pop()
        out.append((a, b, (i % silent_every) == silent_every - 1))
    return out


def _take(sig: np.ndarray, start: int, n: int) -> np.ndarray:
    """sig[start:start + n], wrapping around its end."""
    L = len(sig)
    start %= L
    if start + n <= L:
        return sig[start:start + n]
    reps = -(-(start + n) // L)
    return np.tile(sig, reps)[start:start + n]


def mix(bank: dict, pair, rng: np.random.Generator, n: int,
        channels: int, rate: int) -> np.ndarray:
    """One clip [channels, n]: the pair's kinds, each from an offset drawn
    in its bank signal (wrapping), with drawn gains, the channels a few
    samples apart; a gated pair keeps the silence edges' hard zeros."""
    a, b, gated = pair
    L = len(bank[a][0])
    out = np.empty((channels, n), np.float32)
    ga, gb = (np.float32(g) for g in rng.uniform(0.3, 0.6, 2))
    oa, ob = (int(x) for x in rng.integers(0, L, 2))
    delay = int(rng.integers(1, max(2, rate // 1000)))
    for c in range(channels):
        out[c] = (ga * _take(bank[a][0], oa + c * delay, n)
                  + gb * _take(bank[b][0], ob + 2 * c * delay, n))
    if gated:
        out *= (_take(bank[SILENT][0], oa, n) != 0)[None]
    return out


def batch(bank: dict, rng: np.random.Generator, clips: int, n: int,
          channels: int, rate: int, silent_every: int) -> np.ndarray:
    """[clips, channels, n] float32 of drawn pairs."""
    return np.stack([mix(bank, p, rng, n, channels, rate)
                     for p in pair_list(rng, clips, silent_every)])


def tiles(bank: dict, rng: np.random.Generator, seconds: float,
          tile_seconds: float, channels: int, rate: int,
          silent_every: int) -> np.ndarray:
    """A long buffer [channels, seconds*rate] of tiles, each a drawn
    pair."""
    n_tile = int(round(tile_seconds * rate))
    count = -(-int(round(seconds * rate)) // n_tile)
    parts = [mix(bank, p, rng, n_tile, channels, rate)
             for p in pair_list(rng, count, silent_every)]
    return np.concatenate(parts, 1)[:, :int(round(seconds * rate))]
