"""The seeded per-bin time factors of stretches above 2x, in plain PyTorch.

Above maxCleanStretch = 2 the reference draws each bin's binTimeFactor at
random (signalsmith-stretch.h:509, 639-640, 747-757).  A frozen copy of
the port's plain draws (signalsmith_stretch_torch/prng.py `uniform` and
ops/draws.py `draws_factors_plain`), bit-equal to `jax.random.uniform`
with JAX's default, partitionable Threefry-2x32:

- `key(seed)`: the pair (0, seed mod 2**32);
- `threefry2x32`: the hash, 20 rounds, on 32-bit words held in int64
  tensors (torch's uint32 lacks shifts and xor on some backends);
- `random_bits`: the hash of the two halves of a 64-bit row-major count
  over the shape, its two output words xor-ed;
- `uniform`: `bits >> 9 | 0x3F800000` as float32, less 1, then
  `floats * (hi - lo) + lo` rounded once (XLA contracts it into a fused
  multiply-add on the CPU; `fma_f32`), and `max(lo, .)`;
- `factors`: each clip's (2, nB, B) in [4 - tf, tf) from its own key, the
  blocks at or below 2x given tf itself (the per-block selects): btf1 from
  the first half of the counts, btf2 from the second.

Departure from the C++: the library draws from `std::default_random_
engine`; the port, and so this copy, from JAX's Threefry.  It imports
nothing of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import MAX_CLEAN_STRETCH

f32 = np.float32
M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def key(seed) -> tuple:
    """PRNGKey(seed): the pair of 32-bit words (0, seed mod 2**32)."""
    return (0, int(seed) & M32)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(k: tuple, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the count words x0, x1 under the key pair k."""
    ks = (k[0] & M32, k[1] & M32, (k[0] ^ k[1] ^ _PARITY) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def random_bits(k: tuple, shape, device=None) -> torch.Tensor:
    """32 random bits an element of `shape`, int64 values in [0, 2**32)."""
    n = int(np.prod(shape))
    count = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k, count >> 32, count & M32)
    return (b0 ^ b1).reshape(tuple(shape))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """a * b + c on float32 tensors, rounded once: the float64 product is
    exact, the float64 sum is rounded to odd, then to float32."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def uniform(k: tuple, shape, lo: torch.Tensor, hi: torch.Tensor,
            device=None) -> torch.Tensor:
    """jax.random.uniform(k, shape, float32, lo, hi), lo and hi float32
    tensors that broadcast to `shape`."""
    bits = random_bits(k, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    return torch.maximum(lo, fma_f32(floats, hi - lo, lo))


def bounds(time_factor: np.ndarray):
    """The blocks' bounds: tf (the schedule's time factors, at least 1/2),
    lo = 4 - tf where a block draws and -tf elsewhere, and the blocks that
    draw (tf > 2), as float32 and bool arrays [nB]."""
    tf = np.maximum(np.asarray(time_factor, f32),
                    f32(1.0 / MAX_CLEAN_STRETCH)).astype(f32)
    drawn = tf > f32(MAX_CLEAN_STRETCH)
    lo = (f32(MAX_CLEAN_STRETCH) * 2 * drawn.astype(f32) - tf).astype(f32)
    return tf, lo, drawn


def factors(seeds, time_factor: np.ndarray, B: int, device=None):
    """The per-bin time factors (btf1, btf2), each [batch, nB, B] float32:
    clip i's draws from key(seeds[i]) in the blocks that draw, tf in the
    others."""
    tf, lo, drawn = bounds(time_factor)
    nB = len(tf)
    tf_t = torch.as_tensor(tf, device=device)
    lo_t = torch.as_tensor(lo, device=device).view(1, nB, 1)
    sel = torch.as_tensor(drawn, device=device).view(nB, 1)
    d = torch.stack([uniform(key(s), (2, nB, B), lo_t, tf_t.view(1, nB, 1),
                             device) for s in seeds])
    tf_b = tf_t.view(nB, 1)
    return (torch.where(sel, d[:, 0], tf_b),
            torch.where(sel, d[:, 1], tf_b))
