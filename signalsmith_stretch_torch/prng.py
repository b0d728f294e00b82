"""Seeded uniform draws, bit-equal to JAX's default generator.

The randomised binTimeFactors of stretches above 2x (signalsmith-stretch.h:
747-757) come from `jax.random.uniform(jax.random.PRNGKey(seed), shape,
float32, minval, maxval)` in the JAX package.  This module computes the same
bits with plain torch integer ops, on any device; on the card the renders
and the stream blocks draw through kernel I (ops/draws.py, csrc/draws.cu),
whose plain version `uniform` is:

- `key(seed)`: PRNGKey of a 32-bit seed (jax/_src/prng.py `_threefry_seed`),
  the pair (0, seed mod 2**32).  A negative seed maps to its two's
  complement (-1 -> 0xFFFFFFFF), and a seed outside 32 bits keeps its low
  32 bits, as JAX does without 64-bit mode.
- `split(k, num)`: jax.random.split with `jax_threefry_partitionable` (the
  default): key i is the two output words of the hash of the count pair
  (0, i) (prng.py `_threefry_split_foldlike`).  It runs on the host, on
  Python ints, so a stream's per-block split launches nothing.
- `threefry2x32`: the Threefry-2x32 hash, 20 rounds (prng.py
  `_threefry2x32_lowering`).
- `random_bits`: with `jax_threefry_partitionable` (the default), the hash
  of the two 32-bit halves of a 64-bit iota over the shape, row-major,
  and the xor of its two outputs (prng.py `_threefry_random_bits_
  partitionable`, `iota_2x32_shape`).
- `uniform`: `bits >> 9 | 0x3F800000` bitcast to float32, less 1, then
  `floats * (maxval - minval) + minval` and `max(minval, .)`
  (jax/_src/random.py `_uniform`).  XLA on the CPU contracts the product
  and the sum into one fused multiply-add, so the port rounds them once
  too (`fma_f32`); tests/test_torch_prng.py pins the bits, and shows that
  two roundings differ.

torch's uint32 lacks shifts and xor on some backends, so the words are
int64 tensors masked to 32 bits: ~210 PyTorch ops a `uniform` call.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def key(seed) -> tuple:
    """PRNGKey(seed): the pair of 32-bit words (0, seed mod 2**32)."""
    return (0, int(seed) & M32)


def split(k: tuple, num: int = 2) -> list:
    """jax.random.split(k, num): `num` keys, each a pair of 32-bit words
    (Python ints), computed on the host."""
    return [tuple(threefry2x32(k, 0, i)) for i in range(int(num))]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(k: tuple, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the count words x0, x1 (int64 tensors holding 32-bit
    values, or Python ints) under the key pair k: the two output words,
    of the same kind."""
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
    """32 random bits per element of `shape` (int64 values in [0, 2**32)),
    jax.random.bits(key, shape, uint32)."""
    n = 1
    for s in shape:
        n *= int(s)
    count = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k, count >> 32, count & M32)
    return (b0 ^ b1).reshape(tuple(shape))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """a * b + c for float32 tensors, rounded once (a fused multiply-add).
    The product is exact in float64 (24 + 24 bits); the sum is taken in
    float64 rounded to odd (the two-sum error decides the last bit) and
    then rounded to float32, which rounds the exact value correctly since
    53 >= 24 + 2 bits (Boldo and Melquiond, "Emulation of FMA and correctly
    rounded sums", 2008)."""
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


def uniform(k: tuple, shape, minval, maxval, device=None) -> torch.Tensor:
    """jax.random.uniform(k, shape, float32, minval, maxval): minval and
    maxval float32 tensors (or numbers) that broadcast to `shape`."""
    bits = random_bits(k, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    minval = torch.as_tensor(minval, dtype=torch.float32, device=floats.device)
    maxval = torch.as_tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(minval, fma_f32(floats, maxval - minval, minval))
