"""The seeded draws of stretches above 2x (kernel I, csrc/draws.cu).

Above 2x the reference draws a random time factor for every bin
(signalsmith-stretch.h:747-757); the JAX package takes them from
`jax.random.uniform`, which XLA compiles into one fused computation:

- `draws_factors` is the offline planner's (signalsmith_stretch_tpu/
  planner.py:481-490): for each clip's key, (2, nB, B) uniform in
  [lo_d, tf) per block, selected against tf per block, as btf1 and btf2
  [batch, nB, B] float32 in one launch;
- `draws_block` is a stream block's (signalsmith_stretch_tpu/spectral.py:
  455-467): (2, B) in [lo, hi) under the block's split key, with the key
  words and the bounds as kernel arguments (no copy to the card).

Both are bit-equal to their plain versions, `draws_factors_plain` and
`draws_block_plain`: `prng.uniform` (bit-equal to JAX's) and the selects.
On a CPU tensor (or device), or inside ops.plain(), a wrapper runs the
plain version; on a CUDA one it launches the kernel or raises.  A user's
RandomEngine (`SpectralFlags.random_engine`) does not come here: the
callers run it as they always did.
"""
from __future__ import annotations

import torch

from .. import prng
from . import _build, runs_plain

launches = 0          # kernel launches of draws_factors and draws_block


def select_blocks(draws: torch.Tensor, random_tf: torch.Tensor,
                  tf: torch.Tensor):
    """draws [batch, 2, nB, B] -> (btf1, btf2) [batch, nB, B]: the draws
    in the blocks that draw (random_tf [nB] bool), tf [nB] elsewhere
    (JAX planner.py:489-490)."""
    nB = tf.shape[0]
    sel, tf_b = random_tf.view(nB, 1), tf.view(nB, 1)
    return (torch.where(sel, draws[:, 0], tf_b),
            torch.where(sel, draws[:, 1], tf_b))


def draws_factors_plain(keys: torch.Tensor, tf: torch.Tensor,
                        lo_d: torch.Tensor, random_tf: torch.Tensor, B: int):
    """Plain version of `draws_factors` (same contract), on tf's device:
    each clip's prng.uniform of (2, nB, B), then the per-block select."""
    nB = tf.shape[0]
    lo, hi = lo_d.view(1, nB, 1), tf.view(1, nB, 1)
    draws = torch.stack([prng.uniform(tuple(k), (2, nB, B), lo, hi, tf.device)
                         for k in keys.cpu().tolist()])
    return select_blocks(draws, random_tf, tf)


def draws_factors(keys: torch.Tensor, tf: torch.Tensor, lo_d: torch.Tensor,
                  random_tf: torch.Tensor, B: int):
    """The offline per-bin time factors above 2x.  keys [batch, 2] uint32
    (prng.key of each clip's seed); tf, lo_d [nB] float32 (the blocks'
    upper and lower bounds) and random_tf [nB] bool (the blocks that
    draw).  Returns (btf1, btf2), each [batch, nB, B] float32: btf1 from
    the counts blk*B + b, btf2 from nB*B + blk*B + b, tf in the blocks
    that do not draw."""
    global launches
    if runs_plain(tf):
        return draws_factors_plain(keys, tf, lo_d, random_tf, B)
    _build.require_cuda(keys, tf, lo_d, random_tf)
    nB = tf.shape[0]
    if (keys.dtype != torch.uint32 or keys.dim() != 2 or keys.shape[1] != 2
            or tf.dtype != torch.float32 or lo_d.dtype != torch.float32
            or random_tf.dtype != torch.bool):
        raise TypeError("draws_factors: uint32 keys [batch, 2], float32 tf "
                        "and lo_d, bool random_tf expected")
    if tf.shape != (nB,) or lo_d.shape != (nB,) or random_tf.shape != (nB,):
        raise ValueError("draws_factors: tf, lo_d and random_tf must be [nB]")
    batch = keys.shape[0]
    out = torch.empty((2, batch, nB, B), dtype=torch.float32,
                      device=tf.device)
    rc = _build.entry("draws")(
        keys.data_ptr(), tf.data_ptr(), lo_d.data_ptr(), random_tf.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), batch, nB, B,
        torch.cuda.current_stream(tf.device).cuda_stream)
    _build.check(rc, "sst_draws_factors")
    launches += 1
    return out[0], out[1]


def draws_block_plain(key: tuple, lo, hi, B: int, device):
    """Plain version of `draws_block` (same contract): prng.uniform of
    (2, B) with the bounds as tensors on `device`."""
    device = torch.device(device)
    lo_t = torch.full((), float(lo), device=device)
    hi_t = torch.full((), float(hi), device=device)
    return prng.uniform(key, (2, B), lo_t, hi_t, device)


def draws_block(key: tuple, lo, hi, B: int, device):
    """One stream block's draws: (2, B) float32 uniform in [lo, hi) under
    the split key `key` (two 32-bit words, Python ints); lo and hi are
    float32 host numbers.  Returns [2, B] on `device`."""
    global launches
    device = torch.device(device)
    if runs_plain(device):
        return draws_block_plain(key, lo, hi, B, device)
    if device.type != "cuda":
        raise ValueError(f"draws_block: a CUDA device expected, got {device}")
    out = torch.empty((2, B), dtype=torch.float32, device=device)
    rc = _build.entry("draws_block")(
        int(key[0]) & prng.M32, int(key[1]) & prng.M32, float(lo), float(hi),
        out.data_ptr(), B, torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, "sst_draws_block")
    launches += 1
    return out
