"""The port's seeded draws (prng.py) against jax.random, on the CPU.

Tolerance: bit equality, of the keys, the 32-bit words and the float32
draws.  `jax.random.uniform` is compiled by XLA, which on the CPU fuses
`floats * (maxval - minval) + minval` into one multiply-add; the port
rounds it once too, and this file shows that rounding the product and the
sum apart gives other bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import engine, planner, prng  # noqa: E402
from signalsmith_stretch_torch.config import MAX_CLEAN_STRETCH  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402

f32 = np.float32
SEEDS = [0, 1, 7, 2 ** 31 - 1, -5]


def _bounds(nB, seed=0):
    """The planner's bounds for nB blocks: time factors below 2x, just
    above it and up to 4x; lo_d = 4 * (tf > 2) - tf.  As [1, nB, 1]."""
    rng = np.random.default_rng(seed)
    tf = np.concatenate([rng.uniform(0.5, 2, nB // 3),
                         2 + rng.uniform(0, 1e-3, nB // 3),
                         rng.uniform(2, 4, nB - 2 * (nB // 3))]).astype(f32)
    lo = (f32(4) * (tf > f32(2)).astype(f32) - tf).astype(f32)
    return lo[None, :, None], tf[None, :, None]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_bits_match_jax(seed):
    assert prng.key(seed) == tuple(
        int(v) for v in np.asarray(jax.random.PRNGKey(seed)))
    for shape in [(7,), (3, 1001), (2, 5, 33)]:
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                          jnp.uint32)).astype(np.int64)
        got = prng.random_bits(prng.key(seed), shape).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(2, 40, 4097), (2, 7, 3), (2, 1, 1)])
def test_uniform_matches_jax(seed, shape):
    """The planner's draws (2, nB, B), per-block bounds broadcast: bit
    for bit; and with two roundings in place of the fused one, not."""
    lo, hi = _bounds(shape[1], seed=shape[1])
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         jnp.float32, minval=lo, maxval=hi))
    got = prng.uniform(prng.key(seed), shape, torch.as_tensor(lo),
                       torch.as_tensor(hi)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if shape == (2, 40, 4097):
        bits = prng.random_bits(prng.key(seed), shape).numpy()
        u = ((bits >> 9) | 0x3F800000).astype(np.int32).view(f32) - f32(1)
        apart = np.maximum(lo, (u * (hi - lo) + lo).astype(f32))
        assert (apart.view(np.int32) != want.view(np.int32)).any()


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.7, 2.7), (1.9999, 2.0)])
def test_uniform_scalar_bounds_match_jax(lo, hi):
    shape = (5, 13)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), shape,
                                         jnp.float32, minval=lo, maxval=hi))
    got = prng.uniform(prng.key(3), shape, f32(lo), f32(hi)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_f32_rounds_once():
    """fma_f32 against the float64 product and sum rounded to float32,
    which equals the once-rounded result whenever the float64 sum is exact
    (exponents close); and on values where it is not, against exact
    rational arithmetic."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, 20000).astype(f32)
    b = rng.uniform(0.5, 4, 20000).astype(f32)
    c = rng.uniform(-4, 4, 20000).astype(f32)
    got = prng.fma_f32(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    ref = (a.astype(np.float64) * b + c).astype(f32)
    np.testing.assert_array_equal(got, ref)
    # far exponents: c large against a tiny product
    a2, b2 = a[:300] * f32(1e-4), b[:300]
    c2 = (rng.uniform(1, 2, 300) * 1e3).astype(f32)
    got = prng.fma_f32(*(torch.as_tensor(x) for x in (a2, b2, c2))).numpy()
    for x, y, z, g in zip(a2, b2, c2, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = f32(float(exact))
        cands = [np.nextafter(lo, f32(-np.inf)), lo,
                 np.nextafter(lo, f32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.asarray(v).view(np.int32))
                                         & 1))
        assert g == best


def test_model_seeds_are_jax_batched_seeds(stereo_signal):
    """A batch's default seeds are 0, 1, ... (JAX StretchModel.batched):
    the planner's per-bin factors of clip 1 are JAX's draws from
    PRNGKey(1) in the blocks above 2x (every block at 2.5x)."""
    sig, rate = stereo_signal
    n = sig.shape[1]
    model = StretchModel.build(2, rate, n, int(2.5 * n), device="cpu")
    clips = torch.as_tensor(np.stack([sig, sig[:, ::-1].copy()]))
    spectra, prev = engine.analyze_stage(clips, model.plan)
    _, dbg = planner.plan_spectral(spectra, prev, model.plan.arrays,
                                   model.controls, model.flags,
                                   model.plan.consts, debug=True)
    nB, B = spectra.shape[1], spectra.shape[3]
    tf = np.maximum(model.plan.arrays["time_factor"],
                    f32(1 / MAX_CLEAN_STRETCH)).astype(f32)
    rnd = tf > f32(MAX_CLEAN_STRETCH)
    assert rnd.any()
    lo = (f32(4) * rnd.astype(f32) - tf).astype(f32)
    for clip in range(2):
        draws = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(clip), (2, nB, B), jnp.float32,
            minval=lo[None, :, None], maxval=tf[None, :, None]))
        for k, name in enumerate(("btf1", "btf2")):
            want = np.where(rnd[:, None], draws[k], tf[:, None])
            got = dbg[name].numpy()[clip * nB:(clip + 1) * nB]
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, -1, 2 ** 31])
def test_split_matches_jax(seed):
    """prng.split is jax.random.split, word for word: two keys and three,
    and along a chain of 64 splits that keeps the first key and draws from
    the second (a stream's per-block `rng, sub = split(rng)`)."""
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    assert k == tuple(int(v) for v in np.asarray(jk))
    for num in (2, 3):
        want = [tuple(int(v) for v in row)
                for row in np.asarray(jax.random.split(jk, num))]
        assert prng.split(k, num) == want
    for _ in range(64):
        jk, jsub = jax.random.split(jk)
        k, sub = prng.split(k)
        assert (k, sub) == (tuple(int(v) for v in np.asarray(jk)),
                            tuple(int(v) for v in np.asarray(jsub)))
    want = np.asarray(jax.random.uniform(jsub, (2, 9), jnp.float32,
                                         minval=-1.5, maxval=3.0))
    got = prng.uniform(sub, (2, 9), f32(-1.5), f32(3.0)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
