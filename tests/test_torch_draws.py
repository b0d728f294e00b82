"""Kernel I's plain versions (ops/draws.py) against JAX, and a CPU model of
the kernel's walk, on the CPU.

Tolerance: bit equality.  The plain versions are prng.uniform (bit-equal
to `jax.random.uniform`, tests/test_torch_prng.py) and the per-block
selects; here they are held to the JAX package's own expressions: the
offline planner's (signalsmith_stretch_tpu/planner.py:481-490) and a
stream block's (signalsmith_stretch_tpu/spectral.py:455-467).  The walk
model replays csrc/draws.cu's thread-to-counter mapping and shows that
every element is written once, from its JAX counter.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import planner, prng  # noqa: E402
from signalsmith_stretch_torch.config import MAX_CLEAN_STRETCH  # noqa: E402
from signalsmith_stretch_torch.ops import draws  # noqa: E402
from signalsmith_stretch_torch.tables import on_device  # noqa: E402

f32 = np.float32
SOURCE = (Path(__file__).resolve().parents[1] / "signalsmith_stretch_torch"
          / "csrc" / "draws.cu").read_text()
THREADS = int(re.search(r"#define DRAWS_THREADS (\d+)", SOURCE).group(1))
# time factors per block: below 2x, 2x itself, just above, 4x exactly (the
# lower bound lo_d = 0), and between
TF_ROWS = {"one_4x": [4.0], "one_1.5x": [1.5],
           "seven_mixed": [0.5, 2.0, np.nextafter(f32(2), f32(3)), 4.0, 1.25,
                           3.0, 2.5]}
SEED_SETS = [(0,), (1,), (-1,), (2 ** 31,), (2 ** 32 + 5,), (0, -1, 2 ** 31),
             (1, 2 ** 32 + 5, 7)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _jax_factors(seed, tf, B):
    """The JAX planner's expressions (planner.py:481-490), one clip."""
    nB = len(tf)
    tf_j = jnp.asarray(tf)
    random_tf = jnp.asarray(tf > f32(MAX_CLEAN_STRETCH))
    lo_d = f32(MAX_CLEAN_STRETCH) * 2 * random_tf.astype(jnp.float32) - tf_j
    d = jax.random.uniform(jax.random.PRNGKey(seed), (2, nB, B), jnp.float32,
                           lo_d[None, :, None], tf_j[None, :, None])
    return (np.asarray(jnp.where(random_tf[:, None], d[0], tf_j[:, None])),
            np.asarray(jnp.where(random_tf[:, None], d[1], tf_j[:, None])))


@pytest.mark.parametrize("seeds", SEED_SETS,
                         ids=["-".join(map(str, s)) for s in SEED_SETS])
@pytest.mark.parametrize("rows", list(TF_ROWS))
@pytest.mark.parametrize("B", [4096, 37])
def test_factors_plain_match_jax(seeds, rows, B):
    """draws_factors_plain on the planner's cached keys and bounds against
    jax.random.uniform and jnp.where, bit for bit, clip by clip; the
    wrapper on a CPU tensor gives the same."""
    tf = np.asarray(TF_ROWS[rows], f32)
    cpu = torch.device("cpu")
    keys = planner._clip_keys(tuple(seeds), cpu)
    assert keys.dtype == torch.uint32
    assert keys.tolist() == [list(prng.key(s)) for s in seeds]
    tf_t, lo_d, random_tf = on_device(tf, cpu, planner.draw_bounds)
    got = draws.draws_factors_plain(keys, tf_t, lo_d, random_tf, B)
    again = draws.draws_factors(keys, tf_t, lo_d, random_tf, B)
    for clip, seed in enumerate(seeds):
        want = _jax_factors(seed, tf, B)
        for g, a, w in zip(got, again, want):
            assert g.shape == (len(seeds), len(tf), B)
            np.testing.assert_array_equal(_bits(g[clip]), _bits(w))
            np.testing.assert_array_equal(_bits(a[clip]), _bits(w))


def test_lo_zero_at_4x_and_keys_past_2_31():
    """At exactly 4x the lower bound is +0 and the draws span [0, 4); the
    keys of seeds -1 and 2**31 keep their top bit as uint32."""
    cpu = torch.device("cpu")
    _, lo_d, _ = on_device(np.asarray([4.0], f32), cpu, planner.draw_bounds)
    assert lo_d.item() == 0.0 and not torch.signbit(lo_d).any()
    keys = planner._clip_keys((-1, 2 ** 31), cpu)
    assert keys.tolist() == [[0, 0xFFFFFFFF], [0, 0x80000000]]


@pytest.mark.parametrize("seed", [0, 2 ** 31, -1])
@pytest.mark.parametrize("B", [4096, 37])
def test_block_plain_match_jax(seed, B):
    """draws_block_plain under 16 consecutive split keys of a stream
    (`rng, sub = split(rng)` each block) against the JAX stream's draws
    and selects (spectral.py:455-467), at time factors above 2x up to a
    flush's 1440."""
    factors = [2.5, 3.0, 4.0, 1440.0, float(np.nextafter(f32(2), f32(3))),
               2.0000005, 6.0, 3.5]
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    for blk in range(16):
        jk, jsub = jax.random.split(jk)
        k, sub = prng.split(k)
        assert sub == tuple(int(v) for v in np.asarray(jsub))
        tf_in = f32(factors[blk % len(factors)])
        tf = jnp.maximum(tf_in, f32(1.0 / MAX_CLEAN_STRETCH))
        random_tf = tf > f32(MAX_CLEAN_STRETCH)
        lo = f32(MAX_CLEAN_STRETCH) * 2 * random_tf.astype(jnp.float32) - tf
        d = jax.random.uniform(jsub, (2, B), jnp.float32, minval=lo,
                               maxval=tf)
        want = [np.asarray(jnp.where(random_tf, d[i], tf)) for i in (0, 1)]
        # the port's bounds (spectral.process_block)
        tf_p = max(tf_in, f32(1 / MAX_CLEAN_STRETCH))
        lo_p = f32(f32(2 * MAX_CLEAN_STRETCH) - tf_p)
        got = draws.draws_block_plain(sub, lo_p, tf_p, B, "cpu")
        again = draws.draws_block(sub, lo_p, tf_p, B, "cpu")
        assert got.shape == (2, B)
        for i in (0, 1):
            np.testing.assert_array_equal(_bits(got[i]), _bits(want[i]))
            np.testing.assert_array_equal(_bits(again[i]), _bits(want[i]))


def walk_model(batch, nB, B, draw, ctas):
    """csrc/draws.cu's walk on the CPU: `ctas` CTAs of THREADS threads
    stride over items = batch * nB * ceil(B / 4), item i being the 4 bins
    from b0 = 4 (i % quads) of row i // quads = clip * nB + blk; a row
    whose block draws hashes counts blk*B + b0 + j (btf1) and nB*B + blk*B
    + b0 + j (btf2), and every bin b0 + j < B is stored.  Returns, for
    btf1 and btf2 [batch, nB, B], the number of stores of each element
    and the count it was drawn from (-1: tf written, nothing hashed)."""
    quads = (B + 3) // 4
    items = batch * nB * quads
    writes = np.zeros((2, batch * nB, B), np.int64)
    count = np.full((2, batch * nB, B), -2, np.int64)
    stride = ctas * THREADS
    for start in range(0, items, stride):              # each loop trip
        i = start + np.arange(min(stride, items - start))  # every thread
        row = i // quads
        b0 = (i - row * quads) * 4
        blk, clip = row % nB, row // nB
        assert (clip < batch).all()
        for j in range(4):
            b = b0 + j
            ok = b < B
            c1 = blk * B + b
            c2 = c1 + nB * B
            for h, c in ((0, c1), (1, c2)):
                np.add.at(writes[h], (row[ok], b[ok]), 1)
                count[h, row[ok], b[ok]] = np.where(draw[blk[ok]], c[ok], -1)
    shape = (2, batch, nB, B)
    return writes.reshape(shape), count.reshape(shape)


def _values_from_counts(count, key, lo, hi, tf):
    """The kernel's arithmetic on the model's counts: threefry bits of the
    count's halves, the float, the fused multiply-add, the max; tf where
    nothing was hashed."""
    c = torch.as_tensor(np.maximum(count, 0))
    b0, b1 = prng.threefry2x32(key, c >> 32, c & prng.M32)
    bits = b0 ^ b1
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = torch.as_tensor(lo), torch.as_tensor(hi)
    v = torch.maximum(lo, prng.fma_f32(f, hi - lo, lo))
    return torch.where(torch.as_tensor(count >= 0), v, torch.as_tensor(tf))


@pytest.mark.parametrize("batch,nB,B,ctas", [
    (1, 1, 4096, 4), (3, 7, 37, 1), (2, 7, 4096, 3), (1, 5, 1, 2),
    (2, 3, 6, 1), (1, 2, 4097, 1000)],
    ids=["block", "odd_B", "many_trips", "B1", "B6", "one_trip"])
def test_walk_model_writes_each_element_once(batch, nB, B, ctas):
    """Every element of btf1 and btf2 is stored exactly once, by the
    thread whose item holds it, from JAX's counter (the row-major iota over
    (2, nB, B)) in the blocks that draw, and from none elsewhere; the
    model's values from those counts are the plain version's bits."""
    rng = np.random.default_rng(batch * 100 + nB * 10 + B)
    tf = rng.choice(np.asarray([1.5, 2.0, 2.5, 3.0, 4.0], f32), nB)
    tf[0] = f32(3.0)                       # some block draws
    draw = tf > f32(MAX_CLEAN_STRETCH)
    writes, count = walk_model(batch, nB, B, draw, ctas)
    assert (writes == 1).all()
    blk = np.arange(nB)[None, :, None]
    b = np.arange(B)[None, None, :]
    for h in (0, 1):
        want = np.where(draw[None, :, None], h * nB * B + blk * B + b, -1)
        np.testing.assert_array_equal(count[h], np.broadcast_to(
            want, count[h].shape))
    seeds = tuple(range(batch))
    cpu = torch.device("cpu")
    tf_t, lo_d, random_tf = on_device(tf, cpu, planner.draw_bounds)
    plain = draws.draws_factors_plain(planner._clip_keys(seeds, cpu), tf_t,
                                      lo_d, random_tf, B)
    for clip, seed in enumerate(seeds):
        for h in (0, 1):
            v = _values_from_counts(count[h, clip], prng.key(seed),
                                    lo_d.numpy()[:, None],
                                    tf[:, None], tf[:, None])
            np.testing.assert_array_equal(_bits(v), _bits(plain[h][clip]))


@pytest.mark.parametrize("B", [4096, 37])
def test_walk_model_stream_block(B):
    """The stream block's entry is the same walk at batch 1, nB 1, with
    btf2 B floats after btf1: the counts of (2, B), row-major, and the
    plain version's bits."""
    writes, count = walk_model(1, 1, B, np.asarray([True]), 1)
    assert (writes == 1).all()
    flat = np.concatenate([count[0, 0, 0], count[1, 0, 0]])
    np.testing.assert_array_equal(flat, np.arange(2 * B))
    key, lo, hi = (7, 0x9E3779B9), f32(1.0), f32(3.0)
    v = _values_from_counts(flat.reshape(2, B), key, lo, hi, hi)
    got = draws.draws_block_plain(key, lo, hi, B, "cpu")
    np.testing.assert_array_equal(_bits(v), _bits(got))


def test_random_engine_skips_the_draws():
    """A user's engine (the reference's RandomEngine) replaces the draws on
    the offline path: it is called once a clip with JAX's arguments, and
    the selects keep tf in the blocks that do not draw."""
    from signalsmith_stretch_torch import spectral
    calls = []

    def engine(key, shape, lo, hi):
        calls.append((key, shape, tuple(lo.shape)))
        return torch.full(shape, 0.25)

    flags = spectral.SpectralFlags(mapped=False, random_engine=engine)
    tf = np.asarray([1.5, 3.0], f32)
    btf1, btf2 = planner._random_time_factors(tf, [0, 5], 8, flags, "cpu")
    assert calls == [((0, 0), (2, 2, 8), (1, 2, 1)),
                     ((0, 5), (2, 2, 8), (1, 2, 1))]
    for t in (btf1, btf2):
        assert t.shape == (2, 2, 8)
        assert (t[:, 0] == 1.5).all() and (t[:, 1] == 0.25).all()
