"""The port's interpolation (ops/interp.py) against the JAX package, on the CPU.

On a CPU tensor `interp_multi` runs its plain version, which the card's
kernel (csrc/interp.cu) is held to bit for bit in tests/test_torch_cuda.py.
Here the plain version is held to the JAX package's three forms of the same
contract: the per-plane gather (`_interp_gather`, run op by op), the XLA
windowed selection (`interp_planes_window_multi`) and the Pallas kernel
(`ops.pallas.interp.interp_multi`) in interpreter mode, run exactly as
tests/test_pallas_interp.py runs it.

Tolerance: bit equality for the taps (selections) and for the lerp
against the JAX gather run op by op, where `lo + (hi - lo) * frac` rounds
after each of its three operations as the port's does.  The windowed XLA
program and the Pallas interpreter compile the lerp, and XLA on the CPU
contracts it into a fused multiply-add (the JAX package's `_interp_mode`
docstring says so): there the port's lerp is bit-equal to the same lerp
rebuilt from the JAX taps in separate float32 operations, and within one
rounding (2^-22 of the largest plane value) of the JAX lerp itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch.ops import interp  # noqa: E402
from signalsmith_stretch_tpu import spectral as jspectral  # noqa: E402
from signalsmith_stretch_tpu.ops import interp as jinterp  # noqa: E402
from signalsmith_stretch_tpu.ops.pallas import interp as jpallas  # noqa: E402

ROWS, N, W0, B = 4, 4, 512, 256


def _planes(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((ROWS, N, W0)).astype(np.float32)


def _positions(kind, seed=0):
    """Position sets of the shapes the planner makes: near-monotone rows
    (some below 0 and past W0), a shifted copy, and unordered positions."""
    rng = np.random.default_rng(seed)
    base = (np.cumsum(rng.uniform(0.2, 2.0, (ROWS, B)), axis=1)
            .astype(np.float32) - 20)
    if kind == "monotone":
        return base
    if kind == "stretched":
        return (base * np.float32(2.2) + np.float32(3.7)).astype(np.float32)
    return rng.uniform(-5, W0 + 5, (ROWS, B)).astype(np.float32)


def _sets(taps):
    return [(_positions("monotone"), 3, taps),
            (_positions("stretched", 1), 4, taps),
            (_positions("random", 2), 2, taps)]


def _torch_sets(sets):
    return [(torch.as_tensor(p), n, t) for p, n, t in sets]


def _flat(results):
    out = []
    for r in results:
        out += list(r) if isinstance(r, tuple) else [r]
    return [np.asarray(x) for x in out]


def _check_compiled(got, ref, ref_taps, sets, planes):
    """got/ref: per-set lerp results of the port and of a compiled JAX
    path; ref_taps: the same JAX path in taps mode."""
    scale = np.float32(2.0 ** -22) * np.abs(planes).max()
    for g, r, (lo, hi), (pos, _, _) in zip(got, ref, ref_taps, sets):
        lo, hi = np.asarray(lo), np.asarray(hi)
        frac = (pos - np.floor(pos)).astype(np.float32)[:, None]
        np.testing.assert_array_equal(np.asarray(g), lo + (hi - lo) * frac)
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=0,
                                   atol=scale)


@pytest.mark.parametrize("kind", ["monotone", "stretched", "random"])
def test_interp_gather_matches_jax(kind):
    rows = _planes()[:, 0]
    pos = _positions(kind)
    got = interp._interp_gather(torch.as_tensor(rows), torch.as_tensor(pos))
    ref = jinterp._interp_gather(jnp.asarray(rows), jnp.asarray(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("taps", [False, True], ids=["lerp", "taps"])
def test_interp_multi_matches_jax_gather_per_plane(taps):
    planes = _planes()
    sets = _sets(taps)
    results, viol = interp.interp_multi(torch.as_tensor(planes),
                                        _torch_sets(sets))
    assert viol == 0
    for (pos, nsel, _), res in zip(sets, results):
        for j in range(nsel):
            rows, p = jnp.asarray(planes[:, j]), jnp.asarray(pos)
            if taps:
                li = jnp.floor(p).astype(jnp.int32)
                np.testing.assert_array_equal(
                    res[0][:, j].numpy(),
                    np.asarray(jspectral._gather_band(rows, li)))
                np.testing.assert_array_equal(
                    res[1][:, j].numpy(),
                    np.asarray(jspectral._gather_band(rows, li + 1)))
            else:
                np.testing.assert_array_equal(
                    res[:, j].numpy(),
                    np.asarray(jinterp._interp_gather(rows, p)))


def _window_sets(seed):
    """The planner's trio: prelim positions and the two vote positions a
    fixed offset below them (all within one window of the chunk anchor)."""
    base = _positions("monotone", seed)
    return [(base, 4), (base - np.float32(1.25), 2), (base - np.float32(5.0), 2)]


def _pallas_sets(seed):
    base = _positions("monotone", seed)
    return [(base, 3), (base * np.float32(0.9) + np.float32(3.7), 4),
            (base * np.float32(1.1) - np.float32(2), 2)]


def _jax_window(planes, sets, taps):
    return jinterp.interp_planes_window_multi(
        jnp.asarray(planes), [(jnp.asarray(p), n, taps) for p, n in sets],
        64, 128)


def _jax_pallas(planes, sets, taps):
    return jpallas.interp_multi(
        jnp.asarray(planes), [(jnp.asarray(p), n, taps) for p, n in sets],
        128)


@pytest.mark.parametrize("path,seed", [("window", 3), ("window", 7),
                                       ("pallas", 4), ("pallas", 8)])
def test_interp_multi_matches_jax_compiled(monkeypatch, path, seed):
    """Against the XLA windowed selection and the Pallas kernel run in
    interpreter mode (SST_PALLAS_INTERP=1, as tests/test_pallas_interp.py
    does), in lerp and in taps mode."""
    monkeypatch.setenv("SST_INTERP_IMPL", "xla")
    monkeypatch.setenv("SST_PALLAS_INTERP", "1")
    planes = _planes(seed)
    sets = _window_sets(seed) if path == "window" else _pallas_sets(seed)
    run = _jax_window if path == "window" else _jax_pallas
    ref_taps, bad_t = run(planes, sets, True)
    ref, bad = run(planes, sets, False)
    assert int(bad) == 0 and int(bad_t) == 0
    t = torch.as_tensor(planes)
    got_taps, viol_t = interp.interp_multi(
        t, [(torch.as_tensor(p), n, True) for p, n in sets])
    got, viol = interp.interp_multi(
        t, [(torch.as_tensor(p), n, False) for p, n in sets])
    assert viol == 0 and viol_t == 0
    for g, r in zip(_flat(got_taps), _flat(ref_taps)):
        np.testing.assert_array_equal(g, r)
    _check_compiled(got, ref, ref_taps, [(p, n, False) for p, n in sets],
                    planes)


def test_pack_unpack_matches_window_interp(monkeypatch):
    """Complex and real rows laid out as planes the way the JAX windowed
    interpolator packs them, through one multi-set call, and back."""
    monkeypatch.setenv("SST_INTERP_IMPL", "xla")
    rng = np.random.default_rng(5)
    rows = [(rng.standard_normal((ROWS, B))
             + 1j * rng.standard_normal((ROWS, B))).astype(np.complex64)
            for _ in range(2)] + [rng.uniform(0, 2, (ROWS, B))
                                  .astype(np.float32)]
    specs = [(p, n) for (p, _), n in zip(_window_sets(5), (3, 1, 2))]
    ref = jinterp._WindowInterp(64, 128).multi(
        [jnp.asarray(r) for r in rows],
        [(jnp.asarray(p), n) for p, n in specs])
    planes, pos_sets, kinds = interp.pack(
        [torch.as_tensor(r) for r in rows],
        [(torch.as_tensor(p), n) for p, n in specs])
    assert tuple(planes.shape) == (ROWS, 5, B) and kinds == ["c", "c", "f"]
    assert [n for _, n, _ in pos_sets] == [5, 2, 4]
    got = interp.unpack(interp.interp_multi(planes, pos_sets)[0], specs,
                        kinds)
    # the same planes through the JAX windowed path in taps mode, rebuilt
    # with separate roundings (see the module docstring)
    ref_taps, _ = _jax_window(planes.numpy(),
                              [(p, n) for p, n, _ in pos_sets], True)
    scale = np.float32(2.0 ** -22) * np.abs(planes.numpy()).max()
    for gs, rs, (lo, hi), (pos, _) in zip(got, ref, ref_taps, specs):
        assert len(gs) == len(rs)
        frac = (pos - np.floor(pos)).astype(np.float32)[:, None]
        want = np.asarray(lo) + (np.asarray(hi) - np.asarray(lo)) * frac
        i = 0
        for g, r in zip(gs, rs):
            r = np.asarray(r)
            assert g.is_complex() == np.iscomplexobj(r)
            if g.is_complex():
                w = want[:, i] + 1j * want[:, i + 1]
                i += 2
            else:
                w = want[:, i]
                i += 1
            np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=scale)


@pytest.mark.parametrize("tf", [1.0, 0.8, 1.6])
def test_interp_shift_static_matches_jax(tf):
    """The unmapped planner's vote taps at b - tf and b - LV*tf."""
    rng = np.random.default_rng(6)
    nB, Bs, longv = 9, 300, 4
    rows = (rng.standard_normal((nB, Bs))
            + 1j * rng.standard_normal((nB, Bs))).astype(np.complex64)
    shift = np.full(nB, tf, np.float32)
    shift[0] = np.float32(0.75)          # the seek block's own factor
    for s in (shift, (np.float32(longv) * shift).astype(np.float32)):
        got = interp._interp_shift_static(torch.as_tensor(rows)[None], s)[0]
        ref = jinterp._interp_shift_static(jnp.asarray(rows), s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_interp_multi_on_cpu_is_plain():
    """A CPU tensor takes the plain version and launches nothing."""
    planes = torch.as_tensor(_planes())
    sets = _torch_sets(_sets(False))
    got, viol = interp.interp_multi(planes, sets)
    ref, _ = interp.interp_multi_plain(planes, sets)
    assert viol == 0 and interp.launches == 0
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
