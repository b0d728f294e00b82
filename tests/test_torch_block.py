"""The streaming engine's block step against the JAX package's, on the CPU.

- `ops.block_sweep.block_sweep_plain` (the plain version of kernel H)
  against JAX `spectral._sweep_scan`, compiled: bit equality at 1, 2 and
  3 channels, on random inputs with zero energies and weak phases (XLA
  contracts each complex product and squared magnitude of the compiled
  scan into fused multiply-adds, and the plain version rounds at the same
  places).
- `spectral.process_block` against JAX `spectral.process_block`, compiled
  as `_process_impl` reaches it, on the same carry and block inputs (a
  carry that JAX's own blocks built from the stereo fixture): the output
  spectrum and every carry field, the key word for word.  The two round
  apart in the stages before the sweep: JAX's smoothing and envelope are
  associative scans where the port's are the reference's serial passes,
  and XLA contracts products into the following sums (the lerp, the
  twists, the estimate's smoothing, the output map) where eager torch
  rounds twice.  So the gate is relative: each tensor within REL of the
  largest magnitude of JAX's (measured: 5e-8 to 1.2e-7 unmapped, 2e-6 to
  7.3e-6 mapped, on the output; the input and prevInput fields and the
  estimate's two values bit-equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import prng, spectral  # noqa: E402
from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.ops import block_sweep  # noqa: E402
from signalsmith_stretch_tpu import spectral as jspectral  # noqa: E402
from signalsmith_stretch_tpu import stft as jstft  # noqa: E402
from signalsmith_stretch_tpu.config import StretchConfig as JConfig  # noqa

f32 = np.float32
LV = 6
REL = 1e-5


def _random_sweep_inputs(ch, B, seed=0):
    rng = np.random.default_rng(seed)

    def c(*s):
        return (rng.standard_normal(s)
                + 1j * rng.standard_normal(s)).astype(np.complex64)

    st, lt, pu, pim = c(B), c(B), c(B), c(B)
    pem = rng.uniform(0, 1, B).astype(f32)
    mc = rng.integers(0, ch, B).astype(np.int32)
    ct, pi = c(ch, B), c(ch, B)
    pe = rng.uniform(0, 1, (ch, B)).astype(f32)
    pe[:, :20] = 0                        # silent bins: zero outputs
    pem[:20] = 0
    for z in (pu, st, lt):                # weak lead phases
        z[100:200] *= f32(1e-9)
    ct[:, 300:400] *= f32(1e-9)           # weak locked phases
    return st, lt, pu, pem, pim, mc, ct, pe, pi


@pytest.mark.parametrize("ch", [1, 2, 3])
def test_block_sweep_plain_matches_jax(ch):
    args = _random_sweep_inputs(ch, 1024, seed=ch)
    fn = jax.jit(lambda *a: jspectral._sweep_scan(*a, ch=ch, longv=LV))
    want = np.asarray(fn(*args))
    x = block_sweep.BlockSweepInputs(*[torch.as_tensor(a) for a in args])
    got = block_sweep.block_sweep(x, LV).numpy()     # CPU: the plain version
    assert got.shape == want.shape == (ch, 1024)
    for part in (np.real, np.imag):
        np.testing.assert_array_equal(part(got).view(np.int32),
                                      part(want).view(np.int32))


def test_fma_helpers_round_once():
    """The plain sweep's two fused multiply-adds, on arrays and on
    scalars, against exact rational arithmetic, with exponents near and
    far apart and exact halfway cases."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a = rng.standard_normal(400).astype(f32)
    b = rng.standard_normal(400).astype(f32)
    c = (rng.standard_normal(400) * 10.0 ** rng.integers(-12, 12, 400)
         ).astype(f32)
    # a*b + c exactly halfway between two float32 values: 1 + 2^-24 + tiny
    a[:4], b[:4] = f32(1), f32(1 + 2 ** -23)
    c[:4] = [f32(2 ** -24), f32(-2 ** -24), f32(2 ** -49), f32(-2 ** -49)]
    vec = block_sweep._fma(a, b, c)
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        near = f32(float(exact))
        cands = [np.nextafter(near, f32(-np.inf)), near,
                 np.nextafter(near, f32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.asarray(v).view(np.int32))
                                         & 1))
        assert vec[i] == best and block_sweep._fma1(a[i], b[i], c[i]) == best


# ---------------------------------------------------------------------------
# process_block against JAX's
# ---------------------------------------------------------------------------
RATE = 8000
CASES = {
    # name: (controls kw, flags kw, time factor, new_spectrum, reanalyse)
    "unmapped": ({}, {}, 1.0, True, True),
    "unmapped_1.25": ({}, {}, 0.8, True, False),
    "mapped": (dict(freq_multiplier=2 ** (5 / 12), freq_tonality_limit=0.12),
               dict(mapped=True), 1.0, True, True),
    "formant_fixed": (dict(freq_multiplier=2 ** (5 / 12),
                           freq_tonality_limit=0.12,
                           formant_multiplier=2 ** (3 / 12),
                           formant_base_freq=220 / RATE),
                      dict(mapped=True, process_formants=True,
                           formant_compensation=True, formant_auto=False),
                      1.0, True, True),
    "formant_auto": (dict(formant_multiplier=2 ** (3 / 12)),
                     dict(process_formants=True), 1.0, True, True),
    "random": ({}, {}, 2.5, True, True),
    "random_mapped": (dict(freq_multiplier=2 ** (2 / 12),
                           freq_tonality_limit=0.12),
                      dict(mapped=True), 2.5, True, True),
    "not_new": (dict(freq_multiplier=2 ** (5 / 12), freq_tonality_limit=0.12),
                dict(mapped=True), 1.0, False, False),
    "custom_map": ({}, dict(mapped=True, custom="poly"), 1.0, True, True),
}


def _poly_torch(f):
    """0.8 f^2 + 0.8 f with the inner multiply-add rounded once, as XLA
    compiles its jnp twin on the CPU."""
    c = torch.full_like(f, float(f32(0.8)))
    return f * prng.fma_f32(c, f, c)


def _poly_jax(f):
    return f * (f32(0.8) * f + f32(0.8))


def _setup(name):
    ckw, fkw, tf, new, re = CASES[name]
    fkw = dict(fkw)
    custom = fkw.pop("custom", None)
    cfg = StretchConfig.preset_default(2, RATE)
    jcfg = JConfig.preset_default(2, RATE)
    jc = jspectral.Controls.make(**ckw)
    flags = dict(mapped=False, process_formants=False,
                 formant_compensation=False) | fkw
    jf = jspectral.SpectralFlags(**flags, custom_map=custom and _poly_jax)
    pc = spectral.Controls(*[f32(np.asarray(v)) for v in jc])
    pf = spectral.SpectralFlags(**flags, custom_map=custom and _poly_torch)
    return cfg, jcfg, jc, jf, pc, pf, f32(tf), new, re


def _jax_blocks(sig, jcfg, jc, jf, tf, new, re, n=6, seed=3):
    """JAX's carry after n-1 blocks of the clip (hop one interval), and the
    n-th block's inputs."""
    basis = jstft.StftBasis.for_config(jcfg)
    consts = jspectral.SpectralConsts.for_config(jcfg)
    block, H = jcfg.block_samples, jcfg.interval_samples
    step = jax.jit(lambda carry, xs: jspectral.process_block(
        carry=carry, xs=xs, controls=jc, flags=jf, consts=consts))
    carry = jspectral.SpectralCarry.initial(consts, seed)
    for k in range(n):
        end = block + H + k * H
        spec = jstft.analyze(jnp.asarray(sig[:, end - block:end]), basis)
        prev = jstft.analyze(jnp.asarray(sig[:, end - H - block:end - H]),
                             basis)
        last = k == n - 1
        xs = jspectral.BlockInputs(
            spectrum=spec, prev_spectrum=prev,
            new_spectrum=jnp.asarray(new if last else True),
            reanalyse=jnp.asarray(re if last else True),
            time_factor=jnp.float32(tf if last else 1.0))
        if last:
            before = carry
        carry, out = step(carry, xs)
    return before, xs, carry, out, consts


def _to_port(jcarry, dev="cpu"):
    t = [torch.as_tensor(np.array(v)) for v in jcarry[:4]]
    s = [torch.as_tensor(np.asarray(v, f32).reshape(1)) for v in jcarry[4:6]]
    rng = tuple(int(w) for w in np.asarray(jcarry.rng))
    return spectral.SpectralCarry(*t, *s, rng)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.astype(np.complex128) - want).max()) / scale


@pytest.mark.parametrize("name", list(CASES))
def test_process_block_matches_jax(stereo_signal, name):
    sig, _ = stereo_signal
    cfg, jcfg, jc, jf, pc, pf, tf, new, re = _setup(name)
    before, xs, jcarry, jout, _ = _jax_blocks(sig, jcfg, jc, jf, tf, new, re)
    pxs = spectral.BlockInputs(torch.as_tensor(np.array(xs.spectrum)),
                               torch.as_tensor(np.array(xs.prev_spectrum)),
                               new, re, tf)
    consts = spectral.SpectralConsts.for_config(cfg)
    carry, out = spectral.process_block(_to_port(before), pxs, pc, pf,
                                        consts)
    errs = {"output": _rel(out.numpy(), jout)}
    for f in ("input", "prev_input", "output", "pred_energy"):
        errs[f] = _rel(getattr(carry, f).numpy(), getattr(jcarry, f))
    for f in ("freq_est_weighted", "freq_est_weight"):
        errs[f] = _rel(getattr(carry, f).numpy()[0], getattr(jcarry, f))
    assert carry.rng == tuple(int(w) for w in np.asarray(jcarry.rng))
    assert max(errs.values()) <= REL, errs


if __name__ == "__main__":       # the measured differences, case by case
    import conftest
    sig = conftest.stereo_signal.__wrapped__()[0]
    for name in CASES:
        cfg, jcfg, jc, jf, pc, pf, tf, new, re = _setup(name)
        before, xs, jcarry, jout, _ = _jax_blocks(sig, jcfg, jc, jf, tf, new,
                                                  re)
        pxs = spectral.BlockInputs(
            torch.as_tensor(np.array(xs.spectrum)),
            torch.as_tensor(np.array(xs.prev_spectrum)), new, re, tf)
        carry, out = spectral.process_block(
            _to_port(before), pxs, pc, pf,
            spectral.SpectralConsts.for_config(cfg))
        print(name, {f: f"{_rel(getattr(carry, f).numpy(), getattr(jcarry, f)):.2e}"
                     for f in ("input", "prev_input", "output",
                               "pred_energy")},
              f"{_rel(carry.freq_est_weighted.numpy()[0], jcarry.freq_est_weighted):.2e}",
              carry.rng == tuple(int(w) for w in np.asarray(jcarry.rng)))
