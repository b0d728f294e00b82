"""The port's diagonal sweep (wavefront.py) against the JAX package's, on the
CPU.

The same SweepInputs (the port's planner on the 8 kHz stereo fixture) go
through JAX `_sweep_unskew_fn` (a lax.scan over skewed diagonals, complex
cells on the CPU) and the port's plain sweep, the loop over diagonals that
the card's kernel (csrc/sweep.cu) is held to in tests/test_torch_cuda.py.

Tolerances.  The cell's makeOutput is bit-equal to JAX's run op by op.  The
compiled JAX scan rounds the complex vote products in its own order, and
the phase recursion is chaotic under stretching and pitch maps: at 1.0x it
stays within 1e-5 of the largest output (measured 4e-7); elsewhere the gate
is chaos-relative (docs/PARITY.md), the port within 6 dB of the JAX sweep's
own response to a 1-ulp change of the four vote coefficients, the operands
whose products the two round differently (measured: the port 0.7 dB
closer at 1.25x, 2.6 dB further at +12 semitones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import rel_err_db  # noqa: E402
from signalsmith_stretch_torch import engine, planner, wavefront  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_tpu import wavefront as jwavefront  # noqa: E402

CASES = {"1.0": (1.0, 0), "1.25": (1.25, 0), "pitch+12": (1.0, 12),
         "pitch+12_1.25": (1.25, 12)}


def _inputs(sig, rate, case):
    ratio, semis = CASES[case]
    n = sig.shape[1]
    model = StretchModel.build(2, rate, n, int(round(n * ratio)),
                               semitones=semis, tonality_hz=2000,
                               device="cpu")
    spectra, prev = engine.analyze_stage(torch.as_tensor(sig)[None],
                                         model.plan)
    inp = planner.plan_spectral(spectra, prev, model.plan.arrays,
                                model.controls, model.flags, model.plan.consts)
    return inp, model


def _jax_sweep(inp, model):
    """The JAX sweep of clip 0 of the port's inputs -> [ch, nB, B]."""
    consts = model.plan.consts
    fn = jwavefront._sweep_unskew_fn(consts.long_vertical_step, len(inp.pe),
                                     not model.flags.mapped, consts.bands, 8)
    j = jwavefront.SweepInputs(
        *[jnp.asarray(getattr(inp, k)[0].numpy())
          for k in ("a1", "a2", "d1", "d2", "mc")],
        pe=tuple(jnp.asarray(p[0].numpy()) for p in inp.pe),
        pi=tuple(jnp.asarray(p[0].numpy()) for p in inp.pi))
    return np.asarray(jax.jit(fn)(j))


def _ri(z):
    z = np.asarray(z)
    return np.stack([z.real, z.imag])


def test_skew_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 31, 2)).astype(np.float32)   # [nB, B, P]
    t = torch.as_tensor(x).permute(2, 0, 1)                   # [P, nB, B]
    for step in (1, 3, 5, 7):
        s = wavefront._skew(t, step)
        np.testing.assert_array_equal(
            s.permute(1, 2, 0).numpy(), np.asarray(jwavefront.skew(
                jnp.asarray(x), step)))
        assert torch.equal(wavefront._unskew(s, step, 31), t)


def test_make_output_matches_jax():
    """makeOutput on planes, strong and weak (|phase|^2 <= noise floor)
    phases and zero energies: bit-equal to JAX's plane form and to its
    complex form, both run op by op."""
    rng = np.random.default_rng(1)
    n = 4096
    pe = rng.uniform(0, 3, n).astype(np.float32)
    pe[:50] = 0
    pi = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    ph = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    ph[100:400] *= np.float32(1e-9)          # weak: falls back to the input
    ph[400:450] = 0
    got = wavefront._make_output_pair(*[torch.as_tensor(v) for v in (
        pe, pi.real, pi.imag, ph.real, ph.imag)])
    ref = jwavefront._make_output_pair(*[jnp.asarray(v) for v in (
        pe, pi.real, pi.imag, ph.real, ph.imag)])
    refc = jwavefront._make_output(jnp.asarray(pe), jnp.asarray(pi),
                                   jnp.asarray(ph))
    for g, r, rc in zip(got, ref, (np.real(refc), np.imag(refc))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(rc))


def test_sweep_identity_matches_jax(stereo_signal):
    sig, rate = stereo_signal
    inp, model = _inputs(sig, rate, "1.0")
    got = wavefront.sweep_plain(inp, model.plan.consts.long_vertical_step)[0]
    ref = _jax_sweep(inp, model)
    assert got.shape == ref.shape
    err = np.abs(_ri(got) - _ri(ref)).max()
    assert err <= 1e-5 * np.abs(_ri(ref)).max(), err


@pytest.mark.parametrize("case", ["1.25", "pitch+12", "pitch+12_1.25"])
def test_sweep_chaos_relative_to_jax(stereo_signal, case):
    sig, rate = stereo_signal
    inp, model = _inputs(sig, rate, case)
    got = wavefront.sweep_plain(inp, model.plan.consts.long_vertical_step)[0]
    ref = _jax_sweep(inp, model)

    def nudge(z):
        up = [torch.nextafter(x, torch.full_like(x, np.inf))
              for x in (z.real, z.imag)]
        return torch.complex(*up)

    nudged = inp._replace(a1=nudge(inp.a1), a2=nudge(inp.a2),
                          d1=nudge(inp.d1), d2=nudge(inp.d2))
    sens = rel_err_db(_ri(_jax_sweep(nudged, model)), _ri(ref))
    dev = rel_err_db(_ri(got), _ri(ref))
    assert dev < sens + 6.0, (dev, sens)


def test_sweep_on_cpu_is_plain_and_per_clip(stereo_signal):
    """The wrapper takes the plain version on CPU tensors and launches
    nothing; a batch of two clips sweeps as each clip alone, bit for bit."""
    sig, rate = stereo_signal
    one, model = _inputs(sig, rate, "pitch+12")
    two, _ = _inputs(sig[:, ::-1].copy(), rate, "pitch+12")
    both = planner.SweepInputs(*[torch.cat([a, b]) if torch.is_tensor(a)
                                 else tuple(torch.cat([x, y])
                                            for x, y in zip(a, b))
                                 for a, b in zip(one, two)])
    longv = model.plan.consts.long_vertical_step
    out = wavefront.sweep(both, longv)
    assert wavefront.launches == 0
    assert torch.equal(out[:1], wavefront.sweep_plain(one, longv))
    assert torch.equal(out[1:], wavefront.sweep_plain(two, longv))


def _random_inputs(rng, batch, nB, B, ch):
    def cplx(scale=1.0):
        z = (rng.standard_normal((batch, nB, B))
             + 1j * rng.standard_normal((batch, nB, B))) * scale
        return torch.as_tensor(z.astype(np.complex64))

    return planner.SweepInputs(
        a1=cplx(0.5), a2=cplx(0.5), d1=cplx(0.5), d2=cplx(0.5),
        mc=torch.as_tensor(rng.integers(0, ch, (batch, nB, B))),
        pe=tuple(torch.as_tensor(rng.uniform(0, 2, (batch, nB, B)).astype(
            np.float32)) for _ in range(ch)),
        pi=tuple(cplx() for _ in range(ch)))


def kernel_schedule_model(inp, longv, max_threads, ring):
    """The card's sweep kernel (csrc/sweep.cu) as it walks: thread j's cell
    on each diagonal from its (row, bin) walker, the ring of sigma diagonal
    slots indexed [slot][ch][row] (or, with ring False, reads of the output
    array), the same float32 operations vectorised over the live threads."""
    batch, nB, B = inp.a1.shape
    ch = len(inp.pi)
    T, sigma, D = wavefront.sweep_schedule(nB, B, longv, max_threads)
    assert sigma >= longv + 1 and (nB <= T or T * sigma >= B)
    pe, pi = torch.stack(inp.pe, 1), torch.stack(inp.pi, 1)
    out_r = torch.zeros((batch, ch, nB, B))
    out_i = torch.zeros_like(out_r)
    ring_r = torch.zeros((sigma, batch, ch, nB))
    ring_i = torch.zeros_like(ring_r)
    k = torch.arange(T)
    rel = -k * sigma
    bi = torch.arange(batch)[:, None]
    chans = torch.arange(ch)[None, :, None]
    for t in range(D):
        live = (rel >= 0) & (rel < B) & (k < nB)
        kk, bb = k[live], rel[live]
        if kk.numel():
            m = inp.mc[:, kk, bb].long()                  # [batch, n]

            def at(row, slot, col, ok):
                rowc, colc = row.clamp(0, nB - 1), col.clamp(0, B - 1)
                if ring:
                    r, i = ring_r[slot][bi, m, rowc], ring_i[slot][bi, m, rowc]
                else:
                    r, i = out_r[bi, m, rowc, colc], out_i[bi, m, rowc, colc]
                return torch.where(ok, r, 0.0), torch.where(ok, i, 0.0)

            down1 = at(kk, (t - 1) % sigma, bb - 1, bb >= 1)
            downl = at(kk, (t - longv) % sigma, bb - longv, bb >= longv)
            up1 = at(kk - 1, (t + 1) % sigma, bb + 1, (kk >= 1) & (bb + 1 < B))
            upl = at(kk - 1, (t + longv) % sigma, bb + longv,
                     (kk >= 1) & (bb + longv < B))

            def coef(z):
                z = z[:, kk, bb]
                return z.real, z.imag

            v1 = wavefront._cmul(*coef(inp.d1), *down1)
            v2 = wavefront._cmul(*coef(inp.d2), *downl)
            v3 = wavefront._cmul(*coef(inp.a1), *up1)
            v4 = wavefront._cmul(*coef(inp.a2), *upl)
            phr = ((v1[0] + v2[0]) + v3[0]) + v4[0]
            phi = ((v1[1] + v2[1]) + v3[1]) + v4[1]
            pic, pec = pi[:, :, kk, bb], pe[:, :, kk, bb]   # [batch, ch, n]
            pim = pic.gather(1, m[:, None])[:, 0]
            pem = pec.gather(1, m[:, None])[:, 0]
            lr, li = wavefront._make_output_pair(pem, pim.real, pim.imag,
                                                 phr, phi)
            ctr = pic.real * pim.real[:, None] + pic.imag * pim.imag[:, None]
            cti = pic.imag * pim.real[:, None] - pic.real * pim.imag[:, None]
            tr, ti = wavefront._cmul(lr[:, None], li[:, None], ctr, cti)
            kr, ki = wavefront._make_output_pair(pec, pic.real, pic.imag,
                                                 tr, ti)
            lead = chans == m[:, None]
            o_r = torch.where(lead, lr[:, None], kr)
            o_i = torch.where(lead, li[:, None], ki)
            out_r[:, :, kk, bb], out_i[:, :, kk, bb] = o_r, o_i
            ring_r[t % sigma][:, :, kk], ring_i[t % sigma][:, :, kk] = o_r, o_i
        rel = rel + 1
        wrap = (rel == T * sigma) & (nB > T)
        rel = torch.where(wrap, 0, rel)
        k = torch.where(wrap, k + T, k)
    return torch.complex(out_r, out_i)


@pytest.mark.parametrize("nB,B,longv,ch,max_threads,ring", [
    (20, 40, 6, 2, 512, True),      # one row per thread, sigma = LV+1
    (20, 300, 6, 2, 512, True),     # the same, rows longer than T*sigma
    (70, 30, 4, 2, 32, True),       # rows loop over threads, sigma = LV+1
    (50, 200, 5, 2, 32, True),      # sigma raised to ceil(B/threads) = 7
    (50, 200, 5, 2, 32, False),     # the same, reads from the outputs
    (40, 24, 6, 3, 32, True),       # three channels, loaded at the cell
], ids=["one_row", "one_row_long", "rows_loop", "sigma_raised", "read_back", "three_ch"])
def test_kernel_schedule_model_matches_plain(nB, B, longv, ch, max_threads,
                                             ring):
    """The kernel's walk, ring slots and read-back, modelled on the CPU, are
    bit-equal to the plain sweep: every cell reads the outputs it depends on
    after they were written and before their slot is reused."""
    inp = _random_inputs(np.random.default_rng(9), 2, nB, B, ch)
    got = kernel_schedule_model(inp, longv, max_threads, ring)
    assert torch.equal(got, wavefront.sweep_plain(inp, longv))


def test_sweep_schedule():
    """The render's shapes: 335 rows of 4096 bins at LV 6 take 352 threads
    and 6434 diagonals; a clip past 512 rows loops rows over 512 threads,
    with sigma raised to 8 at 4096 bins."""
    assert wavefront.sweep_schedule(335, 4096, 6) == (352, 7, 6434)
    assert wavefront.sweep_schedule(2200, 24, 6) == (512, 7, 24 + 2199 * 7)
    assert wavefront.sweep_schedule(600, 4096, 6) == (512, 8, 4096 + 599 * 8)
    assert wavefront.sweep_schedule(600, 4096, 6)[0] == wavefront.SWEEP_MAX_THREADS


@pytest.mark.parametrize("ch", [17, 24, 25])
def test_sweep_wrapper_takes_any_channel_count(monkeypatch, ch):
    """The card's wrapper passes 17 or more channels (22.2's 24, 4th-order
    ambisonics' 25) to the kernel instead of refusing them: the inputs lie
    on the meta device (shapes without data), and the kernel's entry point
    is replaced by one that records its arguments."""
    calls = []
    monkeypatch.setattr(wavefront._build, "entry",
                        lambda name: lambda *a: calls.append((name, a)) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda t: t)  # no card
    batch, nB, B, longv = 2, 40, 64, 6

    def plane(dtype):
        return torch.empty((batch, nB, B), dtype=dtype, device="meta")

    inputs = planner.SweepInputs(
        a1=plane(torch.complex64), a2=plane(torch.complex64),
        d1=plane(torch.complex64), d2=plane(torch.complex64),
        mc=plane(torch.int32),
        pe=tuple(plane(torch.float32) for _ in range(ch)),
        pi=tuple(plane(torch.complex64) for _ in range(ch)))
    out = wavefront.sweep(inputs, longv)
    assert out.shape == (batch, ch, nB, B) and out.dtype == torch.complex64
    [(name, args)] = calls
    threads, sigma, _ = wavefront.sweep_schedule(nB, B, longv)
    assert name == "sweep"
    assert args[4:11] == (batch, nB, B, ch, longv, threads, sigma)
