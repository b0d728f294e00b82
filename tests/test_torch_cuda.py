"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit and skips without
one.  These tests import neither JAX nor the JAX package, so on a machine
without JAX run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances.  Kernels A, B, C, E, F, G, H, I and J: bit equality.  They are
built with --fmad=false and IEEE division and square root, so they round
at the same points as the plain versions, which are written as separate
float32 PyTorch ops (H's in numpy on a CPU copy, with the fused
multiply-adds of XLA's compiled scan, which H takes with __fmaf_rn; I's
draw is prng.uniform's one rounding, prng.fma_f32, taken with
__fmaf_rn).  G (the peaks map) is also held to its plain version on a CPU
copy of its inputs, whose runs are summed bin-ascending as in the
reference and in the JAX package on the CPU.  Kernel D, the analysis DFT,
is one half-length complex FFT per frame (a mixed-radix Stockham FFT in
shared memory) held to its plain version (cuFFT) at 3e-6 of the
spectrum's peak magnitude, the JAX package's gate between its matmul DFT
and its FFT (tests/test_stft.py:79).  Kernel K, the synthesis's inverse
modified DFT (D's factorisation run backwards), is held to its plain
version (cuFFT on a padded copy) at the same 3e-6 of the blocks' peak;
kernel L, the assembly, bit for bit on K's own blocks.
Renders (`chip_smoke.render_vs_plain`, the gate of chip_smoke.py): the
spectral stage through A, B, C, E, F and G on the spectra of one analysis
through D is bit-equal to its plain version; the whole render goes through
D, so it is bit-equal to the plain render or, failing that, within 12 dB
of the plain render's own response to a 1-ulp change of its input, with
band energies within 3 dB.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from signalsmith_stretch_torch import ops, stft, wavefront  # noqa: E402
from signalsmith_stretch_torch.config import StretchConfig  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_torch.ops import (dft, idft, interp,  # noqa: E402
                                           ola, scan_ops)
from signalsmith_stretch_torch.planner import SweepInputs  # noqa: E402
from signalsmith_stretch_torch.tables import on_device  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _t(x, dev):
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


@pytest.mark.parametrize("taps", [False, True])
def test_interp_kernel_matches_plain(dev, taps):
    rng = np.random.default_rng(0)
    rows, n, W0, B = 6, 5, 300, 256
    planes = _t(rng.standard_normal((rows, n, W0)).astype(np.float32), dev)
    base = np.cumsum(rng.uniform(0.2, 2.0, (rows, B)), 1).astype(np.float32)
    base -= 20                                   # some positions below 0
    far = base * 1.5 + 50                        # some at and past W0
    far[0, :3] = np.nan                          # NaN positions read zeros
    sets = [(_t(base, dev), 5, taps), (_t(far, dev), 2, taps),
            (_t(base - 3.25, dev), 3, taps)]
    got, viol = interp.interp_multi(planes, sets)
    ref, _ = interp.interp_multi_plain(planes, sets)
    assert viol == 0
    for g, r in zip(got, ref):
        for gg, rr in zip(g if taps else (g,), r if taps else (r,)):
            # bit equality; a NaN position's lerp is NaN in both
            torch.testing.assert_close(gg, rr, rtol=0, atol=0, equal_nan=True)


# chain cases: rows (one, one CTA short of a tile, one past it, many),
# bins (the block chains' 335, not 16-byte aligned; 1000; the render's
# 4096) and passes (one; the smoothing's four; the envelope's eight)
CHAIN_GRID = [(R, B, P) for R in (1, 31, 33, 300) for B in (335, 1000, 4096)
              for P in (1, 4, 8)]
CHAIN_IDS = [f"R{R}-B{B}-P{P}" for R, B, P in CHAIN_GRID]


@pytest.mark.parametrize("R,B,directions", [
    (37, 513, (False,)), (37, 513, (True,))] + [
    (R, B, tuple(p % 2 == 0 for p in range(P))) for R, B, P in CHAIN_GRID],
    ids=["False", "True"] + CHAIN_IDS)
def test_iir_kernel_matches_plain(dev, R, B, directions):
    """One pass (the two first cases: forward and backward), or a chain of
    passes alternating from backward, in one launch: bit-equal to the plain
    passes, y and the final value."""
    rng = np.random.default_rng(1)
    x = _t(rng.uniform(0, 3, (R, B)).astype(np.float32), dev)
    init = _t(rng.uniform(0, 1, R).astype(np.float32), dev)
    y, fin = scan_ops.iir_chain(x, init, 0.13, directions)
    yp, finp = scan_ops.iir_chain_plain(x, init, 0.13, directions)
    assert torch.equal(y, yp) and torch.equal(fin, finp)
    if len(directions) == 1:     # the one-pass wrapper is the same launch
        y1, fin1 = scan_ops.iir(x, init, 0.13, backward=directions[0])
        assert torch.equal(y1, y) and torch.equal(fin1, fin)


def _sweep_inputs(rng, batch, nB, B, ch, dev, views=False):
    """Random sweep inputs; with views, the energies and inputs are channel
    views of [batch, nB, ch, B] tensors, as the unmapped planner leaves
    them (row stride ch*B)."""
    def cplx(scale=1.0, shape=(batch, nB, B)):
        z = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)) * scale
        return _t(z.astype(np.complex64), dev)

    if views:
        pe = _t(rng.uniform(0, 2, (batch, nB, ch, B)).astype(np.float32), dev)
        pi = cplx(shape=(batch, nB, ch, B))
        pe, pi = pe.unbind(2), pi.unbind(2)
    else:
        pe = tuple(_t(rng.uniform(0, 2, (batch, nB, B)).astype(np.float32),
                      dev) for _ in range(ch))
        pi = tuple(cplx() for _ in range(ch))
    return SweepInputs(
        a1=cplx(0.5), a2=cplx(0.5), d1=cplx(0.5), d2=cplx(0.5),
        mc=_t(rng.integers(0, ch, (batch, nB, B)).astype(np.int32), dev),
        pe=tuple(pe), pi=tuple(pi))


@pytest.mark.parametrize("nB,B,longv,ch,views", [
    (70, 96, 6, 2, False), (2200, 24, 6, 2, False), (70, 96, 4, 2, False),
    (70, 96, 5, 2, False), (1100, 24, 6, 2, False), (600, 3700, 6, 2, False),
    (70, 96, 6, 1, False), (70, 96, 6, 3, False), (20, 400, 6, 2, False),
    (70, 96, 6, 2, True), (40, 64, 6, 24, False), (300, 48, 6, 25, False)],
    ids=["shared_ring", "global_fallback", "lv4", "lv5", "rows_loop",
         "sigma_raised", "mono", "three_ch", "rows_past_period",
         "channel_views", "ch24", "ch25_fallback"])
def test_sweep_kernel_matches_plain(dev, nB, B, longv, ch, views):
    """global_fallback's ring (2200 rows x 2 channels x 7 diagonals) does
    not fit in shared memory, so the kernel reads its outputs back from the
    output array instead.  LV 4 and 5 are the cheaper preset's (48 and
    44.1 kHz).  Past 512 rows, rows loop over the CTA's threads
    (global_fallback, rows_loop); at 3700 bins the schedule step rises to 8
    (wavefront.sweep_schedule).  Three channels take the kernel's path that
    loads channel inputs at the cell.  rows_past_period: one row per thread
    (32 threads) and rows longer than threads*sigma, as at the render's
    335 x 4096 shapes.  channel_views: energies and inputs read through
    their clip and row strides.  ch24 and ch25_fallback: 22.2 and 4th-order
    ambisonics channel counts (the plane table travels in device memory),
    the second with a ring too large for shared memory."""
    rng = np.random.default_rng(2)
    inputs = _sweep_inputs(rng, 2, nB, B, ch, dev, views)
    got = wavefront.sweep(inputs, longv)
    ref = wavefront.sweep_plain(inputs, longv)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("ratio,kw", [
    (1.25, dict(semitones=0)), (1.25, dict(semitones=12)),
    (1.25, dict(semitones=5, formant_semitones=3, formant_compensation=True)),
    (1.25, dict(formant_semitones=4)), (3.0, dict(semitones=0))],
    ids=["0", "12", "formant_pitch", "formant", "3x"])
def test_render_kernels_match_plain(dev, ratio, kw):
    """Through the kernels and through the plain versions, a render's
    gates (chip_smoke.render_vs_plain); then a later render_exact of the
    model on device input copies no table to the card: its only copies
    to the card are the sweep's and J's per-call pointer tables, from
    pinned memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from signalsmith_stretch_torch import engine
    rng = np.random.default_rng(3)
    rate, n = 8000, 12000
    t = np.arange(n) / rate
    clip = np.stack([0.4 * np.sin(2 * np.pi * 165 * t + c)
                     + 0.02 * rng.standard_normal(n) for c in range(2)])
    model = StretchModel.build(channels=2, sample_rate=rate, in_samples=n,
                               out_samples=int(n * ratio), tonality_hz=2000,
                               device=dev, **kw)
    audio = _t(clip[None].astype(np.float32), dev)
    ok, gate = chip_smoke.render_vs_plain(model, audio)
    assert ok, gate
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.render_exact(audio, model.plan, model.controls, model.flags)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    to_card = [name for name in on_card if "HtoD" in name]
    assert len(on_card) > len(to_card)
    assert len(to_card) <= 2 and all("Pinned" in c for c in to_card), to_card


DFT_PRESETS = [("preset_default", 48000), ("preset_cheaper", 44100),
               ("preset_default", 8000), ("preset_default", 11025),
               ("preset_default", 22050), ("preset_default", 96000)]


@pytest.mark.parametrize("preset,rate", DFT_PRESETS)
def test_dft_kernel_matches_plain(dev, preset, rate):
    """Every FFT size the kernel is built for: N 8192 (blocks 5760 and 4410,
    a block that leaves part of the frame empty), 1024 (960), 2048 (1323,
    odd: sample pairs read one by one), 4096 (2646) and 16384 (11520).  The
    frames are also analysed from a view one sample off 8-byte alignment."""
    basis = stft.StftBasis.for_config(getattr(StretchConfig, preset)(2, rate))
    block = basis.block_samples
    rng = np.random.default_rng(5)
    flat = _t(rng.standard_normal(3 * 37 * block + 1).astype(np.float32), dev)
    for frames in (flat[:-1].view(3, 37, block), flat[1:].view(3, 37, block)):
        got = dft.analyze(frames, basis)
        ref = stft.analyze_plain(frames, basis)
        assert got.shape == ref.shape and got.dtype == torch.complex64
        err = (got - ref).abs().max() / ref.abs().max()
        assert float(err) <= 3e-6, float(err)


@pytest.mark.parametrize("preset,rate", DFT_PRESETS)
def test_idft_kernel_matches_plain(dev, preset, rate):
    """K at every FFT size D is built for (D's presets: blocks 5760, 4410,
    960, 1323 (odd: samples stored one by one), 2646 and 11520), on spectra
    from an aligned tensor and from a view one complex off 16-byte
    alignment: within 3e-6 of the blocks' peak of the plain synthesis."""
    basis = stft.StftBasis.for_config(getattr(StretchConfig, preset)(2, rate))
    rng = np.random.default_rng(6)
    n = 3 * 37 * basis.bands + 1
    flat = _t((rng.standard_normal(n) + 1j * rng.standard_normal(n))
              .astype(np.complex64), dev)
    for spectra in (flat[:-1].view(3, 37, basis.bands),
                    flat[1:].view(3, 37, basis.bands)):
        got = idft.synthesize(spectra, basis)
        ref = stft.synthesize(spectra, basis)
        assert got.shape == ref.shape and got.dtype == torch.float32
        err = (got - ref).abs().max() / ref.abs().max()
        assert float(err) <= 3e-6, float(err)


def _clip_kinds(n, seed):
    """Five stereo clips: loud, zeros, sub-noise (below the 1e-15 energy
    floor), loud then zeros, zeros then loud (tests/test_silence_exact.py's
    kinds)."""
    rng = np.random.default_rng(seed)
    loud = 0.3 * rng.standard_normal((2, n))
    half = np.arange(n) < n // 2
    return np.stack([loud, np.zeros((2, n)),
                     1e-12 * rng.standard_normal((2, n)),
                     np.where(half, loud, 0.0),
                     np.where(half, 0.0, loud)]).astype(np.float32)


# (ratio, preset): 1.25x, 1.0x (the +12 st cell's geometry), 3x; 0.2x, where
# the main process bypasses; the cheaper preset's strips carry zero padding
OLA_CASES = [(1.25, "preset_default"), (1.0, "preset_default"),
             (3.0, "preset_default"), (0.2, "preset_cheaper"),
             (1.25, "preset_cheaper")]


@pytest.mark.parametrize("ratio,preset", OLA_CASES,
                         ids=[f"{r}x-{p[7:]}" for r, p in OLA_CASES])
def test_ola_kernel_matches_plain(dev, ratio, preset):
    """L bit-equal to the plain assembly on K's own blocks (48 kHz stereo,
    1 s of each kind of clip), the silence bypass on and off."""
    from signalsmith_stretch_torch import engine
    n = 48000
    cfg = getattr(StretchConfig, preset)(2, 48000)
    plan = engine.build_exact_plan(cfg, n, int(round(n * ratio)))
    rng = np.random.default_rng(7)
    shape = (5, 2, len(plan.arrays["out_pos"]), plan.basis.bands)
    specs = _t((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
               .astype(np.complex64), dev)
    blocks = idft.synthesize(specs, plan.basis)
    audio = _t(_clip_kinds(n, 8), dev)
    for a in (audio, None):
        got = ola.assemble(blocks, plan, a)
        assert got.shape == (5, 2, plan.sched.out_samples)
        assert chip_smoke.same_bits(got, ola.assemble_plain(blocks, plan, a))


def test_synthesis_launches(dev):
    """engine.synthesis_stage on a 3x render's sweep outputs (a batch with
    a zeroed clip): K and L once each and at most 8 device operations in
    all (K, L and the two energy sums); inside ops.plain(), no kernel.  It
    runs before the render cases below: after them, in the same process on
    an H100, its profiler session recorded no device event at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from signalsmith_stretch_torch import engine
    model, audio, specs = chip_smoke.synthesis_inputs(
        ("3x", 3.0, {}), 4)
    torch.cuda.synchronize()
    chip_smoke.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.synthesis_stage(specs, model.plan, audio=audio)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert 2 <= len(on_card) <= 8, on_card
    counts = chip_smoke.counters()
    assert counts["idft"] == counts["ola"] == 1
    assert sum(counts.values()) == 2
    chip_smoke.reset_counters()
    with ops.plain():
        engine.synthesis_stage(specs, model.plan, audio=audio)
    torch.cuda.synchronize()
    assert not any(chip_smoke.counters().values())


SYNTH_CELLS = {"1.25x": (1.25, {}),
               "pitch12": (1.0, dict(semitones=12, tonality_hz=8000)),
               "3x": (3.0, {})}


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("cell", sorted(SYNTH_CELLS))
def test_render_synthesis_kernels_match_plain(dev, cell, batch):
    """A whole render through the kernels (K and L among them) against the
    plain versions at the three benchmark configurations (48 kHz stereo, 3 s
    clips, chip_smoke's gate length for its randomised cells) at batch 1
    and 32; in the batch every fourth clip is zeros and the second
    sub-noise, so the silence bypass takes them.
    - The gate of test_render_kernels_match_plain
      (chip_smoke.render_vs_plain).  It is D's: on 1 s clips D's rounding
      alone moves the chaotic render past it, by as much with the
      synthesis's plain versions as with K and L (an H100 80GB HBM3).
    - The zeroed clips render as the plain versions' bit for bit.
    - The render is its stages through the kernels; with the synthesis's
      plain versions on the same sweep outputs it differs by K's rounding
      against cuFFT alone: an rms gap below -110 dB of the plain render's
      rms, K's 3e-6 of the peak (-110.5 dB); measured -129 to -133 dB."""
    from signalsmith_stretch_torch import engine, planner
    ratio, kw = SYNTH_CELLS[cell]
    n = 3 * 48000
    model = StretchModel.build(channels=2, sample_rate=48000, in_samples=n,
                               out_samples=int(round(n * ratio)), device=dev,
                               **kw)
    clips = chip_smoke.make_corpus(batch, 2, n, 48000, seed=12)
    clips[3::4] = 0
    clips[1:2] *= 1e-12
    audio = _t(clips, dev)
    ok, gate = chip_smoke.render_vs_plain(model, audio)
    assert ok, gate
    got, want = model.batched(audio), model.batched(audio, plain=True)
    for i in range(3, batch, 4):
        assert torch.equal(got[i], want[i])
    plan = model.plan
    spectra, prev = engine.analyze_stage(audio, plan)
    specs = wavefront.sweep(planner.plan_spectral(
        spectra, prev, plan.arrays, model.controls, model.flags, plan.consts),
        plan.consts.long_vertical_step)
    assert torch.equal(engine.synthesis_stage(specs, plan, audio=audio), got)
    with ops.plain():
        synth_plain = engine.synthesis_stage(specs, plan, audio=audio)
    gap = chip_smoke.rel_err_db(got.cpu().numpy(), synth_plain.cpu().numpy())
    assert gap < -110.0, gap


@pytest.mark.parametrize("is_min,backward", [
    (False, False), (False, True), (True, False), (True, True)],
    ids=["False-False", "False-True", "True-False", "True-True"])
def test_decay_kernel_matches_plain(dev, is_min, backward):
    rng = np.random.default_rng(6)
    x = rng.exponential(0.5, (37, 513)).astype(np.float32)
    x[3] = 0                                 # a silent row
    decay = rng.uniform(0.8, 0.99, 37).astype(np.float32)
    decay[3] = 0
    with np.errstate(divide="ignore"):
        coef = (np.float32(1) / decay) if is_min else decay  # inf on row 3
    init = rng.uniform(0, 1, 37).astype(np.float32)
    args = [_t(v, dev) for v in (x, init, coef.astype(np.float32))]
    y, fin = scan_ops.decay(*args, is_min, backward)
    yp, finp = scan_ops.decay_plain(*args, is_min, backward)
    assert torch.equal(y, yp) and torch.equal(fin, finp)
    assert not torch.isnan(y).any()


@pytest.mark.parametrize("R,B,P", CHAIN_GRID, ids=CHAIN_IDS)
def test_decay_chain_kernel_matches_plain(dev, R, B, P):
    """A chain in one launch: one min pass backward with the inverse decay
    (P 1), the four max passes with the decay (P 4), or the envelope's
    eight (P 8).  A silent row (decay 0, inverse inf: NaN products
    discarded) and a NaN in x (kept where it stands, as std::max keeps it):
    bit-equal to the plain passes, NaN for NaN."""
    rng = np.random.default_rng(R + B + P)
    x = rng.exponential(0.5, (R, B)).astype(np.float32)
    decay = rng.uniform(0.8, 0.99, R).astype(np.float32)
    x[R // 2] = 0
    decay[R // 2] = 0
    x[0, B // 3] = np.nan
    d = _t(decay, dev)
    inv = 1 / d
    if P == 1:
        passes = [(inv, True, True)]
    else:
        passes = [(c, m, b) for c, m in ((d, False), (inv, True))[:P // 4]
                  for _ in range(2) for b in (True, False)]
    args = [_t(v, dev) for v in (x, rng.uniform(0, 1, R).astype(np.float32))]
    y, fin = scan_ops.decay_chain(*args, passes)
    yp, finp = scan_ops.decay_chain_plain(*args, passes)
    torch.testing.assert_close(y, yp, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(fin, finp, rtol=0, atol=0, equal_nan=True)
    assert int(torch.isnan(y).sum()) == 1    # only where x is NaN


def test_top3_kernel_matches_plain(dev):
    rng = np.random.default_rng(7)
    m = rng.exponential(0.01, (41, 300)).astype(np.float32)
    for r in range(41):
        m[r, rng.integers(1, 299, 8)] += rng.uniform(0.5, 5, 8)
    m[1] = np.round(m[1] * 4) / 4            # plateaus
    m[2, 10:20] = m[2, 40:50] = 3.0          # equal peaks
    m[3] = 0                                 # silent row
    got = scan_ops.top3_local_maxima(_t(m, dev))
    ref = scan_ops.spectral._top3_local_maxima(_t(m, dev))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_top3_kernel_corner_rows(dev):
    """The corners of the lane merge (chip_smoke.top3_corner_rows): NaN at
    bin 0 and NaN maxima, -0.0/+0.0 ties, infinities, plateaus, equal
    peaks, B = 3 and B not a multiple of four: bit-equal, NaN for NaN."""
    for m in chip_smoke.top3_corner_rows():
        got = scan_ops.top3_local_maxima(_t(m, dev))
        ref = scan_ops.spectral._top3_local_maxima(_t(m, dev))
        assert all(chip_smoke.same_bits(g, r) for g, r in zip(got, ref))
    # a view one float off 16-byte alignment takes the scalar loads
    m = chip_smoke.top3_corner_rows()[3]
    flat = _t(np.concatenate([[0], m.ravel()]).astype(np.float32), dev)
    view = flat[1:].view(m.shape)
    got = scan_ops.top3_local_maxima(view)
    ref = scan_ops.spectral._top3_local_maxima(view)
    assert all(chip_smoke.same_bits(g, r) for g, r in zip(got, ref))


def _mapped_model(dev, channels=2):
    rate, n = 8000, 16000
    return StretchModel.build(channels=channels, sample_rate=rate,
                              in_samples=n, out_samples=n, semitones=12,
                              tonality_hz=2000, device=dev), rate, n


@pytest.mark.parametrize("source", ["render", "edge_rows_512",
                                    "edge_rows_1000", "edge_rows_4096",
                                    "edge_rows_8192"])
def test_peaks_kernel_matches_cpu(dev, source):
    """G on the card against its plain version on a CPU copy of its inputs
    (each run summed bin-ascending, the reference's order and the JAX
    package's on the CPU), bit for bit in all four planes (the position
    sets input_bin, input_bin - tf and input_bin - ltf, and freq_grad); the
    plain version on the card against the same.  Inputs: a mapped render's
    energy, smoothed curve and time factors (8 kHz stereo, +12 semitones),
    or the edge rows and random rows of chip_smoke.peaks_edge_rows at B =
    512, 1000, 4096 and 8192 (the 96 kHz preset's bands, whose shared
    memory passes 48 KB) with random time factors for two clips of 7
    blocks."""
    from signalsmith_stretch_torch import engine, planner
    from signalsmith_stretch_torch.ops import peaks
    model, rate, n = _mapped_model(dev)
    if source == "render":
        rng = np.random.default_rng(8)
        t = np.arange(n) / rate
        clip = np.stack([0.4 * np.sin(2 * np.pi * 165 * t + c)
                         + 0.02 * rng.standard_normal(n) for c in range(2)])
        spectra, prev = engine.analyze_stage(
            _t(clip[None].astype(np.float32), dev), model.plan)
        with ops.plain():
            _, dbg = planner.plan_spectral(spectra, prev, model.plan.arrays,
                                           model.controls, model.flags,
                                           model.plan.consts, debug=True)
        e, s = dbg["energy"], dbg["smoothed"]
        tf, ltf = dbg["shifts"]
    else:
        e, s = (_t(a, dev) for a in chip_smoke.peaks_edge_rows(
            int(source.rsplit("_", 1)[1])))
        shifts = np.random.default_rng(3).uniform(0.5, 2.0, 7)
        tf = _t(shifts.astype(np.float32), dev)
        ltf = _t((np.float32(6) * shifts.astype(np.float32)), dev)
    args = (e, s, tf, ltf, model.controls, model.plan.consts)
    got = peaks.peaks_positions(*args)
    cpu = peaks.peaks_positions_plain(*(a.cpu() for a in args[:4]),
                                      *args[4:])
    card = peaks.peaks_positions_plain(*args)
    assert got[0].shape == (e.shape[0], 3, e.shape[1])
    for g, c, p in zip(got, cpu, card):
        assert chip_smoke.same_bits(g.cpu(), c)
        assert chip_smoke.same_bits(p.cpu(), c)


def test_interp_stacked_positions_match_list(dev):
    """interp_multi on a pre-stacked [rows, sets, B] position tensor (the
    planner's call on G's output) gives the bits of the list form, lerp and
    taps, and refuses a tensor whose slices are not the sets'."""
    rng = np.random.default_rng(5)
    rows, n, W0, B = 6, 5, 300, 256
    planes = _t(rng.standard_normal((rows, n, W0)).astype(np.float32), dev)
    base = np.cumsum(rng.uniform(0.2, 2.0, (rows, B)), 1).astype(np.float32)
    pos = _t(np.stack([base - 20, base * 1.5 + 50, base - 3.25], 1), dev)
    for taps in (False, True):
        sets = [(pos[:, 0], 5, taps), (pos[:, 1], 2, taps),
                (pos[:, 2], 3, taps)]
        got, _ = interp.interp_multi(planes, sets, pos=pos)
        ref, _ = interp.interp_multi(planes, sets)
        for g, r in zip(got, ref):
            for gg, rr in zip(g if taps else (g,), r if taps else (r,)):
                assert chip_smoke.same_bits(gg, rr)
    with pytest.raises(ValueError):
        interp.interp_multi(planes, sets, pos=pos.clone())
    with pytest.raises(ValueError):
        interp.interp_multi(planes, sets[:2], pos=pos)


def test_planner_launches(dev):
    """The mapped planner launches G once (and A, C and J once each);
    inside ops.plain() it launches no kernel."""
    from signalsmith_stretch_torch import engine, planner, wavefront
    from signalsmith_stretch_torch.ops import peaks
    model, _, n = _mapped_model(dev)
    clip = _t(np.random.default_rng(9).standard_normal((1, 2, n))
              .astype(np.float32) * 0.1, dev)
    spectra, prev = engine.analyze_stage(clip, model.plan)
    args = (spectra, prev, model.plan.arrays, model.controls, model.flags,
            model.plan.consts)
    for plain, want in ((True, 0), (False, 1)):
        chip_smoke.reset_counters()
        with ops.plain(plain):
            planner.plan_spectral(*args)
        torch.cuda.synchronize()
        counts = chip_smoke.counters()
        assert counts["peaks_map"] == counts["interp_multi"] == want
        assert counts["iir"] == want and peaks.launches == want
        assert counts["coefficients"] == want
        assert sum(counts.values()) == 4 * want
    assert wavefront.launches == 0


def _random_model(dev, ratio, semitones=0):
    """8 kHz stereo, 2 s, above 2x: the randomised regime (mapped with a
    pitch shift)."""
    rate, n = 8000, 16000
    kw = dict(semitones=semitones, tonality_hz=2000) if semitones else {}
    return StretchModel.build(channels=2, sample_rate=rate, in_samples=n,
                              out_samples=int(ratio * n), device=dev,
                              **kw), n


@pytest.mark.parametrize("ratio,semitones,sets", [(3.0, 0, 4), (2.5, 2, 5)],
                         ids=["3x", "2.5x_pitch+2"])
def test_interp_random_sets_match_plain(dev, ratio, semitones, sets):
    """A on the randomised regime's position sets (four per-bin vote sets
    unmapped; G's input bin and four vote sets mapped), bit-equal to its
    plain version; the planner launches A once (and G once when mapped)."""
    from signalsmith_stretch_torch import engine, planner
    model, n = _random_model(dev, ratio, semitones)
    clip = _t(np.random.default_rng(10).standard_normal((2, 2, n))
              .astype(np.float32) * 0.1, dev)
    spectra, prev = engine.analyze_stage(clip, model.plan)
    chip_smoke.reset_counters()
    _, dbg = planner.plan_spectral(spectra, prev, model.plan.arrays,
                                   model.controls, model.flags,
                                   model.plan.consts, debug=True)
    torch.cuda.synchronize()
    counts = chip_smoke.counters()
    assert counts["interp_multi"] == 1
    assert counts["peaks_map"] == int(bool(semitones))
    planes, pos_sets = dbg["interp"]
    pos = dbg["pos"]
    assert pos.shape == (planes.shape[0], sets, planes.shape[2])
    got, _ = interp.interp_multi(planes, pos_sets, pos=pos)
    ref, _ = interp.interp_multi_plain(planes, pos_sets)
    assert all(chip_smoke.same_bits(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("width", [512, 4096])
def test_peaks_kernel_block_controls(dev, width):
    """G with per-block controls (7 blocks of pitch factors and tonality
    limits, rows block-major per clip) against its plain version on a CPU
    copy of its inputs and on the card, bit for bit in all four planes."""
    from signalsmith_stretch_torch import spectral
    from signalsmith_stretch_torch.ops import peaks
    model, _, _ = _mapped_model(dev)
    rng = np.random.default_rng(width)
    nB = 7
    mult = (2.0 ** (rng.uniform(-7, 12, nB) / 12)).astype(np.float32)
    limit = rng.uniform(0.02, 0.3, nB).astype(np.float32)
    one = np.ones(nB, np.float32)
    ctl = spectral.Controls(mult, limit, one, one, 0 * one)
    e, s = (_t(a, dev) for a in chip_smoke.peaks_edge_rows(width))
    shifts = rng.uniform(0.5, 2.0, nB).astype(np.float32)
    tf, ltf = _t(shifts, dev), _t(np.float32(6) * shifts, dev)
    consts = model.plan.consts
    got = peaks.peaks_positions(e, s, tf, ltf, ctl, consts)
    cpu = peaks.peaks_positions_plain(e.cpu(), s.cpu(), tf.cpu(), ltf.cpu(),
                                      ctl, consts)
    card = peaks.peaks_positions_plain(e, s, tf, ltf, ctl, consts)
    for g, c, p in zip(got, cpu, card):
        assert chip_smoke.same_bits(g.cpu(), c)
        assert chip_smoke.same_bits(p.cpu(), c)


def test_exact_on_card(dev):
    """SignalsmithStretch.exact on the card: 3x and a pitch and formant
    automation render finite output of the asked length, twice alike,
    through the kernels; an all-zero clip renders zeros with no launch."""
    from signalsmith_stretch_torch import SignalsmithStretch
    rate, n = 8000, 16000
    clip = (np.random.default_rng(11).standard_normal((2, n)) * 0.1).astype(
        np.float32)
    s = SignalsmithStretch(device=dev)
    s.preset_default(2, rate)
    s.set_formant_semitones(3, True)
    auto = dict(semitones=lambda t: 3.5 * t, tonality_limit=0.25,
                sample_rate=rate)
    for n_out, kw, want in ((3 * n, {}, dict(interp_multi=1, peaks_map=0)),
                            (n, dict(automation=auto),
                             dict(interp_multi=1, peaks_map=1, decay=1,
                                  top3=1))):
        chip_smoke.reset_counters()
        out, ok = s.exact(clip, n_out, **kw)
        counts = chip_smoke.counters()
        assert ok and out.shape == (2, n_out) and np.isfinite(out).all()
        assert {k: counts[k] for k in want} == want
        assert counts["sweep"] == counts["dft"] == 1
        assert s.exact(clip, n_out, **kw)[0].tobytes() == out.tobytes()
    chip_smoke.reset_counters()
    out, ok = s.exact(np.zeros_like(clip), n)
    assert ok and not out.any() and not any(chip_smoke.counters().values())


def test_cli_on_card(dev, tmp_path):
    """The CLI on the card (its default device), raw I/O: round(n * 1.25)
    samples, bit-equal to exact() on the card."""
    import os
    import subprocess
    import sys
    from signalsmith_stretch_torch import SignalsmithStretch
    from signalsmith_stretch_torch.io import read_raw, write_raw
    rate, n = 8000, 16000
    clip = (np.random.default_rng(12).standard_normal((2, n)) * 0.1).astype(
        np.float32)
    inp, outp = str(tmp_path / "in.raw"), str(tmp_path / "out.raw")
    write_raw(inp, clip, rate)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "signalsmith_stretch_torch.cli",
                        inp, outp, "--raw", "--time=1.25", "--semitones=3"],
                       capture_output=True, text=True, timeout=600, cwd=root,
                       env=dict(os.environ, PYTHONPATH=root))
    assert r.returncode == 0, r.stderr[-800:]
    out, orate = read_raw(outp)
    s = SignalsmithStretch(device=dev)
    s.preset_default(2, rate)
    s.set_transpose_semitones(3, 8000 / rate)
    want, ok = s.exact(clip, round(n * 1.25))
    assert orate == rate and out.shape == (2, round(n * 1.25))
    np.testing.assert_array_equal(out, want)


def _tonality_callable(controls):
    """The built-in map of scalar controls written as a torch callable."""
    from signalsmith_stretch_torch.ops import peaks
    limit, mult, above_off = (float(v) for v in
                              peaks.map_constants(controls)[0])

    def fn(f):
        return torch.where(f > limit, f + above_off, f * mult)
    return fn


@pytest.mark.parametrize("source", ["render", "edge_rows_512",
                                    "edge_rows_1000", "edge_rows_4096",
                                    "tiled_1000", "tiled_998"])
def test_peaks_split_entries_match_plain(dev, source):
    """G's runs entry and out entry (the split around a custom map) each
    bit-equal to its plain version on the card and on a CPU copy of its
    inputs; the out entry reads only the valid slots (NaN in the others
    changes nothing); the two entries around the built-in map written as a
    callable give the one-launch G's four planes.  The tiled sources hold
    the edge rows 70 times over (980 rows, more than the CTAs resident on
    an H100, so each CTA walks several rows), at a width that takes the
    16-byte path (1000) and one that does not (998)."""
    from signalsmith_stretch_torch import engine, planner, spectral
    from signalsmith_stretch_torch.ops import peaks
    model, rate, n = _mapped_model(dev)
    consts = model.plan.consts
    if source == "render":
        t = np.arange(n) / rate
        clip = np.stack([0.4 * np.sin(2 * np.pi * 165 * t + c)
                         + 0.02 * np.random.default_rng(13).standard_normal(n)
                         for c in range(2)])
        spectra, prev = engine.analyze_stage(
            _t(clip[None].astype(np.float32), dev), model.plan)
        with ops.plain():
            _, dbg = planner.plan_spectral(spectra, prev, model.plan.arrays,
                                           model.controls, model.flags,
                                           consts, debug=True)
        e, s = dbg["energy"], dbg["smoothed"]
        tf, ltf = dbg["shifts"]
    else:
        rows = chip_smoke.peaks_edge_rows(int(source.rsplit("_", 1)[1]))
        reps = 70 if source.startswith("tiled") else 1
        e, s = (_t(np.tile(a, (reps, 1)), dev) for a in rows)
        shifts = np.random.default_rng(4).uniform(0.5, 2.0, 7)
        tf = _t(shifts.astype(np.float32), dev)
        ltf = _t(np.float32(6) * shifts.astype(np.float32), dev)
    B = e.shape[1]
    runs = peaks.peak_runs(e, s, consts)
    for want in (peaks.peak_runs_plain(e.cpu(), s.cpu(), consts),
                 peaks.peak_runs_plain(e, s, consts)):
        assert all(chip_smoke.same_bits(g.cpu(), w.cpu())
                   for g, w in zip(runs, want))
    peak_in, avg_freq, n_peaks = runs
    invalid = (torch.arange(peak_in.shape[1], device=dev)[None]
               >= n_peaks[:, None])
    mapped = spectral.map_freq(avg_freq, model.controls)
    nan = torch.where(invalid, torch.full_like(mapped, float("nan")), mapped)
    args = (n_peaks, tf, ltf, B, consts)
    got = peaks.output_positions(peak_in, mapped, *args)
    for m in (mapped, nan):
        for g, w in zip(peaks.output_positions(peak_in, m, *args), got):
            assert chip_smoke.same_bits(g, w)
    cpu = peaks.output_positions_plain(peak_in.cpu(), mapped.cpu(),
                                       *(a.cpu() for a in args[:3]), B,
                                       consts)
    card = peaks.output_positions_plain(peak_in, mapped, *args)
    one = peaks.peaks_positions(e, s, tf, ltf, model.controls, consts)
    custom = peaks.peaks_positions_custom(
        e, s, tf, ltf, _tonality_callable(model.controls), consts)
    for g, c, p, o, x in zip(got, cpu, card, one, custom):
        assert chip_smoke.same_bits(g.cpu(), c)
        assert chip_smoke.same_bits(p.cpu(), c)
        assert chip_smoke.same_bits(o, g) and chip_smoke.same_bits(x, g)


def test_planner_custom_map_launches(dev):
    """Under a custom map the planner launches G's runs and out entries
    once each and the one-launch G not at all, and plans the bits of the
    built-in map; the timed entries split each entry by phase."""
    import dataclasses
    from signalsmith_stretch_torch import engine, planner
    from signalsmith_stretch_torch.ops import peaks
    model, _, n = _mapped_model(dev)
    clip = _t(np.random.default_rng(14).standard_normal((1, 2, n))
              .astype(np.float32) * 0.1, dev)
    spectra, prev = engine.analyze_stage(clip, model.plan)
    flags = dataclasses.replace(model.flags,
                                custom_map=_tonality_callable(model.controls))
    outs = []
    for f, want in ((model.flags, dict(peaks_map=1, peaks_runs=0,
                                       peaks_out=0)),
                    (flags, dict(peaks_map=0, peaks_runs=1, peaks_out=1))):
        chip_smoke.reset_counters()
        out, dbg = planner.plan_spectral(spectra, prev, model.plan.arrays,
                                         model.controls, f,
                                         model.plan.consts, debug=True)
        torch.cuda.synchronize()
        counts = chip_smoke.counters()
        assert {k: counts[k] for k in want} == want
        assert counts["interp_multi"] == counts["iir"] == 1
        outs.append(out)
    for a, b in zip(*outs):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert chip_smoke.same_bits(x, y)
    e, s = dbg["energy"], dbg["smoothed"]
    st = peaks.runs_stamps(e, s, model.plan.consts)
    assert st.shape[1] == len(peaks.RUNS_PHASES) + 3 and st.shape[0] > 0
    peak_in, avg_freq, n_peaks = peaks.peak_runs(e, s, model.plan.consts)
    st = peaks.out_stamps(peak_in, avg_freq, n_peaks, *dbg["shifts"],
                          e.shape[1], model.plan.consts)
    assert st.shape[1] == len(peaks.OUT_PHASES) + 3 and st.shape[0] > 0


def _split_case_rows(case, dev):
    """Rows for the split's walk cases: (energy, smoothed, B, offset)."""
    from signalsmith_stretch_torch.ops import peaks
    if case == "resident_walk":
        B = 4096
        occ = peaks.split_occupancy(B)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        R = 3 * max(c for c, _ in occ.values()) * sms + 1
    elif case == "one_row":
        B, R = 4096, 1
    else:
        B, R = int(case.rsplit("_", 1)[1]), 14
    rows = chip_smoke.peaks_edge_rows(B, seed=R)
    reps = -(-R // rows[0].shape[0])
    e, s = (np.tile(a, (reps, 1))[-R:] for a in rows)
    return e, s, B, int(case.startswith("misaligned"))


def _off_by_one(x, dev, offset):
    """x on the card, as a contiguous view `offset` floats into a buffer
    (off 8- and 16-byte alignment for offset 1)."""
    flat = torch.zeros(x.size + offset, dtype=torch.float32, device=dev)
    view = flat[offset:].view(x.shape)
    view.copy_(torch.as_tensor(np.ascontiguousarray(x), device=dev))
    return view


@pytest.mark.parametrize("case", ["resident_walk", "misaligned_998",
                                  "misaligned_1000", "one_row"])
def test_peaks_split_walks_match_plain(dev, case):
    """G's runs and out entries at the edges of their walks, each bit-equal
    to its plain version on the card and on a CPU copy of its inputs: R =
    3 x (the entries' CTAs resident on this card) + 1 rows at B = 4096, so
    every CTA stages and prefetches across several rows; inputs one float
    off 8- and 16-byte alignment at B = 998 (rows alternating between the
    two, nseg odd) and 1000 (the runs entry's 4-byte loads, the out
    entry's 4-byte staging); one row, as in a stream block.  Each row its
    own block of tf and ltf."""
    from signalsmith_stretch_torch import spectral
    from signalsmith_stretch_torch.ops import peaks
    model, _, _ = _mapped_model(dev)
    consts = model.plan.consts
    e_np, s_np, B, offset = _split_case_rows(case, dev)
    R = e_np.shape[0]
    e, s = (_off_by_one(a, dev, offset) for a in (e_np, s_np))
    assert e.data_ptr() % 8 == 4 * offset
    shifts = np.random.default_rng(R).uniform(0.5, 2.0, R).astype(np.float32)
    tf, ltf = _t(shifts, dev), _t(np.float32(6) * shifts, dev)
    runs = peaks.peak_runs(e, s, consts)
    for want in (peaks.peak_runs_plain(e.cpu(), s.cpu(), consts),
                 peaks.peak_runs_plain(e, s, consts)):
        assert all(chip_smoke.same_bits(g.cpu(), w.cpu())
                   for g, w in zip(runs, want))
    peak_in, avg_freq, n_peaks = runs
    mapped = spectral.map_freq(avg_freq, model.controls)
    pin, mp = (_off_by_one(a.cpu().numpy(), dev, offset)
               for a in (peak_in, mapped))
    args = (n_peaks, tf, ltf, B, consts)
    got = peaks.output_positions(pin, mp, *args)
    cpu = peaks.output_positions_plain(pin.cpu(), mp.cpu(),
                                       *(a.cpu() for a in args[:3]), B,
                                       consts)
    card = peaks.output_positions_plain(pin, mp, *args)
    assert got[0].shape == (R, 3, B)
    for g, c, p in zip(got, cpu, card):
        assert chip_smoke.same_bits(g.cpu(), c)
        assert chip_smoke.same_bits(p.cpu(), c)


def test_peaks_map_walk_matches_cpu(dev):
    """The one-launch G, which the split's redesign leaves as it was, on a
    walk of 3 x its CTAs resident on this card + 1 rows (the edge rows
    tiled, B = 4096), bit-equal in all four planes to its plain version on
    a CPU copy of its inputs."""
    from signalsmith_stretch_torch.ops import peaks
    model, _, _ = _mapped_model(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    R = 3 * 2 * sms + 1                 # two CTAs an SM at B = 4096
    rows = chip_smoke.peaks_edge_rows(4096, seed=1)
    reps = -(-R // rows[0].shape[0])
    e, s = (_t(np.tile(a, (reps, 1))[:R], dev) for a in rows)
    shifts = np.random.default_rng(9).uniform(0.5, 2.0, R).astype(np.float32)
    tf, ltf = _t(shifts, dev), _t(np.float32(6) * shifts, dev)
    args = (e, s, tf, ltf, model.controls, model.plan.consts)
    got = peaks.peaks_positions(*args)
    cpu = peaks.peaks_positions_plain(*(a.cpu() for a in args[:4]),
                                      *args[4:])
    for g, c in zip(got, cpu):
        assert chip_smoke.same_bits(g.cpu(), c)


# ---------------------------------------------------------------------------
# The streaming engine: kernel H and the block step on the card
# ---------------------------------------------------------------------------
def _sweep_block_inputs(ch, B, dev, seed=0):
    from signalsmith_stretch_torch.ops import block_sweep
    rng = np.random.default_rng(seed)

    def c(*s):
        return (rng.standard_normal(s)
                + 1j * rng.standard_normal(s)).astype(np.complex64)

    st, lt, pu, pim = c(B), c(B), c(B), c(B)
    pem = rng.uniform(0, 1, B).astype(np.float32)
    mc = rng.integers(0, ch, B).astype(np.int32)
    ct, pi = c(ch, B), c(ch, B)
    pe = rng.uniform(0, 1, (ch, B)).astype(np.float32)
    pe[:, :5] = 0                              # silent bins
    pem[:5] = 0
    pu[10:20] *= np.float32(1e-9)              # weak lead phases
    ct[:, 30:40] *= np.float32(1e-9)           # weak locked phases
    return block_sweep.BlockSweepInputs(*[_t(a, dev) for a in (
        st, lt, pu, pem, pim, mc, ct, pe, pi)])


def max_ch_pattern(name, ch, B, longv):
    """Loudest-channel patterns for kernel H's cases (also the CPU
    schedule model's, tests/test_torch_block.py)."""
    b = np.arange(B)
    if name == "constant":
        mc = np.full(B, ch - 1)
    elif name == "every":
        mc = b % ch
    elif name.startswith("run"):
        mc = (b // int(name[3:])) % ch
    elif name == "early":           # a change at each of b = 1 .. LV
        mc = np.where(b <= longv + 1, b % ch, (b // 7) % ch)
    elif name == "tile_edge":       # changes across the 31/32, 255/256 edges
        mc = np.zeros(B, int)
        mc[[31, 255]] = 1
        mc[256:] = 2 % ch
    else:                           # random
        mc = np.random.default_rng(B + ch).integers(0, ch, B)
    return mc.astype(np.int32)


# the largest channel count the first H (one warp, every channel's inputs
# and an output ring in shared memory) accepted at LV 6: 8 (LV + 1) ch +
# 32 (40 + 20 ch) bytes within 227 KiB
ONE_WARP_MAX_CH = 332
H_CASES = ([(1, 4096, "random", 6), (2, 4096, "random", 6),
            (3, 4096, "random", 6), (2, 7, "random", 6),
            (33, 1000, "random", 6), (64, 300, "random", 6)]
           + [(c, 600, p, 6) for p in ("constant", "every", "run2", "run5",
                                       "run6", "run7", "run300", "early",
                                       "tile_edge") for c in (2, 3)]
           + [(ONE_WARP_MAX_CH, 333, "random", 6), (3, 1000, "random", 6),
              (2, 4, "every", 6), (3, 1, "random", 6)]
           + [(3, 600, "random", lv) for lv in (1, 2, 3, 4)])


@pytest.mark.parametrize("ch,B,pattern,longv", H_CASES,
                         ids=[f"{p}-ch{c}-B{b}-lv{v}"
                              for c, b, p, v in H_CASES])
def test_block_sweep_kernel_matches_plain(dev, ch, B, pattern, longv):
    """H against its plain version, bit for bit: one channel to more than
    a warp's lanes and ONE_WARP_MAX_CH; the loudest-channel patterns of
    tests/test_torch_block.py (runs, a change at every bin, at b = 1..LV,
    across tile edges); B not a multiple of the tile, B < LV, B = 1; LV 1-4
    (downl formed in place below 4, the shortest early lead at 4)."""
    from signalsmith_stretch_torch.ops import block_sweep
    x = _sweep_block_inputs(ch, B, dev, seed=ch)
    if pattern != "random":
        mc = max_ch_pattern(pattern, ch, B, longv)
        x = x._replace(max_ch=_t(mc, dev))
    got = block_sweep.block_sweep(x, longv)
    ref = block_sweep.block_sweep_plain(x, longv)
    assert got.shape == (ch, B) and got.device == x.pe.device
    assert torch.equal(torch.view_as_real(got).view(torch.int32),
                       torch.view_as_real(ref).view(torch.int32))
    stamps = block_sweep.phase_stamps(x, longv)
    assert stamps.shape == (1, len(block_sweep.PHASES) + 3)
    st = stamps[0].tolist()
    assert st[1] > 0 and st[-2] > st[-3]


def test_block_sweep_chain_floor(dev):
    """The floor entry (one thread, the lead recursion alone) launches on
    a stream block's shapes and returns a positive time and every bin."""
    from signalsmith_stretch_torch.ops import block_sweep
    x = _sweep_block_inputs(2, 4096, dev)
    cycles, t0, t1, bins = block_sweep.chain_floor(x)[0].tolist()
    assert cycles > 0 and t1 > t0 and bins == 4096
    cycles, t0, t1, bins = block_sweep.chain_floor(
        _sweep_block_inputs(1, 5, dev))[0].tolist()
    assert cycles > 0 and bins == 8


@pytest.mark.parametrize("kw", [dict(), dict(semitones=5),
                                dict(semitones=5, formant_semitones=3),
                                dict(semitones=12, custom=True)],
                         ids=["unmapped", "mapped", "formant_auto", "custom"])
def test_stream_blocks_kernels_match_plain(dev, kw):
    """process_block through the kernels against the plain path on the
    card, on a stream's first blocks (their carries and D spectra): the
    output and every carry field bit-equal; each block launches its
    kernels once."""
    cfg = ("stream", 1.25 if not kw else 1.0, kw)
    clip = chip_smoke.make_corpus(1, 2, 48000, chip_smoke.RATE, seed=1)[0]
    dbg, eng = chip_smoke.check_stream_blocks(cfg, clip)
    assert dbg["sweep"].pe.shape == (2, 4096)
    from signalsmith_stretch_torch import spectral
    from signalsmith_stretch_torch.ops import dft
    block, H = eng.cfg.block_samples, eng.cfg.interval_samples
    c = _t(clip, dev)
    chip_smoke.reset_counters()
    specs = dft.analyze(torch.cat([c[:, H:H + block], c[:, :block]]),
                        eng.basis)
    xs = spectral.BlockInputs(specs[:2], specs[2:], True, True,
                              np.float32(1))
    spectral.process_block(spectral.SpectralCarry.initial(eng.consts, 0, dev),
                           xs, eng.controls, eng.flags, eng.consts)
    torch.cuda.synchronize()
    want = chip_smoke.expected_stream_launches(eng.flags, 1)
    want["dft"] = 1
    assert chip_smoke.counters() == want


def test_stream_on_card_matches_cpu(dev):
    """An unmapped 1.0x stream through the library object on the card
    against the same calls on the CPU (the plain versions): within -100
    dB a call against the stream's energy (D rounds otherwise than the
    CPU's FFT; the recursion is stable at 1.0x); no synchronising call
    inside a call's block loop."""
    import warnings
    from signalsmith_stretch_torch import SignalsmithStretch
    clip = chip_smoke.make_corpus(1, 2, 48000, chip_smoke.RATE, seed=2)[0]
    outs = []
    for device in ("cuda", "cpu"):
        s = SignalsmithStretch(device=device)
        s.preset_default(2, chip_smoke.RATE)
        eng = s._stream()
        normal, syncs = eng._normal, []

        def counted(*a, _n=normal, **k):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                r = _n(*a, **k)
            syncs.append(sum("synchroniz" in str(x.message) for x in w))
            return r

        eng._normal = counted
        if device == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True):   # the calls' copies
                warnings.simplefilter("always")
                o, _ = chip_smoke._stream_calls(s, clip, 1.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append(o)
        if device == "cuda":
            assert sum(syncs) == 0, syncs
    power = np.mean(np.concatenate(outs[1], 1).astype(np.float64) ** 2)
    for g, w in zip(*outs):
        assert g.shape == w.shape
        err = np.mean((g.astype(np.float64) - w) ** 2) if g.size else 0.0
        assert 10 * np.log10(err / power + 1e-30) < -100


def _card_stream(semitones=0.0):
    from signalsmith_stretch_torch import SignalsmithStretch
    s = SignalsmithStretch(device="cuda")
    s.preset_default(2, chip_smoke.RATE)
    if semitones:
        s.set_transpose_semitones(semitones, 8000 / chip_smoke.RATE)
    return s._stream()


@pytest.mark.parametrize("semitones", [0.0, 5.0], ids=["unmapped", "mapped"])
def test_process_many_on_card_bit_equal_to_sequential(dev, semitones):
    """process_many and process_many_live on the card: bit-equal to the
    seek + process and process calls they stand for, with no synchronising
    call inside their loops once the stream's device constants are made
    (its first blocks copy them to the card, as in chip_smoke.py's
    set-up runs)."""
    clip = chip_smoke.make_corpus(1, 2, 96000, chip_smoke.RATE, seed=3)[0]
    eng = _card_stream(semitones)
    buf = eng.cfg.input_latency + eng.cfg.output_latency
    hists = np.stack([clip[:, 64 * i:64 * i + buf] for i in range(24)])
    rates = np.float32([0.8] * 12 + [1.25] * 12)
    eng.process_many(hists, rates, 128)              # set-up
    eng.reset()
    with chip_smoke.SyncCounter() as sc:
        many = eng.process_many(hists, rates, 128)
    assert sc.inside == 0
    eng.reset()
    seq = []
    for h, r in zip(hists, rates):
        eng.seek(h, r)
        seq.append(eng.process(np.zeros((2, 0), np.float32), 128))
    np.testing.assert_array_equal(many, np.stack(seq))
    xs = np.stack([clip[:, 20000 + 128 * i:20000 + 128 * (i + 1)]
                   for i in range(24)])
    snap = eng.state_dict()
    with chip_smoke.SyncCounter() as sc:
        live = eng.process_many_live(xs, 128)
    assert sc.inside == 0
    eng.load_state_dict(snap)
    np.testing.assert_array_equal(live,
                                  np.stack([eng.process(x, 128) for x in xs]))


def test_node_batched_on_card_bit_equal(dev):
    """A two-channel StretchNode on the card with a mapped segment (+5 st,
    8 kHz limit) after an unmapped one: render(batched=True) bit-equal to
    the quantum-by-quantum render."""
    from signalsmith_stretch_torch.scheduler import StretchNode
    clip = chip_smoke.make_corpus(1, 2, 96000, chip_smoke.RATE, seed=4)[0]

    def run(batched):
        node = StretchNode(chip_smoke.RATE, channels=2, quantum=128,
                           device="cuda")
        node.add_buffers(clip)
        node.schedule(output=0.0, input=0.0, rate=0.8)
        node.schedule(output=0.25, input=1.0, rate=1.0, semitones=5,
                      tonality_hz=8000)
        return node.render(0.6, batched=batched)

    a = run(False)
    assert np.isfinite(a).all() and a.shape == (2, 28800)
    np.testing.assert_array_equal(run(True), a)


def test_parallel_one_card_bit_equal_to_render_exact(dev):
    """batch_render and stretch_long over a one-card mesh: bit-equal to
    engine.render_exact on the same batch and seeds."""
    from signalsmith_stretch_torch import engine
    from signalsmith_stretch_torch.models import StretchModel
    from signalsmith_stretch_torch.parallel import batch as pbatch
    from signalsmith_stretch_torch.parallel import timechunk
    mesh = pbatch.make_mesh(1)
    clips = chip_smoke.make_corpus(4, 2, 48000, chip_smoke.RATE, seed=5)
    model = StretchModel.build(2, chip_smoke.RATE, 48000, 60000,
                               semitones=3, tonality_hz=8000)
    seeds = np.arange(4) + 2
    got = pbatch.batch_render(model.plan, model.flags, mesh=mesh)(
        clips, model.controls, seeds)
    want = engine.render_exact(_t(clips, dev), model.plan, model.controls,
                               model.flags, seeds=[int(s) for s in seeds])
    assert torch.equal(got, want)
    long = chip_smoke.make_corpus(1, 2, 192000, chip_smoke.RATE, seed=6)[0]
    out = timechunk.stretch_long(long, 240000, model.cfg, model.controls,
                                 model.flags, n_chunks=4, seed=1, mesh=mesh)
    edges, starts, in_len, out_len = timechunk.plan_chunks(
        model.cfg, 192000, 240000, 4)
    plan = engine.build_exact_plan(model.cfg, in_len, out_len)
    chunks = engine.render_exact(
        _t(timechunk.chunk_windows(long, starts, in_len), dev), plan,
        model.controls, model.flags, seeds=[1, 2, 3, 4])
    np.testing.assert_array_equal(
        out, timechunk.assemble(chunks.cpu().numpy(), edges, 240000))


# ---------------------------------------------------------------------------
# Kernel I: the draws above 2x, offline and per stream block
# ---------------------------------------------------------------------------
def _draws_check(dev, seeds, tf, B):
    """I against its plain version on the card, bit for bit, with the
    planner's cached keys and bounds; the launch counter moves by one."""
    from signalsmith_stretch_torch import planner
    from signalsmith_stretch_torch.ops import draws
    bounds = on_device(np.asarray(tf, np.float32), dev, planner.draw_bounds)
    args = (planner._clip_keys(tuple(seeds), dev), *bounds, B)
    n0 = draws.launches
    got = draws.draws_factors(*args)
    assert draws.launches == n0 + 1
    ref = draws.draws_factors_plain(*args)
    for g, r in zip(got, ref):
        assert g.shape == (len(seeds), len(tf), B) and g.device.type == "cuda"
        assert chip_smoke.same_bits(g, r)


@pytest.mark.parametrize("cell", [chip_smoke.RANDOM, chip_smoke.RANDOM_MAPPED],
                         ids=["3x", "2.5x"])
@pytest.mark.parametrize("batch", [1, 8])
def test_draws_kernel_matches_plain_cells(dev, cell, batch):
    """I at the randomised cells' shapes (10 s stereo 48 kHz, B = 4096,
    the plans' time factors), seeds 0..batch-1."""
    from signalsmith_stretch_torch.config import MAX_CLEAN_STRETCH
    model, _ = chip_smoke._model(cell, 1)
    tf = np.maximum(model.plan.arrays["time_factor"],
                    np.float32(1 / MAX_CLEAN_STRETCH))
    assert (tf > 2).any()
    _draws_check(dev, range(batch), tf, 4096)


DRAW_SHAPES = [(1, 4096, (0,)), (1, 37, (2 ** 31,)),
               (7, 4097, (-1, 2 ** 31, 5)), (7, 37, tuple(range(8))),
               (3, 1, (1,)), (5, 6, (2 ** 32 + 5, 3))]


@pytest.mark.parametrize("nB,B,seeds", DRAW_SHAPES,
                         ids=[f"nB{n}-B{b}-batch{len(s)}"
                              for n, b, s in DRAW_SHAPES])
def test_draws_kernel_shapes(dev, nB, B, seeds):
    """I at odd B (scalar stores), nB = 1, batch 1 to 8, key words past
    2**31, with blocks below 2x, at 2x, just above and at 4x (lo_d = 0)."""
    rng = np.random.default_rng(nB * 1000 + B)
    tf = rng.choice(np.asarray([1.5, 2.0, np.nextafter(np.float32(2), 3),
                                2.5, 3.0, 4.0], np.float32), nB)
    tf[-1] = 4.0
    _draws_check(dev, seeds, tf, B)


@pytest.mark.parametrize("B", [4096, 37])
def test_draws_block_kernel_stream_keys(dev, B):
    """I's stream entry under 16 consecutive split keys of a stream seeded
    past 2**31, at 3x, a flush's 1440 and 4x, bit-equal to the plain
    version (prng.uniform of (2, B)); one launch each."""
    from signalsmith_stretch_torch import prng
    from signalsmith_stretch_torch.ops import draws
    k = prng.key(2 ** 31 + 5)
    for blk in range(16):
        k, sub = prng.split(k)
        tf = np.float32((3.0, 1440.0, 4.0)[blk % 3])
        lo = np.float32(np.float32(4) - tf)
        n0 = draws.launches
        got = draws.draws_block(sub, lo, tf, B, dev)
        assert draws.launches == n0 + 1
        ref = draws.draws_block_plain(sub, lo, tf, B, dev)
        assert got.shape == (2, B) and chip_smoke.same_bits(got, ref)


def test_stream_blocks_3x_draw(dev):
    """process_block at 3x through the kernels against the plain path on a
    stream's first blocks, bit for bit (the draws feed the votes); a block
    above 2x launches I once."""
    from signalsmith_stretch_torch import spectral
    from signalsmith_stretch_torch.ops import dft
    clip = chip_smoke.make_corpus(1, 2, 48000, chip_smoke.RATE, seed=1)[0]
    _, eng = chip_smoke.check_stream_blocks(("stream_3x", 3.0, {}), clip)
    block, H = eng.cfg.block_samples, eng.cfg.interval_samples
    c = _t(clip, dev)
    chip_smoke.reset_counters()
    specs = dft.analyze(torch.cat([c[:, H:H + block], c[:, :block]]),
                        eng.basis)
    xs = spectral.BlockInputs(specs[:2], specs[2:], True, True,
                              np.float32(3))
    spectral.process_block(spectral.SpectralCarry.initial(eng.consts, 0, dev),
                           xs, eng.controls, eng.flags, eng.consts)
    torch.cuda.synchronize()
    want = chip_smoke.expected_stream_launches(eng.flags, 1, 1)
    want["dft"] = 1
    assert chip_smoke.counters() == want


# ---------------------------------------------------------------------------
# Kernel J: the prediction coefficients of the offline planner
# ---------------------------------------------------------------------------
def _coefficient_planes(dev, ch, longv, drawn):
    """Random planes of 2 clips x 5 blocks x 1000 bins (not a multiple of
    J's 256 threads), blocks 1 and 3 not new; pi and pe channel views of
    [batch, nB, ch, B] tensors; ties and zeros among the energies."""
    rng = np.random.default_rng(20 + 3 * ch + longv)
    batch, nB, B = 2, 5, 1000

    def cplx(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return _t(z.astype(np.complex64), dev)

    pe = rng.uniform(0, 2, (batch, nB, ch, B)).astype(np.float32)
    pe[..., ::7] = 0
    pe[..., 3::11] = pe[..., :1, 3::11]
    new = np.array([True, False, True, False, True])
    votes = [[cplx(batch, nB, B) for _ in range(ch)]
             for _ in range(4 if drawn else 2)]
    return (cplx(batch, nB, ch, B).unbind(2),
            [cplx(batch, nB, B) for _ in range(ch)], _t(pe, dev).unbind(2),
            votes, cplx(B), new, longv)


def _planner_coefficient_args(dev, case):
    """J's arguments as the planner passes them, 8 kHz stereo, 2 clips."""
    from signalsmith_stretch_torch import engine, planner
    ratio, semitones = {"unmapped": (1.25, 0), "mapped": (1.0, 12),
                        "3x": (3.0, 0), "2.5x_pitch+2": (2.5, 2),
                        "not_all_new": (1.25, 0)}[case]
    model, n = _random_model(dev, ratio, semitones)
    clip = _t(np.random.default_rng(12).standard_normal((2, 2, n))
              .astype(np.float32) * 0.1, dev)
    spectra, prev = engine.analyze_stage(clip, model.plan)
    arrays = dict(model.plan.arrays)
    if case == "not_all_new":
        new = arrays["new_spectrum"].copy()
        new[2::3] = False
        arrays.update(new_spectrum=new, reanalyse=arrays["reanalyse"] & new)
        arrays = engine.plan_tables(arrays, model.cfg)
    out, dbg = planner.plan_spectral(spectra, prev, arrays, model.controls,
                                     model.flags, model.plan.consts,
                                     debug=True)
    return dbg["coefficients"], out


COEF_SYNTHETIC = [f"ch{c}_lv{lv}_{kind}" for c in (1, 2, 3) for lv in (4, 5, 6)
                  for kind in ("shifted", "drawn")]
COEF_PLANNER = ["unmapped", "mapped", "3x", "2.5x_pitch+2", "not_all_new"]


@pytest.mark.parametrize("case", COEF_PLANNER + COEF_SYNTHETIC)
def test_coefficients_kernel_matches_plain(dev, case):
    """J against its plain version on the card, every output torch.equal:
    on the planner's own arguments (unmapped, mapped, the randomised regime
    at 3x and at 2.5x with a pitch shift, a schedule where not every block
    is new), and on random planes of 1 to 3 channels at LV 4 to 6 with the
    up votes shifted or drawn; the launch counter moves by one."""
    from signalsmith_stretch_torch.ops import coefficients
    if case in COEF_PLANNER:
        args, out = _planner_coefficient_args(dev, case)
        assert len(args[3]) == (4 if case in ("3x", "2.5x_pitch+2") else 2)
        assert args[5].all() == (case != "not_all_new")
    else:
        ch, lv, kind = case.split("_")
        args = _coefficient_planes(dev, int(ch[2:]), int(lv[2:]),
                                   kind == "drawn")
        out = None
    n0 = coefficients.launches
    got = coefficients.coefficients(*args)
    assert coefficients.launches == n0 + 1
    ref = coefficients.coefficients_plain(*args)
    names = ("a1", "a2", "d1", "d2", "mc")
    for name, g, r in zip(names, got, ref):
        assert g.device.type == "cuda" and g.is_contiguous(), name
        assert torch.equal(g, r), name
        if out is not None:
            assert torch.equal(g, getattr(out, name)), name


# the offline render's copies (models/stretch.copy_in, copy_out): clips of
# 1 s stereo at 48 kHz, two staging blocks and one clip more, so that the
# walk refills a block
COPY_RATE = 48000
COPY_CELLS = {"pitch12": (1.0, dict(semitones=12.0, tonality_hz=8000.0)),
              "stretch1.25": (1.25, {})}


def _copy_model(dev, cell):
    from signalsmith_stretch_torch.models import stretch
    tf, kw = COPY_CELLS[cell]
    model = StretchModel.build(2, COPY_RATE, COPY_RATE,
                               int(COPY_RATE * tf), device=dev, **kw)
    batch = 2 * stretch.STAGE_CLIPS + 1
    clips = chip_smoke.make_corpus(batch, 2, COPY_RATE, COPY_RATE)
    return model, clips


@pytest.mark.parametrize("kind", ["float32", "float64", "strided", "pinned"])
@pytest.mark.parametrize("cell", sorted(COPY_CELLS))
def test_host_input_renders_to_pinned_memory(dev, cell, kind):
    """Host input: a CPU tensor in pinned memory, bit-equal to the render
    of the same clips as a CUDA tensor, which stays on the card."""
    model, clips = _copy_model(dev, cell)
    x = clips.astype(np.float64) if kind == "float64" else clips
    on_card = model.batched(torch.as_tensor(x, dtype=torch.float32,
                                            device=dev))
    assert on_card.device.type == "cuda"
    if kind == "strided":
        x = np.repeat(clips, 2, axis=-1)[..., ::2]
    elif kind == "pinned":
        x = torch.as_tensor(clips).pin_memory()
    got = model.batched(x)
    assert got.device.type == "cpu" and got.is_pinned()
    assert torch.equal(got, on_card.cpu())
    one = model(x[3])
    assert one.device.type == "cpu" and one.is_pinned()
    assert torch.equal(one, on_card[3].cpu())


def test_host_results_keep_their_own_storage(dev):
    """Two results held across a third call keep their storage and values;
    the copy out's span counts the host-input calls, never a device
    input's."""
    from torch.profiler import ProfilerActivity, profile
    model, clips = _copy_model(dev, "stretch1.25")
    first = model.batched(clips)
    second = model.batched(clips[::-1].copy())
    kept = first.clone(), second.clone()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        third = model.batched(0.5 * clips)
        model.batched(torch.as_tensor(clips, device=dev))
        model.batched(clips)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("sst.render.copy_out") == 2
    assert names.count("sst.render.copy_in") == 3
    assert len({first.data_ptr(), second.data_ptr(), third.data_ptr()}) == 3
    assert torch.equal(first, kept[0]) and torch.equal(second, kept[1])
    assert not torch.equal(third, first)
