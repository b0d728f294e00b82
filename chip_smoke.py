#!/usr/bin/env python3
"""Drive the PyTorch port (signalsmith_stretch_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. header: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: every kernel source of csrc/ with nvcc, one process each;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (batch 8 x 10 s stereo 48 kHz): the
     analysis DFT (D) on the 1.25x render's frames, within 3e-6 of the
     spectrum's peak of the plain analysis (cuFFT); on the pitch+12
     configuration's planner inputs the interp kernel (A) in lerp and taps
     mode, on G's stacked positions and on the list form, the slew scan
     (C: the smoothing's four passes in one launch, and one pass each way),
     the peaks and output map (G: its four planes, the three position sets
     and the gradient, also on edge rows at four widths, and against the
     plain version on a CPU copy of its inputs: each run summed
     bin-ascending; its time split by phase through its timed entry, and
     its device time in a render), G's runs and out entries (the split
     around a custom map) the same way, and the diagonal sweep (B); on the
     auto-base formant configuration's metric the decay scans (E: the
     envelope's eight passes in one launch, and each single pass) and the
     top-3 scan (F, also on corner rows); every kernel but D bit-equal, C
     and E in their outputs and final values; the prediction coefficients
     (J) on the pitch+12 planner's arguments.  C, E and F are also timed on one
     row (`chain_ms`): for C and E one lane runs the whole chain, the
     card's own serial floor for that work; for F one warp;
     Above 2x (the randomised regime): A on the 3x cell's four per-bin
     vote sets and on the 2.5x pitch+2 cell's five sets, bit-equal and
     timed, and the draws (I) of both cells' batches bit-equal to their
     plain version (prng.uniform and the selects), also under key words
     past 2**31, timed against a bound of bytes or of the int32
     instructions its SASS issues a draw (cuobjdump); the synthesis at the
     1.25x, pitch+12 and 3x renders' shapes (every fourth clip zeroed, so
     the silence bypass runs): the inverse modified DFT (K) within 3e-6 of
     the blocks' peak of the plain synthesis (cuFFT on a padded copy), the
     assembly (L) bit-equal to its plain version on K's blocks, each timed
     beside its byte bound, and K and L together against the plain stage;
  4. renders of stereo48k_default_1.25x, stereo48k_pitch+12_tonality8k,
     formant_vocal_shift (base 220 Hz), formant_vocal_shift_auto (base
     estimated per block), stereo48k_3x_random (3x, no pitch map),
     stereo48k_2.5x_pitch+2_tonality8k, stereo48k_custom_tonality_map
     (pitch+12's map as a torch callable through G's runs and out entries:
     its render bit-identical to pitch+12's) and
     stereo48k_1.25x_power_warp_formantcomp (a power warp, formant
     compensation through the callable, base estimated) at batch 8 x 10 s
     stereo 48 kHz through StretchModel.batched, with each configuration's
     launch counts,
     finiteness, shape, run-to-run bit identity, and a batch-1 clip (3 s
     for the two randomised cells) through the kernels against the same
     clip through the plain versions: the spectral stage (A, B, C, E, F, G)
     on the spectra of one analysis through D bit-equal, and the whole
     render bit-equal, else within the chaos-relative gate (D rounds
     otherwise than cuFFT);
  5. automation: SignalsmithStretch.exact on one 10 s clip with per-block
     controls (a pitch ramp 0 to +7 semitones, 8 kHz limit, formant +3
     semitones with compensation, base estimated): its launch counts, G
     with per-block controls bit-equal to its plain version on a CPU copy
     and on the card, and a 3 s clip's render gate as in phase 4;
  6. the CLI (python3 -m signalsmith_stretch_torch.cli) in a subprocess on
     a 10 s stereo 16-bit WAV at 1.25x and +3 semitones: its file equal to
     exact()'s render of the same samples, quantised the same way;
  7. the dev CLI (cli_dev) twice on a 10 s WAV: the golden snapshot, then
     the -60 dB gate against it with --profile, the allocation guard on
     both;
  8. streaming: one 10 s stereo 48 kHz clip through the library object's
     streaming methods (output_seek, process in 512-sample output calls,
     flush at rate 0) at 1.25x, at pitch+12 with the 8 kHz limit, with a
     formant shift (base estimated) and under pitch+12's map as a torch
     callable (its stream bit-identical to pitch+12's), and at 3x (every
     block draws, as an ambient slow-down): each stream's launches a block
     by kernel (D, A and H once a block; C, G, E, F as its flags ask; I
     once a block above 2x, the flush's included), synchronising calls
     under torch.cuda.set_sync_debug_mode (in all, and inside the block
     loops), ms a call (median, p99), ms a block, the realtime factor and
     peak memory; process_block through the kernels bit-equal to the plain
     path on the card on the stream's first 8 blocks, and the share of
     their bins where the lead changes (down1 locked) and where mc[b-LV]
     != mc[b] (downl locked); H (also with a third channel), A, G (or its
     split), F, I (a block's (2, B) draws) and D at one row against their
     plain versions, timed, H's phases from its timed entry (`chain_ms`,
     cycles a bin, the chain warp's waits on inputs and on the consumers)
     and its dependency floor from the floor entry, one thread running the
     lead recursion alone (`chain_floor_ms`); the first 0.5 s through the
     kernels against the plain path on the CPU, within 12 dB of the plain
     stream's own 1-ulp sensitivity, band energies within 3 dB;
  9. the scheduler and the worklet host: a StretchNode (default preset,
     stereo 48 kHz, 128-sample quanta) on the streams' 10 s clip with
     examples/scheduled_playback.py's schedule and a vocal-tuner segment
     (formant +3 st with compensation, base estimated), so that D, A, H,
     C, G, E and F launch: 5 s quantum by quantum (ms a quantum, median
     and p99, against the 2.667 ms budget; launches; synchronising calls
     a quantum) and through render(batched=True) from a fresh node (one
     process_many a segment run, no synchronising call inside its loop),
     bit-equal; the first 0.5 s against the plain path on the CPU (the
     streaming phase's gate); 2 s of live input at 1.0x quantum by quantum
     and batched, bit-equal; WorkletHost with batch_quanta 1 and 8, 2 s
     each bit-equal to the node driven directly, and the render thread's
     ms a quantum;
 10. the corpus and the parallel layer: 16 stereo 48 kHz WAVs of 5-10 s
     (pairs of utils/evaluation.synth_clip kinds) at 1.25x and at +5 st
     through io/corpus (load_directory, batches of 8) and
     parallel.batch.batch_render over make_mesh(): each batch bit-equal to
     StretchModel.batched, the realtime factor and peak memory of a pass;
     a 60 s stereo clip at 1.25x as 8 chunks (parallel.timechunk.
     stretch_long) against the monolithic render: envelopes within 1.5
     dB away from the seams, the first chunk within -19 dB, both wall
     times; parallel.distributed in single-process mode: initialize()
     False, global_batch -> allgather bit-equal;
 11. the kernel table as one JSON line, the nvidia-smi line, and the device
     line {"ok": true, "device": {...}} last.  A kernel's `ms` is the median
     of 20 launches, each alone between CUDA events (5 for B); `ms_b2b` the
     mean of 20 issued back to back, which hides the host's launch time.

With `--block-sweep-floor` the script runs only H's floor entry (after
the header and H's build); with `--prior-block-sweep FILE`, H against an
earlier H built from FILE, in turns, on two streams' blocks; with
`--prior-peaks-split FILE`, G's runs and out entries and the one-launch G
against those of an earlier peaks.cu built from FILE (for instance
`git show HEAD:signalsmith_stretch_torch/csrc/peaks.cu`), bit-equal, then
in turns on the pitch+12 cell's planner rows and at one row; with
`--scheduler-parallel`, phases 9 and 10 alone (after the header and the
build); with `--coefficients`, J alone on the planner's arguments of
pitch+12 and 1.25x at batch 8 and 32 (after the header and the build);
with `--synthesis`, K and L alone at batch 8 and 32 (after the header and
the build).

There is no CPU fallback: without CUDA the script fails.
"""
from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

RATE = 48000
SECONDS = 10.0
BATCH = 8
FORMANT = dict(semitones=5, tonality_hz=8000, formant_semitones=3,
               formant_compensation=True)
CONFIGS = (
    ("stereo48k_default_1.25x", 1.25, {}),
    ("stereo48k_pitch+12_tonality8k", 1.0, dict(semitones=12,
                                                tonality_hz=8000)),
    ("formant_vocal_shift", 1.0, dict(FORMANT, formant_base_hz=220)),
    ("formant_vocal_shift_auto", 1.0, dict(FORMANT, formant_base_hz=0)),
    # above 2x: per-bin time factors drawn from each clip's seed
    ("stereo48k_3x_random", 3.0, {}),
    ("stereo48k_2.5x_pitch+2_tonality8k", 2.5, dict(semitones=2,
                                                    tonality_hz=8000)),
    # custom frequency maps (a torch callable between G's two entries):
    # pitch+12's map written as a callable, and a power warp with formant
    # compensation (the formant targets through the callable too)
    ("stereo48k_custom_tonality_map", 1.0, dict(
        semitones=12, tonality_hz=8000, custom_map="tonality")),
    ("stereo48k_1.25x_power_warp_formantcomp", 1.25, dict(
        formant_compensation=True, formant_base_hz=0,
        custom_map="power_warp")),
)
(STRETCH, MAPPED, _, FORMANT_AUTO, RANDOM, RANDOM_MAPPED, CUSTOM_TONALITY,
 POWER_WARP) = CONFIGS
# the batch-1 plain gate of these cells renders a shorter clip: the plain
# sweep takes ~30 ms a block row, and a 10 s clip at 3x has ~1000 rows
GATE_SECONDS = {RANDOM[0]: 3.0, RANDOM_MAPPED[0]: 3.0}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 flop/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

DEVICE = "cuda"
# timed repeats: kernels (CUDA events), plain versions, whole renders
KERNEL_REPS, PLAIN_REPS, RENDER_REPS = 20, 2, 3
# rounds of two cells' renders timed in turns (renders_in_turns)
TURN_REPS = 8
# the planner's slew smoothing: four passes, down then up, twice
SMOOTHING = (True, False, True, False)

# the kernels: (name, source, the TPU code it replaces)
KERNELS = (
    ("interp_multi", "signalsmith_stretch_torch/csrc/interp.cu",
     "signalsmith_stretch_tpu/ops/pallas/interp.py:37"),
    ("sweep", "signalsmith_stretch_torch/csrc/sweep.cu",
     "signalsmith_stretch_tpu/wavefront.py:169"),
    ("iir", "signalsmith_stretch_torch/csrc/scan.cu",
     "signalsmith_stretch_tpu/ops/scan_ops.py:60"),
    ("dft", "signalsmith_stretch_torch/csrc/dft.cu",
     "tools/exp_pallas_dft.py:81"),
    ("decay", "signalsmith_stretch_torch/csrc/decay.cu",
     "signalsmith_stretch_tpu/ops/scan_ops.py:95"),
    ("top3", "signalsmith_stretch_torch/csrc/top3.cu",
     "signalsmith_stretch_tpu/spectral.py:325"),
    ("peaks_map", "signalsmith_stretch_torch/csrc/peaks.cu",
     "signalsmith_stretch_tpu/spectral.py:260"),
    # G split around a custom map: the runs and sums, then the output map
    ("peaks_runs", "signalsmith_stretch_torch/csrc/peaks.cu",
     "signalsmith_stretch_tpu/spectral.py:261"),
    ("peaks_out", "signalsmith_stretch_torch/csrc/peaks.cu",
     "signalsmith_stretch_tpu/spectral.py:276"),
    # the streaming engine's per-block bin sweep
    ("block_sweep", "signalsmith_stretch_torch/csrc/block_sweep.cu",
     "signalsmith_stretch_tpu/spectral.py:518"),
    # the draws above 2x (jax.random.uniform, offline and per stream block)
    ("draws", "signalsmith_stretch_torch/csrc/draws.cu",
     "signalsmith_stretch_tpu/planner.py:485"),
    # the offline planner's prediction coefficients (plain jnp, XLA-fused)
    ("coefficients", "signalsmith_stretch_torch/csrc/coefficients.cu",
     "signalsmith_stretch_tpu/planner.py:562"),
    # the offline synthesis: the inverse modified DFT (XLA's FFT) and the
    # overlap-add and assembly (plain jnp)
    ("idft", "signalsmith_stretch_torch/csrc/idft.cu",
     "signalsmith_stretch_tpu/stft.py:349"),
    ("ola", "signalsmith_stretch_torch/csrc/ola.cu",
     "signalsmith_stretch_tpu/engine.py:155"),
)
DFT_TOL = 3e-6        # of the spectrum's peak magnitude (tests/test_stft.py)


def make_corpus(batch, channels, in_len, rate, seed=0):
    """The clips bench.py renders: two sines plus noise, rolled per clip
    and channel, plus independent noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(in_len) / rate
    base = (0.4 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(in_len))
    clips = np.stack([np.stack([np.roll(base, 13 * c + 7 * b)
                                for c in range(channels)])
                      for b in range(batch)]).astype(np.float32)
    clips += 0.01 * rng.standard_normal(clips.shape).astype(np.float32)
    return clips


def rel_err_db(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return 10 * np.log10(np.mean((a - b) ** 2) / (np.mean(b ** 2) + 1e-30)
                         + 1e-30)


def band_energy_db(x, nbands=24):
    """Per-channel energies of nbands equal-width bands, in dB."""
    spec = np.abs(np.fft.rfft(x * np.hanning(x.shape[-1]), axis=-1)) ** 2
    edges = np.linspace(0, spec.shape[-1], nbands + 1, dtype=int)
    e = np.stack([spec[..., a:b].sum(-1) for a, b in zip(edges, edges[1:])],
                 -1)
    return 10 * np.log10(e + 1e-20)


def top3_corner_rows(seed=0):
    """The top-3 scan's corners, as float32 [rows, B] arrays at B = 3, 5,
    37, 300 and 333 (only 300 a multiple of four, which the float4 loads
    need; none a multiple of a warp's 128-bin chunk): peaks over a noise
    floor; a NaN at bin 0; NaN local maxima with their neighbours; -0.0 and
    +0.0 peaks that tie; +inf peaks with -inf around them; plateaus; equal
    peaks; a silent row; a constant row; bin 0 above every peak; a rising
    row; alternating equal peaks."""
    rng = np.random.default_rng(seed)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    sets = [np.array([[0, 1, 0], [nan, 1, 0], [1, 1, 0], [0, inf, 0],
                      [-1, -0.0, -1], [0, nan, 0], [2, 1, 0]], np.float32),
            rng.exponential(1.0, (6, 5)).astype(np.float32)]
    for B in (37, 300, 333):
        m = rng.exponential(0.01, (12, B)).astype(np.float32)
        for r in range(12):
            m[r, rng.integers(1, B - 1, 8)] += rng.uniform(0.5, 5, 8)
        m[1, 0] = nan
        m[2, 5:B - 1:7] = nan                    # NaN maxima, and around
        m[3] = -1
        m[3, 0] = -2
        m[3, [5, 9, 13, 17]] = [0.0, -0.0, 0.0, -0.0]
        m[4] = -inf
        m[4, 0] = 0
        m[4, [3, 20, B - 2]] = inf
        m[4, [8, 12]] = 1
        m[5] = np.round(m[5] * 4) / 4            # plateaus
        m[6, 10:20] = m[6, B - 20:B - 10] = 3.0  # equal peaks
        m[7] = 0
        m[8] = 1.5
        m[9, 0] = 100
        m[10] = np.arange(B, dtype=np.float32)
        m[11] = np.where(np.arange(B) % 2, np.float32(2), np.float32(1))
        sets.append(m)
    return sets


def peaks_edge_rows(B, seed=0):
    """Energy and smoothed rows [14, B] float32 (B >= 64) for the peaks
    map's edges: no run; one run of all B bins; alternating bins (B/2
    runs, the most a row can hold); a run from bin 0; a run to bin B-1; a
    single peak in the top bins (its mapped output above B under a pitch
    map up); a run of zero energy (its average band 0/1); the rest random
    spectra over their smoothed curves."""
    rng = np.random.default_rng(seed)
    e = rng.exponential(0.05, (14, B))
    for r in range(14):
        e[r, rng.integers(0, B, 12)] += rng.uniform(0.5, 20, 12)
    box = np.ones(9) / 9
    sm = np.stack([np.convolve(row, box, mode="same") for row in e])
    sm = sm * 1.2 + 0.01
    b = np.arange(B)
    e[0], sm[0] = 0.5, 1.0                        # no run
    e[1], sm[1] = rng.uniform(1, 2, B), 0.5       # one run of all B bins
    e[2], sm[2] = np.where(b % 2, 2.0, 0.1), 1.0  # alternating: B/2 runs
    sm[3, :25] = 0                                # a run from bin 0
    e[3, :25] += 0.1
    sm[4, B - 25:] = 0                            # a run to bin B-1
    e[4, B - 25:] += 0.1
    e[5], sm[5] = 0.1, 1.0                        # one peak near the top
    e[5, B - 8:B - 3] = [2, 5, 9, 5, 2]
    e[6], sm[6] = 0.0, 1.0                        # a run of zero energy
    sm[6, 40:60] = -1.0
    return e.astype(np.float32), sm.astype(np.float32)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps, warm=1):
    """Median device time of fn() in ms (CUDA events around each call, one
    call at a time, so it also counts the host's time to launch it)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_b2b(fn, reps):
    """Mean device time of fn() in ms over `reps` calls issued back to back
    between two CUDA events, after one call: the host's launch time hides
    behind the previous call's work."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes, flops):
    """The least time for the work: bytes at the HBM rate or flops at the
    float32 rate, whichever is longer."""
    tb, to = nbytes / PEAK_BYTES, flops / PEAK_F32
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


# Hopper's issue (an SM: four schedulers, one warp instruction a clock
# each) and its integer ALU pipe (16 lanes a scheduler).  Integer adds and
# multiply-adds may also go down the FMA pipe (IMAD); shifts, funnel
# shifts, logic ops, compares and selects only down the ALU pipe.
ISSUE_A_CLOCK, ALU_A_CLOCK = 128, 64      # thread instructions an SM
ALU_ONLY = {"SHF", "SHL", "SHR", "LOP3", "LOP", "LOP32I", "PRMT", "POPC",
            "FLO", "BMSK", "SGXT", "BREV", "ISETP", "SEL", "IMNMX", "IABS",
            "LEA"}
INT_ANY = ALU_ONLY | {"IADD3", "IADD", "IADD32I", "VIADD", "IMAD", "IMUL",
                      "ISCADD"}


@functools.lru_cache(maxsize=1)
def draws_issue():
    """Kernel I's instructions, from its SASS (`cuobjdump -sass` of the
    built library): those in the span of the vector entry's grid-stride
    loop (one trip: 4 bins of btf1 and of btf2, 8 draws), in all, the
    integer ones and those only the ALU pipe runs; and the card's SMs and
    their highest clock (nvidia-smi)."""
    import re
    import torch
    from signalsmith_stretch_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build._target("draws")[1])],
                          capture_output=True, text=True, check=True).stdout
    fn = [part for part in sass.split("Function : ")[1:]
          if part.startswith("_Z12draws_kernelILi4E")]
    if len(fn) != 1:
        raise SystemExit("draws: the vector entry's SASS not found")
    ins = []                  # (address, opcode, operands)
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?"
                         r"([A-Z][A-Z0-9_.]*)([^;]*);", fn[0]):
        ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = [(int(t.group(1), 16), a) for a, op, rest in ins
             if op.startswith("BRA")
             and (t := re.search(r"0x([0-9a-f]+)", rest))
             and int(t.group(1), 16) < a]
    if not loops:
        raise SystemExit("draws: no backward branch in the SASS")
    lo, hi = max(loops, key=lambda span: span[1] - span[0])
    body = [op.split(".")[0] for a, op, _ in ins
            if lo <= a <= hi and op != "NOP"]
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    return dict(loop=len(body), int_loop=sum(op in INT_ANY for op in body),
                alu_loop=sum(op in ALU_ONLY for op in body), clock_hz=clock,
                sms=torch.cuda.get_device_properties(0).multi_processor_count)


def draws_bound_ms(nbytes, draws, issue):
    """The least time for `draws` draws: the bytes at the HBM rate, or the
    loop's instructions (8 draws a trip) at the SMs' issue rate, or its
    ALU-only ones at the ALU pipe's rate, the longest (draws_issue)."""
    trips = draws / 8
    per_clock = issue["sms"] * issue["clock_hz"]
    to = trips * max(issue["loop"] / ISSUE_A_CLOCK,
                     issue["alu_loop"] / ALU_A_CLOCK) / per_clock
    tb = nbytes / PEAK_BYTES
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def dft_algorithm_flops(fft_samples):
    """Float32 operations per frame of kernel D's own algorithm: the window
    and pre-twist (8 per sample pair), each pass's twiddles (6 per complex
    multiply) and in-register DFTs (radix 2: 4 per butterfly, 6 more for
    each twiddle other than 1 and -i), and the post-combine (18 per band
    pair)."""
    from signalsmith_stretch_torch.ops import dft
    M = fft_samples // 2
    flops = 8 * M + 18 * (M // 2)
    for p, R in enumerate(dft.RADICES[fft_samples.bit_length() - 1]):
        per_dft, length = 0, 2
        while length <= R:
            for k in range(length // 2):
                e = k * (R // length)
                per_dft += (R // length) * (4 + (6 if e and 4 * e != R else 0))
            length *= 2
        flops += (M // R) * (per_dft + (6 * (R - 1) if p else 0))
    return flops


def max_abs(a, b):
    import torch
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return float((a.double() - b.double()).abs().max())


def same_bits(a, b):
    """Equal dtypes, shapes and bits (a float NaN equals its own bits)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def header():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    # full float32 everywhere: no TF32 matmul or convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")


def build_kernels():
    from signalsmith_stretch_torch.ops import _build
    t0 = time.perf_counter()
    report = _build.build()
    for name, (secs, log) in report.items():
        usage = [ln.strip().split("'")[1][:40]
                 if "entry function" in ln else ln.strip()
                 for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "entry function" in ln]
        print(f"built csrc/{name}.cu in {secs:.1f} s: {'; '.join(usage)}")
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(report)} sources")
    for name in _build.SOURCES:
        _build.entry(name)


def tonality_map(controls):
    """The built-in map of scalar controls (its limit, mult and above_off,
    ops/peaks.map_constants) written as a torch callable."""
    import torch
    from signalsmith_stretch_torch.ops import peaks
    limit, mult, above_off = (float(v) for v in
                              peaks.map_constants(controls)[0])

    def tonality(f):
        return torch.where(f > limit, f + above_off, f * mult)
    return tonality


def power_warp(f):
    """A custom map no multiplier expresses: 0.5 (2 f)^0.9 (the warp of
    tests/test_torch_custom_map.py)."""
    return 0.5 * (2 * f) ** 0.9


def _model(cfg, batch, seconds=SECONDS):
    """A cell's StretchModel and its clips.  A `custom_map` entry names the
    cell's callable ("tonality": the built-in map of the cell's controls;
    "power_warp"), set in the flags as SignalsmithStretch.set_freq_map
    sets it: the render is mapped, and formants are processed when
    compensating."""
    import dataclasses
    from signalsmith_stretch_torch.models import StretchModel
    name, time_factor, kw = cfg
    kw = dict(kw)
    custom = kw.pop("custom_map", None)
    in_len = int(RATE * seconds)
    out_len = int(round(in_len * time_factor))
    model = StretchModel.build(channels=2, sample_rate=RATE,
                               in_samples=in_len, out_samples=out_len,
                               device=DEVICE, **kw)
    if custom is not None:
        fn = (tonality_map(model.controls) if custom == "tonality"
              else power_warp)
        flags = model.flags
        model.flags = dataclasses.replace(
            flags, mapped=True, custom_map=fn,
            process_formants=(flags.process_formants
                              or flags.formant_compensation))
    clips = make_corpus(batch, 2, in_len, RATE)
    return model, clips


def mapped_planner():
    """The pitch+12 cell's model, its batch on the card, and its planner's
    sweep inputs and debug tensors (the plain planner on the spectra of
    one analysis through D): the main path's shapes of A, C and G."""
    import torch
    from signalsmith_stretch_torch import engine, ops, planner
    model, clips = _model(MAPPED, BATCH)
    audio = torch.as_tensor(clips, device=DEVICE)
    plan = model.plan
    spectra, prev = engine.analyze_stage(audio, plan)
    with ops.plain():
        inputs, dbg = planner.plan_spectral(spectra, prev, plan.arrays,
                                            model.controls, model.flags,
                                            plan.consts, debug=True)
    torch.cuda.synchronize()
    return model, audio, inputs, dbg


def check_kernels():
    """Phase 3: each kernel against its plain version at the main path's
    shapes.  Returns {name: entry} with the measured numbers."""
    import torch
    from signalsmith_stretch_torch import wavefront
    from signalsmith_stretch_torch.ops import interp

    model, audio, inputs, dbg = mapped_planner()
    plan = model.plan
    entries = {}

    # --- A: interp_multi on G's stacked positions (the main path's call),
    # and on the list form, lerp and taps ----------------------------------
    planes, pos_sets = dbg["interp"]
    pos = dbg["pos"]
    taps_sets = [(p, n, True) for p, n, _ in pos_sets]
    err = 0.0
    for sets, stacked, mode in ((pos_sets, pos, "lerp, stacked positions"),
                                (pos_sets, None, "lerp"),
                                (taps_sets, None, "taps")):
        got, viol = interp.interp_multi(planes, sets, pos=stacked)
        ref, _ = interp.interp_multi_plain(planes, sets)
        for g, r in zip(got, ref):
            g = g if isinstance(g, tuple) else (g,)
            r = r if isinstance(r, tuple) else (r,)
            for gg, rr in zip(g, r):
                e = max_abs(gg, rr)
                err = max(err, e)
                if not torch.equal(gg, rr):
                    raise SystemExit(f"interp_multi ({mode}): kernel differs "
                                     f"from the plain version, max abs {e}")
        if viol != 0:
            raise SystemExit(f"interp_multi: {viol} violations, expected 0")
        print(f"A interp_multi {mode}: planes {tuple(planes.shape)}, "
              f"sets {[(n, t) for _, n, t in sets]}: bit-equal to the plain "
              f"version")
    rows, n, W0 = planes.shape
    B = pos_sets[0][0].shape[1]
    nout = sum(ns for _, ns, _ in pos_sets)
    ms = cuda_ms(lambda: interp.interp_multi(planes, pos_sets, pos=pos),
                 KERNEL_REPS)
    b2b = cuda_ms_b2b(lambda: interp.interp_multi(planes, pos_sets, pos=pos),
                      KERNEL_REPS)
    plain = cuda_ms(lambda: interp.interp_multi_plain(planes, pos_sets), 3)
    nbytes = 4 * (rows * n * W0 + rows * len(pos_sets) * B + rows * nout * B)
    flops = 3 * rows * nout * B + 2 * rows * len(pos_sets) * B
    entries["interp_multi"] = dict(max_abs_err=err, ms=ms, ms_b2b=b2b,
                                   plain_ms=plain,
                                   bound=bound_ms(nbytes, flops))

    entries["iir"] = check_slew_scan(dbg["energy"], plan.consts.slew)
    entries["peaks_map"] = check_peaks_map(dbg["energy"], dbg["smoothed"],
                                           *dbg["shifts"], model, audio)
    entries.update(check_peaks_split(dbg["energy"], dbg["smoothed"],
                                     *dbg["shifts"], model, audio))

    # --- B: the diagonal sweep --------------------------------------------
    longv = plan.consts.long_vertical_step
    got = wavefront.sweep(inputs, longv)
    # the plain sweep takes seconds: its time is the one comparison run,
    # between CUDA events like the other rows' (a median of one)
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    ref = wavefront.sweep_plain(inputs, longv)
    t1.record()
    t1.synchronize()
    plain = t0.elapsed_time(t1)
    err = max_abs(got, ref)
    batch_, nB, Bs = inputs.a1.shape
    ch = len(inputs.pi)
    if not torch.equal(got, ref):
        raise SystemExit(f"sweep: kernel differs from the plain version, max "
                         f"abs {err}")
    threads, sigma, diagonals = wavefront.sweep_schedule(nB, Bs, longv)
    print(f"B sweep: [batch {batch_}, nB {nB}, B {Bs}], ch {ch}, LV {longv}, "
          f"{threads} threads a clip, step {sigma}, {diagonals} dependent "
          f"diagonals: bit-equal to the plain version (plain sweep "
          f"{plain / 1e3:.1f} s)")
    ms = cuda_ms(lambda: wavefront.sweep(inputs, longv), KERNEL_REPS // 4)
    b2b = cuda_ms_b2b(lambda: wavefront.sweep(inputs, longv),
                      KERNEL_REPS // 4)
    cells = batch_ * nB * Bs
    # per cell: a1, a2, d1, d2 (complex), mc, pe and pi per channel in, the
    # outputs per channel out; ~62 flops for two channels
    nbytes = cells * (4 * 8 + 4 + ch * 4 + ch * 8 + ch * 8)
    flops = cells * (30 + 16 * ch)
    bound = bound_ms(nbytes, flops)
    print(f"B sweep: {1e6 * ms / diagonals:.1f} ns a diagonal over "
          f"{diagonals} diagonals ({ms:.3f} ms); bound {bound[0]:.4f} ms "
          f"({bound[1]})")
    entries["sweep"] = dict(max_abs_err=err, ms=ms, ms_b2b=b2b,
                            plain_ms=plain, bound=bound)
    entries["coefficients"] = check_coefficients(dbg["coefficients"])
    del inputs, dbg, audio
    torch.cuda.empty_cache()
    entries["dft"] = check_dft()
    entries.update(check_formant_scans())
    for name, e in entries.items():
        lib = e.get("library_ms")
        print(f"{name}: max abs difference {e['max_abs_err']:g}, kernel "
              f"{e['ms']:.4f} ms a launch alone ({e['ms_b2b']:.4f} ms back "
              f"to back), plain {e['plain_ms']:.1f} ms, bound "
              f"{e['bound'][0]:.4f} ms ({e['bound'][1]}), library: "
              + (f"{lib:.3f} ms" if lib is not None else
                 "none (no single PyTorch call computes it)"))
    return entries


def check_coefficients(args, label="pitch+12"):
    """J against its plain version on a planner's arguments: every output
    bit-equal; timed alone, back to back, and the plain version (its
    PyTorch operations); bound: bytes, each input plane read once and
    each output written once."""
    import torch
    from signalsmith_stretch_torch.ops import coefficients
    got = coefficients.coefficients(*args)
    ref = coefficients.coefficients_plain(*args)
    for name, g, r in zip(("a1", "a2", "d1", "d2", "mc"), got, ref):
        if not torch.equal(g, r):
            raise SystemExit(f"coefficients ({label}): kernel's {name} "
                             f"differs from the plain version, max abs "
                             f"{max_abs(g, r)}")
    pi, _, pe, votes, _, new, longv = args
    batch, nB, B = pe[0].shape
    ch, bins = len(pi), batch * nB * B
    # per bin and channel pi, prev_i and the votes (8 B), pe (4 B); per
    # bin a1, a2, d1, d2 (8 B) and mc (4 B) written; ~70 flops
    nbytes = bins * (ch * (8 * (2 + len(votes)) + 4) + 4 * 8 + 4)
    bound = bound_ms(nbytes, bins * (68 + ch))
    ms = cuda_ms(lambda: coefficients.coefficients(*args), KERNEL_REPS)
    b2b = cuda_ms_b2b(lambda: coefficients.coefficients(*args), KERNEL_REPS)
    plain = cuda_ms(lambda: coefficients.coefficients_plain(*args),
                    PLAIN_REPS)
    print(f"J coefficients ({label}): [batch {batch}, nB {nB}, B {B}], ch "
          f"{ch}, LV {longv}, {len(votes)} vote sets, "
          f"{int((~np.asarray(new)).sum())} blocks not new: bit-equal to "
          f"the plain version; {ms:.4f} ms alone, {b2b:.4f} ms back to "
          f"back, plain {plain:.2f} ms; bound {bound[0]:.4f} ms "
          f"({bound[1]}: {nbytes / 1e9:.3f} GB), {100 * bound[0] / b2b:.0f}% "
          f"of it back to back")
    return dict(max_abs_err=0.0, ms=ms, ms_b2b=b2b, plain_ms=plain,
                bound=bound)


def coefficients_only():
    """J alone (`--coefficients`): bit-equal to its plain version and timed
    on the planner's arguments of pitch+12 and 1.25x, at BATCH clips and at
    the benchmark's 32."""
    import torch
    from signalsmith_stretch_torch import engine, planner
    for cfg in (MAPPED, STRETCH):
        for batch in (BATCH, 32):
            model, clips = _model(cfg, batch)
            audio = torch.as_tensor(clips, device=DEVICE)
            plan = model.plan
            spectra, prev = engine.analyze_stage(audio, plan)
            _, dbg = planner.plan_spectral(spectra, prev, plan.arrays,
                                           model.controls, model.flags,
                                           plan.consts, debug=True)
            check_coefficients(dbg["coefficients"], f"{cfg[0]}, batch {batch}")
            del audio, spectra, prev, dbg
            torch.cuda.empty_cache()


def check_slew_scan(x, slew):
    """C against its plain passes on the pitch+12 render's energy x: the
    smoothing's four passes in one launch and one pass each way, y and the
    final value bit-equal; timed as the four passes, one pass, and the four
    passes on one row."""
    import torch
    from signalsmith_stretch_torch.ops import scan_ops
    R, Bx = x.shape
    init = torch.zeros(R, dtype=torch.float32, device=DEVICE)
    err = 0.0
    for what, dirs in (("smoothing chain", SMOOTHING),
                       ("backward", (True,)), ("forward", (False,))):
        y, fin = scan_ops.iir_chain(x, init, slew, dirs)
        yp, finp = scan_ops.iir_chain_plain(x, init, slew, dirs)
        err = max(err, max_abs(y, yp), max_abs(fin, finp))
        if not (torch.equal(y, yp) and torch.equal(fin, finp)):
            raise SystemExit(f"iir_chain ({what}): kernel differs from the "
                             f"plain version, max abs {err}")
        print(f"C iir_chain {what} ({len(dirs)} passes): {tuple(x.shape)}: "
              f"y and final bit-equal to the plain version")
    def chain(rows):
        return lambda: scan_ops.iir_chain(x[:rows], init[:rows], slew,
                                          SMOOTHING)
    ms, b2b = cuda_ms(chain(R), KERNEL_REPS), cuda_ms_b2b(chain(R),
                                                          KERNEL_REPS)
    floor, floor_b2b = cuda_ms(chain(1), KERNEL_REPS), cuda_ms_b2b(
        chain(1), KERNEL_REPS)
    one = cuda_ms(lambda: scan_ops.iir(x, init, slew), KERNEL_REPS)
    plain = cuda_ms(lambda: scan_ops.iir_chain_plain(x, init, slew,
                                                     SMOOTHING), PLAIN_REPS)
    # the chain reads the plane once and writes it once
    bound = bound_ms(4 * (2 * R * Bx + 2 * R), 3 * len(SMOOTHING) * R * Bx)
    print(f"C iir_chain: {len(SMOOTHING)} passes in {ms:.4f} ms a launch "
          f"alone, {b2b:.4f} ms back to back "
          f"({1e3 * b2b / len(SMOOTHING):.1f} us a pass); one pass "
          f"{one:.4f} ms; one row (the serial floor) {floor:.4f} ms alone, "
          f"{floor_b2b:.4f} ms back to back; bound {bound[0]:.4f} ms "
          f"({bound[1]}), {1e-6 * 4 * 2 * R * Bx * len(SMOOTHING) / b2b:.0f} "
          f"GB/s of pass traffic back to back")
    return dict(max_abs_err=err, ms=ms, ms_b2b=b2b, plain_ms=plain,
                bound=bound, chain_ms=floor)


def index_put_slots_differing(energy, smoothed):
    """The peaks map's two run sums (of b*energy and of energy), taken by
    the card's own `index_put_` with accumulate under deterministic
    algorithms, against spectral._segment_sums, which adds each run
    bin-ascending (on a CPU copy): the number of run slots whose sums differ
    in any bit.  The runs are built as spectral._peaks_and_map builds
    them."""
    import torch
    import torch.nn.functional as F
    from signalsmith_stretch_torch import spectral
    R, B = energy.shape
    nseg = B // 2 + 2
    above = energy > smoothed
    start = above & ~F.pad(above[:, :-1], (1, 0), value=False)
    seg = torch.where(above, torch.cumsum(start.to(torch.int64), 1) - 1,
                      nseg - 1)
    flat = (torch.arange(R, device=energy.device)[:, None] * nseg
            + seg).reshape(-1)
    b_idx = torch.arange(B, dtype=torch.float32, device=energy.device)
    differ = torch.zeros(R * nseg, dtype=torch.bool)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for v in ((b_idx * energy).reshape(-1), energy.reshape(-1)):
            card = torch.zeros(R * nseg, device=energy.device).index_put_(
                (flat,), v, accumulate=True).cpu()
            ref = spectral._segment_sums(flat, v, R * nseg).cpu()
            differ |= card.view(torch.int32) != ref.view(torch.int32)
    finally:
        torch.use_deterministic_algorithms(was)
    differ = differ.reshape(R, nseg)[:, :-1]     # the sink slot is not read
    return int(differ.sum())


def phase_split(stamps_fn, phases, R, what, reps=5):
    """Summarise a timed entry's stamps (stamps_fn() -> [CTAs, len(phases)
    + 3] int64 on the card: each phase's clock64() cycles summed over the
    CTA's rows, its start and end on the global timer in ns, its SM) over
    R rows, the run of `reps` with the median span: for each phase the
    share of the CTAs' cycles and the mean cycles a row; the kernel's span,
    the mean lifetime of a CTA, the mean number of CTAs resident (their
    lifetimes over the span), how far apart the CTAs start and how far
    apart they end, and the SM clock the stamps imply.  Prints
    them after `what` and returns them as a dict."""
    import torch
    P = len(phases)
    runs = []
    for _ in range(reps + 1):                      # the first one warms up
        runs.append(stamps_fn().cpu().numpy().astype(np.float64))
    spans = [r[:, P + 1].max() - r[:, P].min() for r in runs[1:]]
    st = runs[1 + int(np.argsort(spans)[len(spans) // 2])]
    cyc = st[:, :P]
    life = st[:, P + 1] - st[:, P]
    span = st[:, P + 1].max() - st[:, P].min()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = dict(zip(phases, (cyc.sum(0) / cyc.sum()).tolist()))
    out = dict(phases=split,
               cycles_a_row={k: float(v) for k, v in
                             zip(phases, cyc.sum(0) / R)},
               span_us=span / 1e3, cta_us=float(life.mean()) / 1e3,
               ctas=int(st.shape[0]), resident=float(life.sum() / span),
               ghz=float(cyc.sum() / life.sum()),
               starts_us=float(np.ptp(st[:, P])) / 1e3,
               ends_us=float(np.ptp(st[:, P + 1])) / 1e3)
    print(f"{what} ({R} rows, {out['ctas']} CTAs, timed entry): " + ", ".join(
        f"{k} {100 * v:.1f}% ({out['cycles_a_row'][k]:.0f} cycles a row)"
        for k, v in split.items())
          + f"; span {out['span_us']:.1f} us, a CTA lives "
          f"{out['cta_us']:.2f} us, {out['resident']:.1f} CTAs resident on "
          f"average ({out['resident'] / sms:.2f} an SM of {sms}), the CTAs "
          f"starting within {out['starts_us']:.2f} us and ending within "
          f"{out['ends_us']:.2f} us, clock {out['ghz']:.2f} GHz")
    return out


def peaks_phase_split(energy, smoothed, tf, ltf, controls, consts, reps=5):
    """G's timed entry (csrc/peaks.cu STAMP, never on the main path) on the
    given rows, summarised by phase_split."""
    from signalsmith_stretch_torch.ops import peaks
    return phase_split(
        lambda: peaks.phase_stamps(energy, smoothed, tf, ltf, controls,
                                   consts),
        peaks.PHASES, energy.shape[0],
        f"G phase split {tuple(energy.shape)}", reps)


def profiled(fn):
    """Run fn() once under torch.profiler between two synchronises.
    Returns (result, wall ms, profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return out, wall, prof


def profiler_events(prof, kind):
    """The profiler's events on the "CUDA" or "CPU" side."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if e.device_type == getattr(DeviceType, kind)]


def render_kernel_ms(model, audio, kernel):
    """Device ms of the kernels whose name holds `kernel` in one render of
    audio by model, under torch.profiler (after one render to warm up)."""
    model.batched(audio)
    _, _, prof = profiled(lambda: model.batched(audio))
    return sum(e.time_range.elapsed_us() for e in profiler_events(prof, "CUDA")
               if kernel in e.name) / 1e3


def check_peaks_map(energy, smoothed, tf, ltf, model, audio):
    """G on the pitch+12 render's energy, smoothed curve and time factors,
    and on the edge rows of peaks_edge_rows at B = 512, 1000, 4096 and 8192
    (the 96 kHz preset's bands): its four planes (the position sets input
    bin, input bin - tf and input bin - ltf, and freq_grad) bit-equal to
    the plain version on a CPU copy of the inputs (each run summed
    bin-ascending, the order of the reference and of the JAX package on the
    CPU) and to the plain version on the card.  Reports in how many run
    slots the card's own index_put_ sums differ from the bin-ascending
    ones; times G alone, back to back and inside a render, and the plain
    version; splits G's time by phase (its timed entry)."""
    import torch
    from signalsmith_stretch_torch.ops import peaks
    controls, consts = model.controls, model.plan.consts
    R, B = energy.shape
    cases = [("pitch+12 planner inputs", energy, smoothed, tf, ltf)]
    for width in (512, 1000, 4096, 8192):
        e, s = (torch.as_tensor(a, device=DEVICE)
                for a in peaks_edge_rows(width))
        cases.append((f"edge rows at B = {width}", e, s, tf[:e.shape[0]],
                       ltf[:e.shape[0]]))
    planes = ("input bin", "input bin - tf", "input bin - ltf", "freq_grad")
    err = 0.0
    for what, e, s, t1, t2 in cases:
        args = (controls, consts)
        got = peaks.peaks_positions(e, s, t1, t2, *args)
        cpu = peaks.peaks_positions_plain(e.cpu(), s.cpu(), t1.cpu(),
                                          t2.cpu(), *args)
        card = peaks.peaks_positions_plain(e, s, t1, t2, *args)
        for name, g, c, p in zip(planes, [*got[0].unbind(1), got[1]],
                                 [*cpu[0].unbind(1), cpu[1]],
                                 [*card[0].unbind(1), card[1]]):
            err = max(err, max_abs(g.cpu(), c))
            if not same_bits(g.cpu(), c):
                raise SystemExit(f"peaks_map ({what}): {name} differs from "
                                 f"the plain version on the CPU, max abs "
                                 f"{max_abs(g.cpu(), c)}")
            if not same_bits(g, p):
                raise SystemExit(f"peaks_map ({what}): {name} differs from "
                                 f"the plain version on the card, max abs "
                                 f"{max_abs(g, p)}")
        print(f"G peaks_map {what}: {tuple(e.shape)}: the four planes "
              f"bit-equal to the plain version on the CPU and on the card; "
              f"the card's own index_put_ run sums differ from the "
              f"bin-ascending sums in {index_put_slots_differing(e, s)} of "
              f"{e.shape[0] * (e.shape[1] // 2 + 1)} run slots (the plain "
              f"version sums on a CPU copy)")

    args = (energy, smoothed, tf, ltf, controls, consts)
    split = peaks_phase_split(*args)
    ms = cuda_ms(lambda: peaks.peaks_positions(*args), KERNEL_REPS)
    b2b = cuda_ms_b2b(lambda: peaks.peaks_positions(*args), KERNEL_REPS)
    in_render = render_kernel_ms(model, audio, "peaks_map_kernel")
    plain = cuda_ms(lambda: peaks.peaks_positions_plain(*args), PLAIN_REPS)
    # two inputs read and four planes written once; the run sums' multiply
    # and two adds for each bin above its curve, at most 17 flops a bin for
    # the map and two subtractions
    n_above = int((energy > smoothed).sum())
    bound = bound_ms(24 * R * B, 3 * n_above + 19 * R * B)
    two_planes = bound_ms(16 * R * B, 3 * n_above + 17 * R * B)
    print(f"G peaks_map: {ms:.4f} ms a launch alone, {b2b:.4f} ms back to "
          f"back, {in_render:.4f} ms of device time in a pitch+12 render; "
          f"plain {plain:.3f} ms; bound {bound[0]:.4f} ms ({bound[1]}: four "
          f"planes out; two planes out, {two_planes[0]:.4f}); "
          f"{n_above} of {R * B} bins above their curve")
    return dict(max_abs_err=err, ms=ms, ms_b2b=b2b, plain_ms=plain,
                bound=bound, render_ms=in_render, phases=split["phases"])


def split_bounds(energy, smoothed, n_valid, nB):
    """The least time of G's runs entry and out entry on these rows (R, B
    from energy; n_valid peaks; nB blocks): {name: (ms, "bytes" or
    "operations")}."""
    R, B = energy.shape
    nseg = B // 2 + 2
    n_above = int((energy > smoothed).sum())
    return {
        # two planes read, two [R, nseg] planes and the counts written;
        # the run sums' multiply and two adds a bin, 3 flops a peak
        "peaks_runs": bound_ms(4 * (2 * R * B + 2 * R * nseg + R),
                               3 * n_above + 3 * n_valid),
        # the valid slots of peak_in and mapped, the counts and the shifts
        # read, four planes written
        "peaks_out": bound_ms(4 * (2 * n_valid + R + 2 * nB + 4 * R * B),
                              5 * n_valid + 19 * R * B)}


def check_peaks_split(energy, smoothed, tf, ltf, model, audio):
    """G split around a custom map, on the pitch+12 render's planner inputs
    and on the edge rows of peaks_edge_rows at B = 512, 1000, 4096 and
    8192: the runs entry (peak_in, avg_freq, n_peaks) bit-equal to its
    plain version on a CPU copy and on the card; the out entry on the
    runs' outputs through pitch+12's map written as a callable, bit-equal
    to its plain version on a CPU copy and on the card, also with NaN in
    every invalid slot; the two entries around that callable give the
    one-launch G's four planes.  Times each entry alone, back to back and
    inside a render of the custom tonality cell, its plain version, and
    the callable; splits each by phase (their timed entries) and reads its
    CTAs resident an SM and its registers a thread.  Returns {name:
    entry}."""
    import torch
    from signalsmith_stretch_torch.ops import peaks
    controls, consts = model.controls, model.plan.consts
    fn = tonality_map(controls)
    cases = [("pitch+12 planner inputs", energy, smoothed, tf, ltf)]
    for width in (512, 1000, 4096, 8192):
        e, s = (torch.as_tensor(a, device=DEVICE)
                for a in peaks_edge_rows(width))
        cases.append((f"edge rows at B = {width}", e, s, tf[:e.shape[0]],
                       ltf[:e.shape[0]]))
    err_runs = err_out = 0.0
    for what, e, s, t1, t2 in cases:
        B = e.shape[1]
        runs = peaks.peak_runs(e, s, consts)
        for where, want in (("CPU", peaks.peak_runs_plain(e.cpu(), s.cpu(),
                                                          consts)),
                            ("card", peaks.peak_runs_plain(e, s, consts))):
            for name, g, w in zip(("peak_in", "avg_freq", "n_peaks"), runs,
                                  want):
                if g.dtype == torch.float32:
                    err_runs = max(err_runs, max_abs(g.cpu(), w.cpu()))
                if not same_bits(g.cpu(), w.cpu()):
                    raise SystemExit(f"peaks_runs ({what}): {name} differs "
                                     f"from the plain version on the "
                                     f"{where}")
        peak_in, avg_freq, n_peaks = runs
        mapped = fn(avg_freq)
        invalid = (torch.arange(peak_in.shape[1], device=DEVICE)[None]
                   >= n_peaks[:, None])
        nan = torch.where(invalid, torch.full_like(mapped, float("nan")),
                          mapped)
        got = peaks.output_positions(peak_in, mapped, n_peaks, t1, t2, B,
                                     consts)
        cpu = peaks.output_positions_plain(
            peak_in.cpu(), mapped.cpu(), n_peaks.cpu(), t1.cpu(), t2.cpu(),
            B, consts)
        card = peaks.output_positions_plain(peak_in, mapped, n_peaks, t1,
                                            t2, B, consts)
        with_nan = peaks.output_positions(peak_in, nan, n_peaks, t1, t2, B,
                                          consts)
        one = peaks.peaks_positions(e, s, t1, t2, controls, consts)
        for g, c, p, x, o in zip(got, cpu, card, with_nan, one):
            err_out = max(err_out, max_abs(g.cpu(), c))
            if not (same_bits(g.cpu(), c) and same_bits(g, p)):
                raise SystemExit(f"peaks_out ({what}): differs from the "
                                 f"plain version, max abs "
                                 f"{max_abs(g.cpu(), c)}")
            if not same_bits(x, g):
                raise SystemExit(f"peaks_out ({what}): NaN in the invalid "
                                 f"slots changed the output")
            if not same_bits(o, g):
                raise SystemExit(f"peaks_out ({what}): the split G differs "
                                 f"from the one-launch G")
        print(f"G split {what}: {tuple(e.shape)}: runs entry bit-equal to "
              f"its plain version on the CPU and on the card "
              f"({int(n_peaks.sum())} peaks); out entry bit-equal to its "
              f"plain version on the CPU and on the card, unchanged by NaN "
              f"in the invalid slots, and the split equal to the one-launch "
              f"G in all four planes")

    R, B = energy.shape
    nseg = B // 2 + 2
    runs = peaks.peak_runs(energy, smoothed, consts)
    peak_in, avg_freq, n_peaks = runs
    mapped = fn(avg_freq)
    out_args = (peak_in, mapped, n_peaks, tf, ltf, B, consts)
    splits = {
        "peaks_runs": phase_split(
            lambda: peaks.runs_stamps(energy, smoothed, consts),
            peaks.RUNS_PHASES, R, f"G runs entry phase split {(R, B)}"),
        "peaks_out": phase_split(lambda: peaks.out_stamps(*out_args),
                                 peaks.OUT_PHASES, R,
                                 f"G out entry phase split {(R, B)}")}
    occupancy = peaks.split_occupancy(B)
    custom_model, _ = _model(CUSTOM_TONALITY, BATCH)
    in_render = {k: render_kernel_ms(custom_model, audio, f"{k}_kernel")
                 for k in ("peaks_runs", "peaks_out")}
    n_valid = int(n_peaks.sum())
    bounds = split_bounds(energy, smoothed, n_valid, tf.shape[0])
    entries = {}
    for name, call, plain, err in (
            ("peaks_runs", lambda: peaks.peak_runs(energy, smoothed, consts),
             lambda: peaks.peak_runs_plain(energy, smoothed, consts),
             err_runs),
            ("peaks_out", lambda: peaks.output_positions(*out_args),
             lambda: peaks.output_positions_plain(*out_args), err_out)):
        entries[name] = dict(
            max_abs_err=err, ms=cuda_ms(call, KERNEL_REPS),
            ms_b2b=cuda_ms_b2b(call, KERNEL_REPS),
            plain_ms=cuda_ms(plain, PLAIN_REPS), bound=bounds[name],
            render_ms=in_render[name], phases=splits[name]["phases"],
            ctas_per_sm=occupancy[name][0], registers=occupancy[name][1])
    callable_ms = cuda_ms(lambda: fn(avg_freq), KERNEL_REPS)
    custom_ms = cuda_ms(lambda: peaks.peaks_positions_custom(
        energy, smoothed, tf, ltf, fn, consts), KERNEL_REPS)
    one_ms = cuda_ms(lambda: peaks.peaks_positions(
        energy, smoothed, tf, ltf, controls, consts), KERNEL_REPS)
    for name, e in entries.items():
        print(f"G {name}: {e['ms']:.4f} ms a launch alone, "
              f"{e['ms_b2b']:.4f} ms back to back, {e['render_ms']:.4f} ms "
              f"of device time in a {CUSTOM_TONALITY[0]} render; plain "
              f"{e['plain_ms']:.3f} ms; bound {e['bound'][0]:.4f} ms "
              f"({e['bound'][1]}); {e['ctas_per_sm']} CTAs resident an SM, "
              f"{e['registers']} registers a thread")
    print(f"G split around the callable: runs + callable + out "
          f"{custom_ms:.4f} ms (the callable alone on [{R}, {nseg}] "
          f"{callable_ms:.4f} ms), the one-launch G {one_ms:.4f} ms, each a "
          f"call alone; {n_valid} peaks in {R} rows")
    return entries


def analysis_frames(cfg):
    """The main and re-analysis frames one render of cfg analyses, as one
    contiguous [frames, block] tensor on the card, and the STFT basis."""
    import torch
    from signalsmith_stretch_torch import engine
    model, clips = _model(cfg, BATCH)
    plan = model.plan
    audio = torch.as_tensor(clips, device=DEVICE)
    starts = np.concatenate([plan.frame_idx[:, 0], plan.re_frame_idx[:, 0]])
    frames = engine.gather_frames(engine._build_timeline(audio, plan), starts,
                                  plan.cfg.block_samples)
    return frames.reshape(-1, plan.cfg.block_samples).contiguous(), plan.basis


def check_dft():
    """D against the plain analysis (cuFFT) on the 1.25x render's main and
    re-analysis frames.  The library call is torch.fft.fft of the same
    frames windowed, padded and twisted.  D is also timed on the 1.0x
    renders' frames, for its cost per frame at two frame counts."""
    import torch
    import torch.nn.functional as F
    from signalsmith_stretch_torch import stft
    from signalsmith_stretch_torch.ops import dft

    frames, basis = analysis_frames(MAPPED)
    ms_1x = cuda_ms(lambda: dft.analyze(frames, basis), KERNEL_REPS)
    nF_1x = frames.shape[0]
    del frames
    frames, basis = analysis_frames(STRETCH)
    got = dft.analyze(frames, basis)
    ref = stft.analyze_plain(frames, basis)
    err = max_abs(got, ref)
    peak = float(ref.abs().max())
    if not err <= DFT_TOL * peak:
        raise SystemExit(f"dft: kernel differs from the plain analysis by "
                         f"{err:g}, {err / peak:.3g} of the peak {peak:g} "
                         f"(tolerance {DFT_TOL:g})")
    nF, block = frames.shape
    print(f"D dft: frames [{nF}, {block}] -> [{nF}, {basis.bands}] complex64: "
          f"max abs difference {err:g} = {err / peak:.3g} of the peak "
          f"(tolerance {DFT_TOL:g})")
    ms = cuda_ms(lambda: dft.analyze(frames, basis), KERNEL_REPS)
    b2b = cuda_ms_b2b(lambda: dft.analyze(frames, basis), KERNEL_REPS)
    plain = cuda_ms(lambda: stft.analyze_plain(frames, basis), KERNEL_REPS)
    z = F.pad(frames * torch.as_tensor(basis.window, device=DEVICE),
              (0, basis.fft_samples - block)) * torch.as_tensor(
                  basis.twist, device=DEVICE)
    lib = cuda_ms(lambda: torch.fft.fft(z, dim=-1), KERNEL_REPS)
    del z, got, ref, frames
    torch.cuda.empty_cache()
    # the function's operations: a real FFT of N points, 5/2 N log2 N flops
    # (the window multiply is a rounding error beside it)
    N = basis.fft_samples
    flops = nF * 5 * N * (N.bit_length() - 1) // 2
    nbytes = nF * (4 * block + 8 * basis.bands)
    bound = bound_ms(nbytes, flops)
    # the kernel's own algorithm, for comparison only: window and pre-twist,
    # the passes' twiddles and in-register DFTs, the post-combine
    algo_flops = nF * dft_algorithm_flops(N)
    print(f"D dft: {1e6 * ms / nF:.1f} ns a frame at {nF} frames (1.25x, "
          f"{ms:.3f} ms), {1e6 * ms_1x / nF_1x:.1f} ns a frame at {nF_1x} "
          f"(1.0x, {ms_1x:.3f} ms); bound {bound[0]:.4f} ms ({bound[1]}: "
          f"{nbytes / 1e9:.3f} GB at {1e-6 * nbytes / ms:.0f} GB/s "
          f"achieved, {flops / 1e9:.2f} GFLOP as an FFT); plan "
          f"{dft.RADICES[N.bit_length() - 1]}: {algo_flops / 1e9:.2f} GFLOP "
          f"of its own, {1e3 * algo_flops / PEAK_F32:.3f} ms at the float32 "
          f"peak, {algo_flops / ms / 1e9:.1f} TFLOP/s achieved")
    return dict(max_abs_err=err, ms=ms, ms_b2b=b2b, plain_ms=plain,
                library_ms=lib, bound=bound)


def synthesis_inputs(cfg, batch):
    """The sweep's outputs of one render of cfg on `batch` clips, every
    fourth clip all zeros (the benchmark's gated clips: the silence bypass
    takes them), with the model and the clips on the card."""
    import torch
    from signalsmith_stretch_torch import engine, planner, wavefront
    model, clips = _model(cfg, batch)
    clips[3::4] = 0
    plan = model.plan
    audio = torch.as_tensor(clips, device=DEVICE)
    spectra, prev = engine.analyze_stage(audio, plan)
    inputs = planner.plan_spectral(spectra, prev, plan.arrays, model.controls,
                                   model.flags, plan.consts)
    specs = wavefront.sweep(inputs, plan.consts.long_vertical_step)
    return model, audio, specs


def check_synthesis(batches=(BATCH,)):
    """K and L at the three benchmark configurations' shapes (1.25x,
    pitch+12, 3x), on a render's own sweep outputs: K within 3e-6 of the
    blocks' peak of the plain synthesis (cuFFT on a padded copy), L bit-equal
    to the plain assembly on K's blocks, with the bypass (on the zeroed
    clips) and without; each timed alone and back to back beside its byte
    bound, its plain version and, for K, torch.fft.ifft of the padded
    spectra; K and L together (the stage, with L's energy sums) against the
    plain stage.  Returns {"idft": entry, "ola": entry} of the 3x cell at
    the first batch, each with every cell's numbers under "cells"."""
    import torch
    import torch.nn.functional as F
    from signalsmith_stretch_torch import engine, ops, stft
    from signalsmith_stretch_torch.ops import idft, ola
    cells = {"idft": {}, "ola": {}}
    for batch in batches:
        for cfg in (STRETCH, MAPPED, RANDOM):
            model, audio, specs = synthesis_inputs(cfg, batch)
            plan, basis = model.plan, model.plan.basis
            label = f"{cfg[0]}, batch {batch}"
            got = idft.synthesize(specs, basis)
            ref = stft.synthesize(specs, basis)
            err = max_abs(got, ref)
            peak = float(ref.abs().max())
            if not err <= DFT_TOL * peak:
                raise SystemExit(f"idft ({label}): kernel differs from the "
                                 f"plain synthesis by {err:g}, "
                                 f"{err / peak:.3g} of the peak {peak:g}")
            del ref
            for a in (audio, None):
                if not same_bits(ola.assemble(got, plan, a),
                                 ola.assemble_plain(got, plan, a)):
                    raise SystemExit(f"ola ({label}, bypass "
                                     f"{'on' if a is not None else 'off'}):"
                                     f" kernel differs from the plain "
                                     f"assembly on K's blocks")
            nF, N = got.numel() // basis.block_samples, basis.fft_samples
            k_bytes = nF * (8 * basis.bands + 4 * basis.block_samples)
            out_bytes = 4 * audio.shape[0] * 2 * plan.sched.out_samples
            l_bytes = 4 * got.numel() + out_bytes + 4 * audio.numel()
            k_flops = nF * 5 * N * (N.bit_length() - 1) // 2
            reps = KERNEL_REPS // 4 if batch > BATCH else KERNEL_REPS
            k = dict(max_abs_err=err, peak=peak, frames=nF,
                     ms=cuda_ms(lambda: idft.synthesize(specs, basis), reps),
                     ms_b2b=cuda_ms_b2b(
                         lambda: idft.synthesize(specs, basis), reps),
                     plain_ms=cuda_ms(lambda: stft.synthesize(specs, basis),
                                      PLAIN_REPS),
                     bound=bound_ms(k_bytes, k_flops))
            padded = F.pad(specs, (0, N - basis.bands))
            k["library_ms"] = cuda_ms(lambda: torch.fft.ifft(padded, dim=-1),
                                      reps)
            del padded
            l_ = dict(max_abs_err=0.0, out_samples=plan.sched.out_samples,
                      ms=cuda_ms(lambda: ola.assemble(got, plan, audio),
                                 reps),
                      ms_b2b=cuda_ms_b2b(
                          lambda: ola.assemble(got, plan, audio), reps),
                      plain_ms=cuda_ms(
                          lambda: ola.assemble_plain(got, plan, audio),
                          PLAIN_REPS),
                      bound=bound_ms(l_bytes, 0))
            del got
            stage_ms = cuda_ms(
                lambda: engine.synthesis_stage(specs, plan, audio=audio),
                reps)
            stage_b2b = cuda_ms_b2b(
                lambda: engine.synthesis_stage(specs, plan, audio=audio),
                reps)
            with ops.plain():
                plain_stage = cuda_ms(
                    lambda: engine.synthesis_stage(specs, plan, audio=audio),
                    PLAIN_REPS)
            both = bound_ms(k_bytes + l_bytes, k_flops)
            l_.update(stage_ms=stage_ms, stage_b2b=stage_b2b,
                      plain_stage_ms=plain_stage, stage_bound_ms=both[0])
            for name, e, nbytes in (("idft", k, k_bytes),
                                    ("ola", l_, l_bytes)):
                share = 100 * e["bound"][0] / e["ms_b2b"]
                print(f"{'K' if name == 'idft' else 'L'} {name} ({label}): "
                      f"{e['ms']:.4f} ms alone, {e['ms_b2b']:.4f} back to "
                      f"back, bound {e['bound'][0]:.4f} ms ({e['bound'][1]}: "
                      f"{nbytes / 1e9:.3f} GB, {share:.1f}% of it back to "
                      f"back), plain {e['plain_ms']:.3f} ms"
                      + (f", torch.fft.ifft of the padded spectra "
                         f"{e['library_ms']:.3f} ms; max abs difference "
                         f"{err:g} = {err / peak:.3g} of the peak"
                         if name == "idft" else
                         ", bit-equal to the plain assembly on K's blocks"))
                cells[name][label] = e
            print(f"K and L ({label}): the stage {stage_ms:.4f} ms alone, "
                  f"{stage_b2b:.4f} back to back, bound {both[0]:.4f} ms "
                  f"({100 * both[0] / stage_b2b:.1f}%), the plain stage "
                  f"(cuFFT on a padded copy, ~50 operations) "
                  f"{plain_stage:.3f} ms")
            del specs, audio, model
            torch.cuda.empty_cache()
    first = f"{RANDOM[0]}, batch {batches[0]}"
    return {name: dict(cells[name][first], cells={
        label: {k: v for k, v in e.items() if k != "bound"}
        | {"bound_ms": e["bound"][0], "bound_by": e["bound"][1]}
        for label, e in cells[name].items()}) for name in cells}


def check_formant_scans():
    """E (the envelope's eight decay passes in one launch, and each single
    pass) and F (the top-3 scan) against their plain loops, on the
    auto-base formant render's metric and decay."""
    import torch
    from signalsmith_stretch_torch import engine, planner, spectral
    from signalsmith_stretch_torch.ops import scan_ops

    model, clips = _model(FORMANT_AUTO, BATCH)
    plan = model.plan
    audio = torch.as_tensor(clips, device=DEVICE)
    spectra, prev = engine.analyze_stage(audio, plan)
    _, dbg = planner.plan_spectral(spectra, prev, plan.arrays, model.controls,
                                   model.flags, plan.consts, debug=True)
    del spectra, prev, audio
    x = dbg["metric"]
    R, B = x.shape
    decay = 1 - 1 / (dbg["freq_estimate"] * 0.5 + 1)
    inv_decay = 1 / decay
    init = torch.zeros(R, dtype=torch.float32, device=DEVICE)

    def envelope(d, inv):     # the planner's eight passes
        return [(c, m, b) for c, m in ((d, False), (inv, True))
                for _ in range(2) for b in (True, False)]

    passes = envelope(decay, inv_decay)
    cases = [("envelope chain", passes)] + [
        (f"decay_{'min' if m else 'max'}_{'backward' if b else 'forward'}",
         [(c, m, b)]) for c, m, b in passes[:2] + passes[4:6]]
    err = 0.0
    for what, ps in cases:
        y, fin = scan_ops.decay_chain(x, init, ps)
        yp, finp = scan_ops.decay_chain_plain(x, init, ps)
        err = max(err, max_abs(y, yp), max_abs(fin, finp))
        if not (torch.equal(y, yp) and torch.equal(fin, finp)):
            raise SystemExit(f"{what}: kernel differs from the plain "
                             f"version, max abs {err}")
        print(f"E {what} ({len(ps)} passes): {tuple(x.shape)}: y and final "
              f"bit-equal to the plain version")
    def chain(rows):
        ps = envelope(decay[:rows], inv_decay[:rows])
        return lambda: scan_ops.decay_chain(x[:rows], init[:rows], ps)
    ms, b2b = cuda_ms(chain(R), KERNEL_REPS), cuda_ms_b2b(chain(R),
                                                          KERNEL_REPS)
    floor, floor_b2b = cuda_ms(chain(1), KERNEL_REPS), cuda_ms_b2b(
        chain(1), KERNEL_REPS)
    one = cuda_ms(lambda: scan_ops.decay(x, init, decay, False), KERNEL_REPS)
    plain = cuda_ms(lambda: scan_ops.decay_chain_plain(x, init, passes),
                    PLAIN_REPS)
    bound = bound_ms(4 * (2 * R * B + 4 * R), 2 * len(passes) * R * B)
    print(f"E decay_chain: {len(passes)} passes in {ms:.4f} ms a launch "
          f"alone, {b2b:.4f} ms back to back "
          f"({1e3 * b2b / len(passes):.1f} us a pass); one pass {one:.4f} "
          f"ms; one row (the serial floor) {floor:.4f} ms alone, "
          f"{floor_b2b:.4f} ms back to back; bound {bound[0]:.4f} ms "
          f"({bound[1]}), {1e-6 * 4 * 2 * R * B * len(passes) / b2b:.0f} "
          f"GB/s of pass traffic back to back")
    entries = {"decay": dict(max_abs_err=err, ms=ms, ms_b2b=b2b,
                             plain_ms=plain, bound=bound, chain_ms=floor)}

    got = scan_ops.top3_local_maxima(x)
    ref = spectral._top3_local_maxima(x)
    err = max(max_abs(g.float(), r.float()) for g, r in zip(got, ref))
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise SystemExit(f"top3: kernel differs from the plain version, max "
                         f"abs {err}")
    print(f"F top3: {tuple(x.shape)} -> 6 x [{R}]: bit-equal to the plain "
          f"version")
    corners = top3_corner_rows()
    for m in corners:
        mt = torch.as_tensor(m, device=DEVICE)
        got = scan_ops.top3_local_maxima(mt)
        ref = spectral._top3_local_maxima(mt)
        if not all(same_bits(g, r) for g, r in zip(got, ref)):
            raise SystemExit(f"top3: kernel differs from the plain version "
                             f"on the corner rows {m.shape}")
    print(f"F top3 corner rows at B = "
          f"{', '.join(str(m.shape[1]) for m in corners)}: bit-equal to the "
          f"plain version (NaN for NaN, -0.0 for -0.0)")
    entries["top3"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: scan_ops.top3_local_maxima(x), KERNEL_REPS),
        ms_b2b=cuda_ms_b2b(lambda: scan_ops.top3_local_maxima(x),
                           KERNEL_REPS),
        plain_ms=cuda_ms(lambda: spectral._top3_local_maxima(x), PLAIN_REPS,
                         warm=0),
        bound=bound_ms(4 * (R * B + 6 * R), 6 * R * B),
        chain_ms=cuda_ms(lambda: scan_ops.top3_local_maxima(x[:1]),
                         KERNEL_REPS))
    print(f"F top3: {entries['top3']['ms']:.4f} ms, one row (the serial "
          f"floor) {entries['top3']['chain_ms']:.4f} ms")
    del dbg, x
    torch.cuda.empty_cache()
    return entries


def counters():
    from signalsmith_stretch_torch import wavefront
    from signalsmith_stretch_torch.ops import (block_sweep, coefficients,
                                               dft, draws, idft, interp, ola,
                                               peaks, scan_ops)
    return {"interp_multi": interp.launches, "sweep": wavefront.launches,
            "iir": scan_ops.launches, "dft": dft.launches,
            "decay": scan_ops.decay_launches,
            "top3": scan_ops.top3_launches, "peaks_map": peaks.launches,
            "peaks_runs": peaks.runs_launches,
            "peaks_out": peaks.out_launches,
            "block_sweep": block_sweep.launches, "draws": draws.launches,
            "coefficients": coefficients.launches, "idft": idft.launches,
            "ola": ola.launches}


def reset_counters():
    from signalsmith_stretch_torch import wavefront
    from signalsmith_stretch_torch.ops import (block_sweep, coefficients,
                                               dft, draws, idft, interp, ola,
                                               peaks, scan_ops)
    interp.launches = wavefront.launches = scan_ops.launches = 0
    dft.launches = scan_ops.decay_launches = scan_ops.top3_launches = 0
    peaks.launches = peaks.runs_launches = peaks.out_launches = 0
    block_sweep.launches = draws.launches = coefficients.launches = 0
    idft.launches = ola.launches = 0


def is_random(plan):
    """Whether a plan stretches some block above 2x (randomised phases)."""
    return bool((np.maximum(plan.arrays["time_factor"], np.float32(0.5))
                 > np.float32(2)).any())


def expected_launches(flags, random=False):
    """Kernel launches of one render: D and B always; A when mapped (the
    lookups and votes at G's positions) or above 2x (the votes at the
    drawn positions); the slew smoothing's four passes in one launch of C
    and the peaks map (G) when mapped; the envelope's eight decay passes in
    one launch of E for formants; with the base estimated, the top-3 scan
    (F) and the two freqEstimate chains over blocks, stacked in one launch
    of C.  Under a custom map G's runs and out entries take the place of
    its one launch.  Above 2x, one launch of I draws every clip's per-bin
    time factors.  J forms every render's prediction coefficients in one
    launch, K its windowed blocks and L its output."""
    auto = flags.process_formants and flags.formant_auto
    custom = flags.mapped and flags.custom_map is not None
    return {"interp_multi": int(flags.mapped or random), "sweep": 1,
            "iir": int(flags.mapped) + int(auto), "dft": 1,
            "decay": int(flags.process_formants), "top3": int(auto),
            "peaks_map": int(flags.mapped and not custom),
            "peaks_runs": int(custom), "peaks_out": int(custom),
            "block_sweep": 0, "draws": int(random), "coefficients": 1,
            "idft": 1, "ola": 1}


def stage_split(model, audio):
    """Device ms of analysis, plan, sweep and synthesis for one render."""
    import torch
    from signalsmith_stretch_torch import engine, planner, wavefront
    plan = model.plan
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    spectra, prev = engine.analyze_stage(audio, plan)
    ev[1].record()
    inputs = planner.plan_spectral(spectra, prev, plan.arrays, model.controls,
                                   model.flags, plan.consts)
    ev[2].record()
    out_specs = wavefront.sweep(inputs, plan.consts.long_vertical_step)
    ev[3].record()
    engine.synthesis_stage(out_specs, plan, audio=audio)
    ev[4].record()
    ev[4].synchronize()
    names = ("analysis", "plan", "sweep", "synthesis")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def render_vs_plain(model, audio):
    """Clips through the kernels against the same clips through the plain
    versions, both on the card, in two gates.  The spectral stage (A, B, C,
    E, F and G) on the spectra of one analysis through D: bit-equal.  The
    whole render, D included: bit-equal, or within 12 dB of the plain
    render's own response to a 1-ulp change of its input with band
    energies within 3 dB.  Returns (passed, description)."""
    import torch
    from signalsmith_stretch_torch import engine, ops, planner, wavefront
    plan = model.plan
    spectra, prev = engine.analyze_stage(audio, plan)

    def spectral_stage():
        return wavefront.sweep(planner.plan_spectral(
            spectra, prev, plan.arrays, model.controls, model.flags,
            plan.consts), plan.consts.long_vertical_step)

    k_specs = spectral_stage()
    with ops.plain():
        p_specs = spectral_stage()
    if not torch.equal(k_specs, p_specs):
        return False, (f"spectral stage through the kernels differs from "
                       f"the plain versions on the same spectra, max abs "
                       f"{max_abs(k_specs, p_specs):g}")
    del spectra, prev, k_specs, p_specs
    k_out = model.batched(audio)
    p_out = model.batched(audio, plain=True)
    stage = "spectral stage bit-equal on D's spectra; render "
    if torch.equal(k_out, p_out):
        return True, stage + "bit-equal"
    pert = torch.nextafter(audio, torch.full_like(audio, np.inf))
    p2 = model.batched(pert, plain=True).cpu().numpy()
    k, p = k_out.cpu().numpy(), p_out.cpu().numpy()
    sens = rel_err_db(p2, p)
    dev_db = rel_err_db(k, p)
    band = np.abs(band_energy_db(k) - band_energy_db(p)).max()
    ok = bool(np.isfinite(k).all()) and dev_db < sens + 12.0 and band <= 3.0
    return ok, (stage + f"not bit-equal: {dev_db:.1f} dB from the plain "
                f"render, 1-ulp sensitivity {sens:.1f} dB, band energies "
                f"within {band:.2f} dB")


def renders_in_turns(model_a, model_b, audio, reps=None):
    """Median wall ms of model_a's and model_b's renders of audio, timed in
    turns (a, b, b, a) so that both meet the same state of the host."""
    import torch
    times = ([], [])
    for _ in range(reps or TURN_REPS):
        for k in (0, 1, 1, 0):
            m = (model_a, model_b)[k]
            t0 = time.perf_counter()
            m.batched(audio)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[0]), statistics.median(times[1])


def same_as_mapped(model, out, audio):
    """The custom tonality cell's render `out` of audio against pitch+12's
    (the same clips and seeds through the built-in map): bit-identical,
    and the two timed in turns.  Returns the line's note."""
    import torch
    other = MAPPED[0]
    mapped, _ = _model(MAPPED, BATCH)
    if not torch.equal(mapped.batched(audio), out):
        raise SystemExit(f"{CUSTOM_TONALITY[0]}: render differs from "
                         f"{other}'s")
    turns = renders_in_turns(mapped, model, audio)
    return (f"; bit-identical to {other}'s render; in turns with it "
            f"({TURN_REPS} rounds of theirs, ours, ours, theirs), median "
            f"{turns[1]:.2f} ms against {turns[0]:.2f} ms")


def render_config(cfg):
    """Phase 4 for one configuration.  Returns the launch counts of the
    counted render."""
    import torch
    name, _, _ = cfg
    model, clips = _model(cfg, BATCH)
    audio = torch.as_tensor(clips, device=DEVICE)
    model.batched(audio)                       # first call: set-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    out = model.batched(audio)                 # the counted main-path run
    torch.cuda.synchronize()
    counts = counters()
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(model.flags, is_random(model.plan))
    if counts != want:
        raise SystemExit(f"{name}: kernel launches {counts}, expected {want}")
    shape = (BATCH, 2, model.out_samples)
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise SystemExit(f"{name}: output {tuple(out.shape)} (want {shape}) "
                         f"or not finite")
    same = (same_as_mapped(model, out, audio)
            if name == CUSTOM_TONALITY[0] else "")

    times = []
    for _ in range(RENDER_REPS):
        t0 = time.perf_counter()
        again = model.batched(audio)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not torch.equal(again, out):
            raise SystemExit(f"{name}: two renders of the same clips differ")
    secs = statistics.median(times)
    audio_s = BATCH * model.in_samples / RATE
    split = stage_split(model, audio)

    if name in GATE_SECONDS:
        gate_model, gate_clip = _model(cfg, 1, GATE_SECONDS[name])
        ok, gate = render_vs_plain(gate_model, torch.as_tensor(
            gate_clip, device=DEVICE))
        gate = f"({GATE_SECONDS[name]:g} s clip) {gate}"
    else:
        ok, gate = render_vs_plain(model, audio[:1])
    if not ok:
        raise SystemExit(f"{name}: {gate}")
    print(f"{name}: batch {BATCH} x {SECONDS:g} s stereo {RATE} Hz -> "
          f"{tuple(out.shape)}; render {secs * 1e3:.1f} ms (median of "
          f"{RENDER_REPS}, {[round(t * 1e3, 1) for t in times]}), realtime "
          f"factor {audio_s / secs:.1f}x; stages (ms) "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; peak memory {peak / 2**30:.2f} GiB; launches {counts}; "
          f"two renders bit-identical{same}; batch-1 kernels vs plain: "
          f"{gate}")
    del out, again, audio
    torch.cuda.empty_cache()
    return counts


def check_draws(name, plan, B):
    """I on a randomised cell's blocks at the main path's shapes (the
    batch's keys, seeds 0..7; the plan's bounds), bit-equal to its plain
    version (prng.uniform and the selects) on the card, and again with
    key words past 2**31 (seeds -1 and 2**31); timed alone, back to back
    and plain.  Bound: the outputs' bytes, or the SASS loop's issue for
    the draws this plan needs (blocks above 2x only), draws_bound_ms."""
    import torch
    from signalsmith_stretch_torch import planner
    from signalsmith_stretch_torch.config import MAX_CLEAN_STRETCH
    from signalsmith_stretch_torch.ops import draws
    from signalsmith_stretch_torch.tables import on_device
    dev = torch.device(DEVICE)
    tf = plan.arrays["tf"]
    nB = len(tf)
    bounds = on_device(tf, dev, planner.draw_bounds)
    args = (planner._clip_keys(tuple(range(BATCH)), dev), *bounds, B)
    for a in (args, (planner._clip_keys((-1, 2 ** 31), dev), *bounds, B)):
        got = draws.draws_factors(*a)
        ref = draws.draws_factors_plain(*a)
        if not all(same_bits(g, r) for g, r in zip(got, ref)):
            raise SystemExit(f"draws ({name}, keys {a[0].tolist()}): kernel "
                             f"differs from the plain version, max abs "
                             f"{max(max_abs(g, r) for g, r in zip(got, ref))}")
    del got, ref
    ms = cuda_ms(lambda: draws.draws_factors(*args), KERNEL_REPS)
    b2b = cuda_ms_b2b(lambda: draws.draws_factors(*args), KERNEL_REPS)
    plain = cuda_ms(lambda: draws.draws_factors_plain(*args), 3)
    issue = draws_issue()
    drawn = 2 * BATCH * int((tf > np.float32(MAX_CLEAN_STRETCH)).sum()) * B
    nbytes = 2 * BATCH * nB * B * 4 + BATCH * 8 + nB * 9
    bound = draws_bound_ms(nbytes, drawn, issue)
    print(f"I draws {name}: btf1, btf2 [{BATCH}, {nB}, {B}] ({drawn} draws "
          f"in the blocks above 2x): bit-equal to the plain version, also "
          f"with key words past 2**31; {ms:.4f} ms a launch alone, "
          f"{b2b:.4f} ms back to back, plain {plain:.1f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]}: {nbytes / 1e6:.1f} MB; the "
          f"SASS loop's {issue['loop']} instructions for 8 draws, "
          f"{issue['int_loop']} integer, {issue['alu_loop']} ALU-only, at "
          f"{ISSUE_A_CLOCK} and {ALU_A_CLOCK} a clock on {issue['sms']} SMs "
          f"at {issue['clock_hz'] / 1e6:g} MHz)")
    return dict(max_abs_err=0.0, ms=ms, ms_b2b=b2b, plain_ms=plain,
                bound=bound, shape=(BATCH, nB, B), drawn=drawn,
                sass=dict(issue))


def check_random_interp():
    """A on the randomised cells' position sets at their main-path shapes:
    four per-bin vote sets over the input's planes (3x, unmapped) and G's
    input bin with four vote sets (2.5x at +2 semitones), bit-equal to the
    plain version and timed; I on the same cells (check_draws) and, at 3x,
    the sweep's time.  Returns (A's numbers, I's numbers) by cell."""
    import torch
    from signalsmith_stretch_torch import engine, planner, wavefront
    from signalsmith_stretch_torch.ops import interp
    out, drawn = {}, {}
    for cfg in (RANDOM, RANDOM_MAPPED):
        name = cfg[0]
        model, clips = _model(cfg, BATCH)
        plan = model.plan
        audio = torch.as_tensor(clips, device=DEVICE)
        spectra, prev = engine.analyze_stage(audio, plan)
        inputs, dbg = planner.plan_spectral(spectra, prev, plan.arrays,
                                            model.controls, model.flags,
                                            plan.consts, debug=True)
        planes, pos_sets = dbg["interp"]
        pos = dbg["pos"]
        got, _ = interp.interp_multi(planes, pos_sets, pos=pos)
        ref, _ = interp.interp_multi_plain(planes, pos_sets)
        err = max(max_abs(g, r) for g, r in zip(got, ref))
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise SystemExit(f"interp_multi ({name}): kernel differs from "
                             f"the plain version, max abs {err}")
        rows, n, W0 = planes.shape
        B = pos.shape[-1]
        nout = sum(ns for _, ns, _ in pos_sets)
        ms = cuda_ms(lambda: interp.interp_multi(planes, pos_sets, pos=pos),
                     KERNEL_REPS)
        b2b = cuda_ms_b2b(lambda: interp.interp_multi(planes, pos_sets,
                                                      pos=pos), KERNEL_REPS)
        plain = cuda_ms(lambda: interp.interp_multi_plain(planes, pos_sets),
                        3)
        bound = bound_ms(4 * (rows * n * W0 + rows * len(pos_sets) * B
                              + rows * nout * B),
                         3 * rows * nout * B + 2 * rows * len(pos_sets) * B)
        print(f"A interp_multi {name}: planes {tuple(planes.shape)}, sets "
              f"{[ns for _, ns, _ in pos_sets]} on [{rows}, {len(pos_sets)}, "
              f"{B}] positions: bit-equal to the plain version; {ms:.4f} ms "
              f"a launch alone, {b2b:.4f} ms back to back, plain {plain:.1f} "
              f"ms, bound {bound[0]:.4f} ms ({bound[1]})")
        out[name] = dict(ms=ms, ms_b2b=b2b, plain_ms=plain, bound=bound,
                         planes=tuple(planes.shape), sets=len(pos_sets))
        del got, ref
        drawn[name] = check_draws(name, plan, B)
        if cfg is RANDOM:
            sweep = cuda_ms(lambda: wavefront.sweep(
                inputs, plan.consts.long_vertical_step), 3)
            out[name]["sweep_ms"] = sweep
            print(f"B sweep {name}: the same batch {sweep:.3f} ms")
        del spectra, prev, inputs, dbg, planes, pos, audio
        torch.cuda.empty_cache()
    return out, drawn


def check_automation():
    """SignalsmithStretch.exact with per-block controls on one 10 s stereo
    clip: a pitch ramp from 0 to +7 semitones (a callable of output time),
    the 8 kHz tonality limit, formant +3 semitones with compensation, base
    estimated.  Its launch counts, finiteness, shape and run-to-run
    identity; G with the per-block controls on the render's rows bit-equal
    to its plain version on a CPU copy and on the card; a 3 s clip's
    render through the kernels against the plain versions
    (render_vs_plain).  Returns the launch counts of the counted call."""
    import torch
    from signalsmith_stretch_torch import SignalsmithStretch, engine, planner
    from signalsmith_stretch_torch.models import StretchModel
    from signalsmith_stretch_torch.ops import peaks
    s = SignalsmithStretch(device=DEVICE)
    s.preset_default(2, RATE)
    s.set_formant_factor(1.0, True)        # pitch compensation
    auto = dict(semitones=lambda t: 7.0 * t / SECONDS,
                tonality_limit=8000 / RATE,
                formant_semitones=3, formant_base=0,
                sample_rate=RATE)
    in_len = int(RATE * SECONDS)
    clip = make_corpus(1, 2, in_len, RATE, seed=2)[0]
    s.exact(clip, in_len, automation=auto)              # set-up
    torch.cuda.synchronize()
    reset_counters()
    out, ok = s.exact(clip, in_len, automation=auto)    # the counted run
    torch.cuda.synchronize()
    counts = counters()
    plan = s.plan(in_len, in_len)
    controls, flags = s._automated(plan, auto)
    want = expected_launches(flags)
    name = "automation"
    if counts != want or not flags.mapped or not controls.automated:
        raise SystemExit(f"{name}: kernel launches {counts}, expected {want}")
    if not ok or out.shape != (2, in_len) or not np.isfinite(out).all():
        raise SystemExit(f"{name}: output {out.shape} not finite or refused")
    times = []
    for _ in range(RENDER_REPS):
        t0 = time.perf_counter()
        again, _ = s.exact(clip, in_len, automation=auto)
        times.append(time.perf_counter() - t0)
        if again.tobytes() != out.tobytes():
            raise SystemExit(f"{name}: two renders of the same clip differ")
    secs = statistics.median(times)

    # G with per-block controls on the render's rows
    x = torch.as_tensor(clip, device=DEVICE)[None]
    spectra, prev = engine.analyze_stage(x, plan)
    _, dbg = planner.plan_spectral(spectra, prev, plan.arrays, controls,
                                   flags, plan.consts, debug=True)
    args = (dbg["energy"], dbg["smoothed"], *dbg["shifts"])
    got = peaks.peaks_positions(*args, controls, plan.consts)
    cpu = peaks.peaks_positions_plain(*(a.cpu() for a in args), controls,
                                      plan.consts)
    card = peaks.peaks_positions_plain(*args, controls, plan.consts)
    for g, c, p in zip(got, cpu, card):
        if not (same_bits(g.cpu(), c) and same_bits(g, p)):
            raise SystemExit(f"{name}: G with per-block controls differs "
                             f"from its plain version, max abs "
                             f"{max_abs(g.cpu(), c)}")
    g_ms = cuda_ms(lambda: peaks.peaks_positions(*args, controls,
                                                 plan.consts), KERNEL_REPS)
    g_scalar = cuda_ms(lambda: peaks.peaks_positions(
        *args, controls._replace(**{k: np.float32(getattr(controls, k)[0])
                                    for k in controls._fields}),
        plan.consts), KERNEL_REPS)
    mults = controls.freq_multiplier
    print(f"G peaks_map {name}: {tuple(args[0].shape)} rows, per-block "
          f"controls (mult {mults.min():.4f} to {mults.max():.4f}): the four "
          f"planes bit-equal to the plain version on the CPU and on the "
          f"card; {g_ms:.4f} ms a launch alone (scalar controls on the same "
          f"rows {g_scalar:.4f} ms)")
    del spectra, prev, dbg, args, got, cpu, card

    # a 3 s clip through the kernels against the plain versions
    n3 = min(int(RATE * 3.0), in_len)
    plan3 = s.plan(n3, n3)
    c3, f3 = s._automated(plan3, auto)
    gate_model = StretchModel(s.config, c3, f3, n3, n3, plan=plan3,
                              device=DEVICE)
    ok, gate = render_vs_plain(gate_model, x[:, :, :n3].contiguous())
    if not ok:
        raise SystemExit(f"{name}: {gate}")
    print(f"{name}: SignalsmithStretch.exact, 1 x {SECONDS:g} s stereo "
          f"{RATE} Hz, {len(mults)} blocks of per-block controls -> "
          f"{out.shape}; render {secs * 1e3:.1f} ms (median of "
          f"{RENDER_REPS}, {[round(t * 1e3, 1) for t in times]}, numpy in "
          f"and out), realtime factor {SECONDS / secs:.1f}x; launches "
          f"{counts}; two renders bit-identical; 3 s clip, kernels vs plain: "
          f"{gate}")
    torch.cuda.empty_cache()
    return counts


def check_cli():
    """The CLI in a subprocess on the card: a 10 s stereo 16-bit WAV at
    1.25x and +3 semitones.  Its exit code, round(n * 1.25) samples, and
    the file equal, byte for byte, to the `exact` render of the WAV's
    samples written the same way."""
    import tempfile
    from signalsmith_stretch_torch import SignalsmithStretch
    from signalsmith_stretch_torch.io import read_wav, write_wav
    in_len = int(RATE * SECONDS)
    out_len = int(round(in_len * 1.25))
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        inp, outp, ref = (os.path.join(d, f) for f in
                          ("in.wav", "out.wav", "ref.wav"))
        write_wav(inp, 0.8 * make_corpus(1, 2, in_len, RATE, seed=3)[0], RATE)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "signalsmith_stretch_torch.cli", inp, outp,
             "--time=1.25", "--semitones=3"], cwd=ROOT, capture_output=True,
            text=True, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
        wall = time.perf_counter() - t0
        if r.returncode:
            raise SystemExit(f"cli: exit {r.returncode}: {r.stderr[-2000:]}")
        out, rate = read_wav(outp)
        if rate != RATE or out.shape != (2, out_len):
            raise SystemExit(f"cli: {out.shape} at {rate} Hz, want "
                             f"{(2, out_len)} at {RATE}")
        pcm, _ = read_wav(inp)
        s = SignalsmithStretch(device=DEVICE)
        s.preset_default(2, RATE)
        s.set_transpose_semitones(3, 8000 / RATE)
        want, ok = s.exact(pcm, out_len)
        write_wav(ref, want, RATE)
        with open(outp, "rb") as a, open(ref, "rb") as b:
            if not ok or a.read() != b.read():
                raise SystemExit("cli: the output file differs from the exact "
                                 "render of its input")
    said = [ln for ln in r.stdout.splitlines() if "realtime" in ln]
    print(f"cli: python3 -m signalsmith_stretch_torch.cli in.wav out.wav "
          f"--time=1.25 --semitones=3 on {SECONDS:g} s stereo: exit 0, "
          f"{out.shape[1]} samples, the file equals exact()'s render written "
          f"the same way; {wall:.1f} s in all with the process start; it "
          f"said: {said[0] if said else r.stdout.strip()}")


def check_cli_dev():
    """The dev CLI (python3 -m signalsmith_stretch_torch.cli_dev) in a
    subprocess on the card, twice on one 10 s stereo 16-bit WAV at 1.25x
    and +3 semitones: the first run snapshots <output>.reference.npy, the
    second (with --profile) passes the -60 dB golden gate against it; both
    pass the allocation guard.  Prints each run's process time and
    realtime factor as the CLI reports them."""
    import tempfile
    from signalsmith_stretch_torch.io import write_wav
    in_len = int(RATE * SECONDS)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        inp, outp = os.path.join(d, "in.wav"), os.path.join(d, "out.wav")
        write_wav(inp, 0.8 * make_corpus(1, 2, in_len, RATE, seed=4)[0], RATE)
        said = []
        for run, extra, want in ((1, [], "snapshotted"),
                                 (2, ["--profile"], "difference:")):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "signalsmith_stretch_torch.cli_dev",
                 inp, outp, "--time=1.25", "--semitones=3", *extra],
                cwd=ROOT, capture_output=True, text=True, timeout=600,
                env=dict(os.environ, PYTHONPATH=ROOT))
            wall = time.perf_counter() - t0
            if r.returncode:
                raise SystemExit(f"cli_dev run {run}: exit {r.returncode}: "
                                 f"{r.stdout[-1500:]} {r.stderr[-1500:]}")
            lines = r.stdout.splitlines()
            if (want not in r.stdout
                    or "allocation guard: ok" not in r.stdout):
                raise SystemExit(f"cli_dev run {run}: no {want!r} or no "
                                 f"guard line: {r.stdout[-1500:]}")
            process = [ln.strip() for ln in lines if "realtime" in ln]
            gate = [ln.strip() for ln in lines if "difference:" in ln]
            said.append(f"run {run}: {wall:.1f} s in all; "
                        f"{process[0] if process else '?'}"
                        + (f"; {gate[0]}" if gate else "; snapshotted"))
        stages = [ln.strip() for ln in lines
                  if ln.strip().split(" ")[0] in
                  ("analysis", "plan", "sweep", "synthesis", "full")]
        if not os.path.exists(os.path.join(d, "profile.svg")):
            raise SystemExit("cli_dev: --profile wrote no profile.svg")
    print(f"cli_dev: python3 -m signalsmith_stretch_torch.cli_dev in.wav "
          f"out.wav --time=1.25 --semitones=3 on {SECONDS:g} s stereo: "
          + "; ".join(said) + "; the allocation guard passed both; "
          f"--profile stages: " + ", ".join(stages))


# ---------------------------------------------------------------------------
# Phase 8: the streaming engine
# ---------------------------------------------------------------------------
# the streams: (name, time factor, the library object's setters)
STREAMS = (
    ("stream_1.25x", 1.25, {}),
    ("stream_pitch+12_tonality8k", 1.0, dict(semitones=12)),
    ("stream_formant_vocal_shift_auto", 1.0, dict(semitones=5,
                                                  formant_semitones=3)),
    ("stream_custom_tonality_map", 1.0, dict(semitones=12, custom=True)),
    # every block above 2x draws (kernel I): an ambient 3x slow-down
    ("stream_3x", 3.0, {}),
)
STREAM_CHUNK = 512           # output samples a process() call
STREAM_GATE_SECONDS = 0.5    # the kernels' stream against the plain path
STREAM_CHECK_BLOCKS = 8      # process_block, kernels against plain versions


def _stream_object(cfg):
    """The library object of a stream: default preset, stereo 48 kHz, and
    the stream's setters (an 8 kHz tonality limit with any pitch; formant
    compensation with a formant shift, base estimated; pitch+12's map as
    a torch callable for the custom stream)."""
    from signalsmith_stretch_torch import SignalsmithStretch
    _, _, kw = cfg
    s = SignalsmithStretch(device=DEVICE)
    s.preset_default(2, RATE)
    if "semitones" in kw:
        s.set_transpose_semitones(kw["semitones"], 8000 / RATE)
    if "formant_semitones" in kw:
        s.set_formant_semitones(kw["formant_semitones"], True)
    if kw.get("custom"):
        s.set_freq_map(tonality_map(s._controls()))
    return s


def _stream_engine(cfg, device, plain=False):
    """A StreamingStretch of the stream's config, controls and flags on
    `device` (plain=True: the plain versions of the kernels)."""
    from signalsmith_stretch_torch.streaming import StreamingStretch
    s = _stream_object(cfg)
    return StreamingStretch(s.config, s._controls(), s._flags(), seed=0,
                            device=device, plain=plain)


def _stream_calls(s, clip, time_factor, out_seconds=None):
    """Drive a stream (the library object or a StreamingStretch) as an
    offline user would: output_seek, process in STREAM_CHUNK-sample output
    chunks (the input in proportion), flush at rate 0.  out_seconds cuts
    the output (no flush).  Returns (outputs, wall ms of each call)."""
    import torch
    cfg = getattr(s, "cfg", None) or s.config
    L = clip.shape[1]
    seek_len = cfg.output_seek_length(np.float32(1 / time_factor))
    main_in = L - seek_len
    main_out = int(round(main_in * time_factor))
    if out_seconds is not None:
        main_out = min(main_out, int(out_seconds * RATE))
    outs, times = [], []

    def timed(fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return r

    timed(s.output_seek, clip[:, :seek_len])
    done = in_done = 0
    while done < main_out:
        n = min(STREAM_CHUNK, main_out - done)
        in_target = min(int(round((done + n) / time_factor)), main_in)
        outs.append(timed(s.process, clip[:, seek_len + in_done:
                                          seek_len + in_target], n))
        in_done, done = in_target, done + n
    if out_seconds is None:
        outs.append(timed(s.flush, cfg.output_latency + cfg.input_latency,
                          0.0))
    return outs, times


def expected_stream_launches(flags, blocks, drawn=0):
    """Launches of a stream's blocks: D, A and H once a block; C once a
    block when mapped (the smoothing) and once more with the base
    estimated (the estimate's step); G once a block when mapped (its runs
    and out entries under a custom map); E once a block for formants, F
    with the base estimated; I once in each of the `drawn` blocks above
    2x (a flush at rate 0 runs such blocks too).  J never: a block forms
    its coefficients in process_block; K and L never: a block synthesises
    through stft.synthesize."""
    auto = flags.process_formants and flags.formant_auto
    custom = flags.mapped and flags.custom_map is not None
    return {"interp_multi": blocks, "sweep": 0,
            "iir": blocks * (int(flags.mapped) + int(auto)), "dft": blocks,
            "decay": blocks * int(flags.process_formants),
            "top3": blocks * int(auto),
            "peaks_map": blocks * int(flags.mapped and not custom),
            "peaks_runs": blocks * int(custom),
            "peaks_out": blocks * int(custom), "block_sweep": blocks,
            "draws": drawn, "coefficients": 0, "idft": 0, "ola": 0}


def _record_blocks(engine, clip, time_factor, n):
    """The first n blocks' (carry, inputs) of a stream through the kernels,
    recorded as process_block receives them."""
    from signalsmith_stretch_torch import streaming
    recorded = []
    original = streaming.spectral.process_block

    def record(carry, xs, *a, **k):
        if len(recorded) < n:
            recorded.append((carry, xs))
        return original(carry, xs, *a, **k)

    streaming.spectral.process_block = record
    try:
        _stream_calls(engine, clip, time_factor,
                      out_seconds=(n + 4) * engine.cfg.interval_samples
                      / RATE)
    finally:
        streaming.spectral.process_block = original
    return recorded[:n]


def check_stream_blocks(cfg, clip):
    """process_block through the kernels against the plain path, both on
    the card, on the same carry and D spectra for each of the stream's
    first blocks: the output and every carry field bit-equal.  Returns the
    last block's kernel inputs (process_block's dbg)."""
    import torch
    from signalsmith_stretch_torch import ops, spectral
    name, tf, _ = cfg
    eng = _stream_engine(cfg, DEVICE)
    blocks = _record_blocks(eng, clip, tf, STREAM_CHECK_BLOCKS)
    dbg, mcs = {}, []
    for k, (carry, xs) in enumerate(blocks):
        got = spectral.process_block(carry, xs, eng.controls, eng.flags,
                                     eng.consts, dbg=dbg)
        mcs.append(dbg["sweep"].max_ch)
        with ops.plain():
            ref = spectral.process_block(carry, xs, eng.controls, eng.flags,
                                         eng.consts)
        pairs = [(got[1], ref[1])] + list(zip(got[0][:6], ref[0][:6]))
        if not (all(same_bits(a.contiguous(), b.contiguous())
                    if a.dtype == torch.float32 else torch.equal(a, b)
                    for a, b in pairs) and got[0].rng == ref[0].rng):
            err = max(max_abs(a, b) for a, b in pairs)
            raise SystemExit(f"{name}: process_block block {k} through the "
                             f"kernels differs from the plain path, max abs "
                             f"{err:g}")
    dbg["lead_changes"] = lead_change_shares(
        torch.stack(mcs).cpu().numpy(), eng.consts.long_vertical_step)
    print(f"{name}: process_block on the stream's first {len(blocks)} blocks "
          f"(their carries and D spectra): kernels bit-equal to the plain "
          f"path, output and every carry field")
    return dbg, eng


def lead_change_shares(mc, longv):
    """How often H's chain must lock in place, over blocks' loudest
    channels mc [blocks, B]: the share of bins b >= 1 with mc[b] !=
    mc[b-1] (down1 is a locked output: a second makeOutput on the chain),
    its least and largest share in a block, and the share of bins b >= LV
    with mc[b-LV] != mc[b] (downl is a locked output, formed early)."""
    d1 = mc[:, 1:] != mc[:, :-1]
    dl = mc[:, longv:] != mc[:, :-longv]
    per_block = d1.mean(1)
    return dict(down1=float(d1.mean()), down1_min=float(per_block.min()),
                down1_max=float(per_block.max()), downl=float(dl.mean()),
                blocks=int(mc.shape[0]))


def block_sweep_stamps(x, longv, reps=5):
    """H's timed entry (never on the main path) `reps` times after one
    warm-up; the run with the median span, as a dict: each phase's cycles
    (block_sweep.PHASES), span_ms, and the chain's share of the chain
    warp's cycles in ms (chain_ms)."""
    from signalsmith_stretch_torch.ops import block_sweep
    P = len(block_sweep.PHASES)
    runs = [block_sweep.phase_stamps(x, longv)[0].cpu().numpy()
            for _ in range(reps + 1)][1:]
    st = sorted(runs, key=lambda r: r[P + 1] - r[P])[len(runs) // 2]
    cyc = {k: int(v) for k, v in zip(block_sweep.PHASES, st[:P])}
    warp = cyc["inputs_wait"] + cyc["chain"] + cyc["consumers_wait"]
    span_ms = (st[P + 1] - st[P]) / 1e6
    return dict(cyc, span_ms=span_ms,
                chain_ms=span_ms * cyc["chain"] / max(warp, 1))


def block_sweep_floor(x, reps=5):
    """H's floor entry (one thread, the lead recursion alone, inputs in
    registers) `reps` times after one warm-up: the median ms for x's B
    bins and its cycles a bin."""
    from signalsmith_stretch_torch.ops import block_sweep
    B = x.pe.shape[1]
    runs = [block_sweep.chain_floor(x)[0].tolist() for _ in range(reps + 1)]
    ms, cyc = zip(*[((t1 - t0) / 1e6 * B / bins, c / bins)
                    for c, t0, t1, bins in runs[1:]])
    return statistics.median(ms), statistics.median(cyc)


def one_row_timing(fn, plain_fn, nbytes, flops, plain_reps=PLAIN_REPS):
    return dict(ms=cuda_ms(fn, KERNEL_REPS), ms_b2b=cuda_ms_b2b(
        fn, KERNEL_REPS), plain_ms=cuda_ms(plain_fn, plain_reps),
        bound=bound_ms(nbytes, flops))


def check_stream_kernels(name, dbg, eng, clip):
    """Each kernel of the stream's block at its shapes (one row) against
    its plain version on the card, on the inputs of process_block's last
    checked block: H (also with a third channel), A, G (or its two
    entries under a custom map), F with the base estimated, I (a block's
    draws at 3x), and D on the block's two frames of each channel.
    Returns {kernel: numbers}."""
    import torch
    from signalsmith_stretch_torch import ops, prng, spectral, stft
    from signalsmith_stretch_torch.ops import (block_sweep, dft, draws,
                                               interp, peaks, scan_ops)
    out = {}
    consts, longv = eng.consts, eng.consts.long_vertical_step
    x = dbg["sweep"]
    ch, B = x.pe.shape
    # --- H, and H with a third channel (a copy of channel 0, scaled) ----
    x3 = block_sweep.BlockSweepInputs(*x[:6], *[
        torch.cat([v, v[:1] * 0.5]).contiguous() for v in x[6:]])
    for xi in (x, x3):
        got = block_sweep.block_sweep(xi, longv)
        ref = block_sweep.block_sweep_plain(xi, longv)
        if not torch.equal(torch.view_as_real(got).view(torch.int32),
                           torch.view_as_real(ref).view(torch.int32)):
            raise SystemExit(f"{name}: block_sweep ({xi.pe.shape[0]} "
                             f"channels) differs from the plain version, max "
                             f"abs {max_abs(got, ref):g}")
    stamps = block_sweep_stamps(x, longv)
    floor_ms, floor_cyc = block_sweep_floor(x)
    shares = dbg["lead_changes"]
    # per bin: the six per-bin planes in, ct, pe, pi per channel in, the
    # outputs out; per bin ~14 products and sums for the lead and ~12 per
    # locked channel, two divisions and roots
    h = one_row_timing(lambda: block_sweep.block_sweep(x, longv),
                       lambda: block_sweep.block_sweep_plain(x, longv),
                       B * (40 + 20 * ch + 8 * ch), B * (30 + 24 * ch))
    h.update(max_abs_err=0.0, chain_ms=stamps["chain_ms"],
             cycles_a_bin=stamps["chain"] / B,
             stamps={k: stamps[k] for k in block_sweep.PHASES},
             span_ms=stamps["span_ms"], chain_floor_ms=floor_ms,
             floor_cycles_a_bin=floor_cyc, lead_changes=shares)
    out["block_sweep"] = h
    print(f"{name}: H block_sweep [{ch}, {B}] and [3, {B}]: bit-equal to the "
          f"plain version; {h['ms']:.4f} ms a launch alone, {h['ms_b2b']:.4f} "
          f"back to back, plain {h['plain_ms']:.1f} ms; timed entry span "
          f"{stamps['span_ms']:.4f} ms, the chain {stamps['chain_ms']:.4f} ms "
          f"({h['cycles_a_bin']:.1f} cycles a bin), the chain warp waiting "
          f"{stamps['inputs_wait']} cycles on inputs and "
          f"{stamps['consumers_wait']} on the consumers, the helpers "
          f"staging {stamps['helpers_stage']}, forming outputs "
          f"{stamps['helpers_out']}, waiting for leads "
          f"{stamps['helpers_idle']} cycles; chain_floor_ms {floor_ms:.4f} "
          f"({floor_cyc:.1f} cycles a bin); lead changes in the first "
          f"{shares['blocks']} blocks: down1 {100 * shares['down1']:.1f}% of "
          f"bins ({100 * shares['down1_min']:.1f}-"
          f"{100 * shares['down1_max']:.1f}% a block), downl "
          f"{100 * shares['downl']:.1f}%")
    # --- A at one row ---------------------------------------------------
    planes, pos_sets, stacked = dbg["interp"]
    got, _ = interp.interp_multi(planes, pos_sets, pos=stacked)
    ref, _ = interp.interp_multi_plain(planes, pos_sets)
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise SystemExit(f"{name}: interp_multi at one row differs from the "
                         f"plain version")
    rows, n, W0 = planes.shape
    nout = sum(ns for _, ns, _ in pos_sets)
    out["interp_multi"] = one_row_timing(
        lambda: interp.interp_multi(planes, pos_sets, pos=stacked),
        lambda: interp.interp_multi_plain(planes, pos_sets),
        4 * (rows * n * W0 + rows * len(pos_sets) * B + rows * nout * B),
        3 * rows * nout * B + 2 * rows * len(pos_sets) * B)
    out["interp_multi"].update(max_abs_err=0.0, sets=len(pos_sets),
                               planes=tuple(planes.shape))
    # --- G (or its entries) at one row -----------------------------------
    if "smoothed" in dbg:
        energy, sm = dbg["energy"], dbg["smoothed"]
        tf_d, ltf_d = dbg["shifts"]
        if eng.flags.custom_map is None:
            args = (energy, sm, tf_d, ltf_d, eng.controls, consts)
            got = peaks.peaks_positions(*args)
            ref = peaks.peaks_positions_plain(*args)
            cpu = peaks.peaks_positions_plain(
                *[a.cpu() if torch.is_tensor(a) else a for a in args])
            key = "peaks_map"
            fn = lambda: peaks.peaks_positions(*args)  # noqa: E731
            plain_fn = lambda: peaks.peaks_positions_plain(*args)  # noqa
        else:
            fmap = eng.flags.custom_map
            got = peaks.peaks_positions_custom(energy, sm, tf_d, ltf_d, fmap,
                                               consts)
            with ops.plain():
                ref = peaks.peaks_positions_custom(energy, sm, tf_d, ltf_d,
                                                   fmap, consts)
            cpu = peaks.peaks_positions_custom(
                energy.cpu(), sm.cpu(), tf_d.cpu(), ltf_d.cpu(), fmap, consts)
            key = "peaks_split"
            fn = lambda: peaks.peaks_positions_custom(  # noqa: E731
                energy, sm, tf_d, ltf_d, fmap, consts)
            def plain_fn():
                with ops.plain():
                    return peaks.peaks_positions_custom(energy, sm, tf_d,
                                                        ltf_d, fmap, consts)
        if not all(same_bits(g, r) and same_bits(g.cpu(), c)
                   for g, r, c in zip(got, ref, cpu)):
            raise SystemExit(f"{name}: G at one row differs from its plain "
                             f"version")
        out[key] = one_row_timing(fn, plain_fn, 4 * (2 * B + 2 + 4 * B),
                                  30 * B)
        out[key]["max_abs_err"] = 0.0
    # --- F at one row (the base estimated) --------------------------------
    if eng.flags.process_formants and eng.flags.formant_auto:
        metric = dbg["energy_sum"]
        got = scan_ops.top3_local_maxima(metric)
        ref = spectral._top3_local_maxima(metric)
        if not all(same_bits(g, r) for g, r in zip(got, ref)):
            raise SystemExit(f"{name}: top3 at one row differs from the "
                             f"plain version")
        out["top3"] = one_row_timing(
            lambda: scan_ops.top3_local_maxima(metric),
            lambda: spectral._top3_local_maxima(metric), 4 * (B + 6), 6 * B)
        out["top3"]["max_abs_err"] = 0.0
    # --- I at one row: a block's draws (2, B) at 3x under a split key with
    # its top bit set, against prng.uniform of (2, B) --------------------
    key = prng.split(prng.key(2 ** 31 + 5))[1]
    lo, hi = np.float32(1), np.float32(3)
    got = draws.draws_block(key, lo, hi, B, DEVICE)
    ref = draws.draws_block_plain(key, lo, hi, B, DEVICE)
    if not same_bits(got, ref):
        raise SystemExit(f"{name}: draws_block differs from the plain "
                         f"version, max abs {max_abs(got, ref):g}")
    issue = draws_issue()
    out["draws"] = one_row_timing(
        lambda: draws.draws_block(key, lo, hi, B, DEVICE),
        lambda: draws.draws_block_plain(key, lo, hi, B, DEVICE), 0, 0)
    out["draws"].update(max_abs_err=0.0, bound=draws_bound_ms(
        2 * B * 4, 2 * B, issue))
    # --- D on one block's frames: [2 ch, block] ----------------------------
    block, H = eng.cfg.block_samples, eng.cfg.interval_samples
    c = torch.as_tensor(clip, device=DEVICE)
    at = block + H + 4 * H
    frames = torch.cat([c[:, at - block:at], c[:, at - H - block:at - H]])
    basis = eng.basis
    got = dft.analyze(frames, basis)
    ref = stft.analyze_plain(frames, basis)
    err = max_abs(got, ref)
    peak = float(ref.abs().max())
    if not err <= DFT_TOL * peak:
        raise SystemExit(f"{name}: dft on [{frames.shape[0]}, {block}] "
                         f"differs from the plain analysis by {err / peak:.3g}"
                         f" of the peak")
    N = basis.fft_samples
    nF = frames.shape[0]
    out["dft"] = one_row_timing(
        lambda: dft.analyze(frames, basis),
        lambda: stft.analyze_plain(frames, basis),
        nF * (4 * block + 8 * basis.bands),
        nF * 5 * N * (N.bit_length() - 1) // 2, KERNEL_REPS)
    out["dft"]["max_abs_err"] = err
    print(f"{name}: at one row, bit-equal to their plain versions: A "
          f"{tuple(planes.shape)} x {len(pos_sets)} sets "
          f"{out['interp_multi']['ms']:.4f} ms"
          + "".join(f", {k} {v['ms']:.4f} ms" for k, v in out.items()
                    if k in ("peaks_map", "peaks_split", "top3", "draws"))
          + f"; D [{nF}, {block}] within {err / peak:.3g} of the peak, "
          f"{out['dft']['ms']:.4f} ms")
    return out


def stream_vs_plain(cfg, clip):
    """The first STREAM_GATE_SECONDS of the stream through the kernels on
    the card against the plain path (the plain versions on the CPU), the
    same calls: the output within 12 dB of the plain stream's own response
    to a 1-ulp change of its input (up or down, the larger), band energies
    within 3 dB; bit-equal passes outright.  Returns the description."""
    name, tf, _ = cfg
    kern, _ = _stream_calls(_stream_engine(cfg, DEVICE), clip, tf,
                            STREAM_GATE_SECONDS)
    k = np.concatenate(kern, 1)

    def plain(x):
        outs, _ = _stream_calls(_stream_engine(cfg, "cpu", plain=True), x, tf,
                                STREAM_GATE_SECONDS)
        return np.concatenate(outs, 1)

    p = plain(clip)
    if np.array_equal(k, p):
        return f"first {STREAM_GATE_SECONDS:g} s bit-equal to the plain path"
    sens = [rel_err_db(plain(np.nextafter(clip, way).astype(np.float32)), p)
            for way in (np.inf, -np.inf)]
    dev_db = rel_err_db(k, p)
    band = np.abs(band_energy_db(k) - band_energy_db(p)).max()
    if not (np.isfinite(k).all() and dev_db < max(sens) + 12.0
            and band <= 3.0):
        raise SystemExit(f"{name}: the first {STREAM_GATE_SECONDS:g} s "
                         f"through the kernels {dev_db:.1f} dB from the "
                         f"plain path (1-ulp sensitivity {sens[0]:.1f} / "
                         f"{sens[1]:.1f} dB), band energies within "
                         f"{band:.2f} dB")
    return (f"first {STREAM_GATE_SECONDS:g} s {dev_db:.1f} dB from the plain "
            f"path on the CPU, its 1-ulp sensitivity {sens[0]:.1f} (up) / "
            f"{sens[1]:.1f} (down) dB, band energies within {band:.2f} dB")


def run_stream(cfg, clip):
    """The stream's main-path run through the library object: output_seek,
    the 10 s clip in STREAM_CHUNK-sample output chunks, flush at rate 0;
    launches by kernel counted from 0 (against the blocks run and those of
    them above 2x, counted from their time factors), synchronising calls
    counted under torch.cuda.set_sync_debug_mode("warn"), inside the block
    loop and in all.  Returns (launch counts, numbers, output)."""
    import torch
    import warnings
    from signalsmith_stretch_torch import streaming
    name, tf, _ = cfg
    warm = _stream_object(cfg)                  # set-up: caches, constants
    _stream_calls(warm, clip, tf, out_seconds=0.2)
    s = _stream_object(cfg)
    eng = s._stream()
    loop_syncs, drawn = [0], [0]
    normal, block_fn = eng._normal, streaming.spectral.process_block

    def block_counted(carry, xs, *a, **k):
        drawn[0] += int(max(np.float32(xs.time_factor), np.float32(0.5))
                        > np.float32(2))
        return block_fn(carry, xs, *a, **k)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted(*a, **k):
            n0 = len(caught)
            r = normal(*a, **k)
            loop_syncs[0] += len(caught) - n0
            return r

        eng._normal = counted
        streaming.spectral.process_block = block_counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("warn")
        reset_counters()
        blocks0 = eng.blocks
        try:
            outs, times = _stream_calls(s, clip, tf)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            eng._normal = normal
            streaming.spectral.process_block = block_fn
        counts = counters()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    blocks = eng.blocks - blocks0
    want = expected_stream_launches(eng.flags, blocks, drawn[0])
    if counts != want:
        raise SystemExit(f"{name}: kernel launches {counts}, expected {want} "
                         f"for {blocks} blocks, {drawn[0]} above 2x")
    out = np.concatenate(outs, 1)
    if not np.isfinite(out).all():
        raise SystemExit(f"{name}: output not finite")
    calls = len(times)
    wall = sum(times)
    nums = dict(blocks=blocks, drawn=drawn[0], calls=calls, wall_ms=wall,
                call_ms_median=statistics.median(times),
                call_ms_p99=float(np.percentile(times, 99)),
                block_ms=wall / blocks,
                realtime=(clip.shape[1] / RATE) / (wall / 1e3),
                syncs=syncs, loop_syncs=loop_syncs[0],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches_a_block={k: v / blocks for k, v in counts.items()
                                  if v})
    print(f"{name}: {SECONDS:g} s stereo {RATE} Hz at {tf:g}x in {calls} "
          f"calls of {STREAM_CHUNK} output samples (output_seek, process, "
          f"flush at rate 0): {blocks} blocks ({drawn[0]} above 2x), "
          f"{out.shape[1]} samples; "
          f"{wall:.1f} ms in all, a call median {nums['call_ms_median']:.3f} "
          f"ms, p99 {nums['call_ms_p99']:.3f} ms, {nums['block_ms']:.3f} ms "
          f"a block, realtime factor {nums['realtime']:.1f}x; launches a "
          f"block {nums['launches_a_block']}; synchronising calls "
          f"{syncs} in all ({syncs / calls:.2f} a call), "
          f"{loop_syncs[0]} in the block loops ({loop_syncs[0] / blocks:.3f} "
          f"a block); peak memory {nums['peak_gib']:.3f} GiB")
    return counts, nums, out


# the port's kernels by the names of their CUDA functions
OWN_KERNELS = (("H", "block_sweep_kernel"), ("A", "interp_multi_kernel"),
               ("D", "dft_kernel"), ("G", "peaks_"), ("C/E", "chain_kernel"),
               ("F", "top3_kernel"), ("I", "draws_kernel"))


def stream_profile(cfg, clip, calls=48):
    """Where a stream's time goes: `calls` process() calls of the stream
    (after output_seek and as many calls again to warm up) under
    torch.profiler.  Returns per block the wall ms, the card's busy ms
    (kernels and copies), the idle share, each of the port's kernels'
    device ms and PyTorch's own kernels (count, ms)."""
    name, tf, _ = cfg
    s = _stream_object(cfg)
    eng = s._stream()
    L = clip.shape[1]
    seek_len = s.output_seek_length(np.float32(1 / tf))
    s.output_seek(clip[:, :seek_len])
    step = int(round(STREAM_CHUNK / tf))
    chunks = [clip[:, seek_len + k * step:seek_len + (k + 1) * step]
              for k in range(2 * calls)]
    assert seek_len + 2 * calls * step <= L
    for c in chunks[:calls]:
        s.process(c, STREAM_CHUNK)
    b0 = eng.blocks
    _, wall, prof = profiled(lambda: [s.process(c, STREAM_CHUNK)
                                      for c in chunks[calls:]])
    blocks = eng.blocks - b0
    ev = profiler_events(prof, "CUDA")
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    own = {k: sum(e.time_range.elapsed_us() for e in ev if sub in e.name)
           / 1e3 / blocks for k, sub in OWN_KERNELS}
    other = [e for e in ev if not any(sub in e.name for _, sub in OWN_KERNELS)
             and "emcpy" not in e.name]
    copies = [e for e in ev if "emcpy" in e.name]
    out = dict(wall_ms=wall / blocks, busy_ms=busy / blocks,
               idle=1 - busy / wall,
               own_ms={k: v for k, v in own.items() if v},
               torch_kernels=len(other) / blocks,
               torch_ms=sum(e.time_range.elapsed_us() for e in other)
               / 1e3 / blocks, copies_a_call=len(copies) / calls)
    print(f"{name}: profile of {calls} calls, {blocks} blocks: a block "
          f"{out['wall_ms']:.3f} ms of wall (under the profiler), the card "
          f"busy {out['busy_ms']:.3f} ms, idle share {out['idle']:.3f}; "
          f"device ms a block by kernel "
          + ", ".join(f"{k} {v:.4f}" for k, v in out["own_ms"].items())
          + f"; PyTorch's kernels {out['torch_kernels']:.1f} a block, "
          f"{out['torch_ms']:.3f} ms; copies {out['copies_a_call']:.1f} a "
          f"call")
    return out


def check_streaming():
    """Phase 8 for every stream: the main-path run, the kernels at the
    stream's shapes, process_block and the first 0.5 s against the plain
    path.  Returns (summed launch counts, {kernel: one-row numbers})."""
    import torch
    clip = make_corpus(1, 2, int(RATE * SECONDS), RATE, seed=5)[0]
    launches, rows, outs = {}, {}, {}
    for cfg in STREAMS:
        name = cfg[0]
        counts, nums, outs[name] = run_stream(cfg, clip)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        stream_profile(cfg, clip)
        dbg, eng = check_stream_blocks(cfg, clip)
        for k, v in check_stream_kernels(name, dbg, eng, clip).items():
            rows.setdefault(k, {})[name] = v
        print(f"{name}: {stream_vs_plain(cfg, clip)}")
        del dbg, eng
        torch.cuda.empty_cache()
    a, b = (outs[c[0]] for c in STREAMS[1::2])
    if not np.array_equal(a, b):
        raise SystemExit(f"{STREAMS[3][0]}: stream differs from "
                         f"{STREAMS[1][0]}'s")
    print(f"{STREAMS[3][0]}: bit-identical to {STREAMS[1][0]}'s stream")
    return launches, rows


def random_sweep_inputs(ch, B, seed=0):
    """H's inputs on the card, random from a seed (a block's shapes)."""
    import torch
    from signalsmith_stretch_torch.ops import block_sweep
    rng = np.random.default_rng(seed)

    def c(*s):
        return (rng.standard_normal(s)
                + 1j * rng.standard_normal(s)).astype(np.complex64)

    arrs = (c(B), c(B), c(B), rng.uniform(0, 1, B).astype(np.float32), c(B),
            rng.integers(0, ch, B).astype(np.int32), c(ch, B), rng.uniform(
                0, 1, (ch, B)).astype(np.float32), c(ch, B))
    return block_sweep.BlockSweepInputs(*[torch.as_tensor(a, device=DEVICE)
                                          for a in arrs])


def floor_only():
    """`--block-sweep-floor`: build H's source and print its floor entry
    on a stream block's shapes (2 channels, 4096 bins), nothing else."""
    from signalsmith_stretch_torch.ops import _build
    header()
    secs, log = _build.build(["block_sweep"]).get("block_sweep", (0.0, ""))
    usage = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    print(f"built csrc/block_sweep.cu in {secs:.1f} s: {'; '.join(usage)}")
    x = random_sweep_inputs(2, 4096)
    ms, cyc = block_sweep_floor(x)
    print(f"chain_floor_ms {ms:.4f} for 4096 bins ({cyc:.1f} cycles a bin)")


def prior_block_sweep(path):
    """`--prior-block-sweep PATH`: H against an earlier H, its source at
    PATH with the same C entry `sst_block_sweep` (the one-warp H: tiles
    of up to 256 bins of every channel's inputs and a ring of outputs in
    shared memory, its tile and smem as its own tile_bins gave them), on
    the last checked block of the 1.25x and pitch+12 streams: both
    bit-equal to the plain version, then timed in turns (earlier, new,
    new, earlier), alone and back to back.  Prints one JSON line a
    stream."""
    import ctypes
    import torch
    from signalsmith_stretch_torch.ops import _build, block_sweep
    header()
    build_kernels()
    so = os.path.join(ROOT, "build", "prior", "libblock_sweep_prior.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(so).sst_block_sweep
    fn.argtypes, fn.restype = _build.ENTRY["block_sweep"][2], ctypes.c_int
    clip = make_corpus(1, 2, int(RATE * SECONDS), RATE, seed=5)[0]
    for cfg in STREAMS[:2]:
        dbg, eng = check_stream_blocks(cfg, clip)
        x, longv = dbg["sweep"], eng.consts.long_vertical_step
        ch, B = x.pe.shape
        tile = 256
        while 8 * (longv + 1) * ch + tile * (40 + 20 * ch) > \
                block_sweep.SMEM_MAX:
            tile -= 32
        smem = 8 * (longv + 1) * ch + tile * (40 + 20 * ch)

        def prior():
            out = torch.empty((ch, B), dtype=torch.complex64, device=DEVICE)
            _build.check(fn(*[t.data_ptr() for t in x], out.data_ptr(), ch,
                            B, longv, tile, smem,
                            torch.cuda.current_stream().cuda_stream),
                         "the earlier block sweep")
            return out

        def new():
            return block_sweep.block_sweep(x, longv)

        ref = block_sweep.block_sweep_plain(x, longv)
        for what, f in (("earlier", prior), ("new", new)):
            if not same_bits(torch.view_as_real(f()),
                             torch.view_as_real(ref)):
                raise SystemExit(f"{cfg[0]}: the {what} H differs from the "
                                 f"plain version")
        turns = []
        for what, f in (("earlier", prior), ("new", new), ("new", new),
                        ("earlier", prior)):
            turns.append((what, cuda_ms(f, KERNEL_REPS),
                          cuda_ms_b2b(f, KERNEL_REPS)))
        res = {w: dict(ms=[t[1] for t in turns if t[0] == w],
                       ms_b2b=[t[2] for t in turns if t[0] == w])
               for w in ("earlier", "new")}
        print(json.dumps({"stream": cfg[0], "shape": [ch, B],
                          "lead_changes": dbg["lead_changes"]} | res))


# an occupancy query for an earlier peaks.cu that has none, whose runs and
# out entries both allocate the one-launch G's Layout (the first split's)
PRIOR_PEAKS_PROBE = r"""
template <class Kernel>
static int prior_occupancy(Kernel kernel, int bytes, int* out) {
  int dev = 0, most = 0;
  cudaFuncAttributes a;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], kernel, PEAKS_THREADS, bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) out[1] = a.numRegs;
  return (int)err;
}
extern "C" int sst_peaks_split_occupancy(int B, int* out) {
  int err = prior_occupancy(peaks_runs_kernel<4, false>,
                            4 * Layout(B).words(), out);
  if (!err)
    err = prior_occupancy(peaks_out_kernel<4, false>, 4 * Layout(B).words(),
                          out + 2);
  return err;
}
"""
# the phases of the first split's timed entries, by their count
PRIOR_SPLIT_PHASES = {"runs": {4: ("wait", "flags", "runs", "write")},
                      "out": {3: ("peaks", "prefix", "map")}}


def prior_peaks_split(path):
    """`--prior-peaks-split PATH`: G's runs and out entries (and the
    one-launch G) against those of an earlier peaks.cu at PATH with the
    same C entries (with or without the row queue argument), built into
    build/prior/ and called through the same wrappers: on the pitch+12
    cell's planner rows and on peaks_edge_rows at B = 512, 1000, 4096 and
    8192 the earlier and the new entries bit-equal (runs: peak_in,
    avg_freq and n_peaks; out: the four planes on the runs' outputs
    through pitch+12's map as a callable; G: the four planes); then on the
    planner rows each timed in turns (earlier, new, new, earlier), alone
    and back to back, also at one row as in a stream block, beside the
    card's own streams over the same bytes (torch.add, zero_); each split
    entry's phase split (its timed entry), CTAs resident an SM and
    registers a thread.  Prints one JSON line."""
    import contextlib
    import ctypes
    import re
    import torch
    from signalsmith_stretch_torch.ops import _build, peaks
    header()
    build_kernels()
    src = open(path).read()
    d = os.path.join(ROOT, "build", "prior")
    os.makedirs(d, exist_ok=True)
    cu, so = os.path.join(d, "peaks_prior.cu"), os.path.join(
        d, "libpeaks_prior.so")
    with open(cu, "w") as f:
        f.write(src + ("" if "sst_peaks_split_occupancy" in src
                       else PRIOR_PEAKS_PROBE))
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"the earlier peaks.cu did not build:\n{r.stdout}"
                         f"{r.stderr}")
    lib = ctypes.CDLL(so)
    # the queue pointer's place in the new entries' arguments
    queue_arg = {"peaks_out": 11, "peaks_out_timed": 11}
    takes_queue = "int* queue" in src
    prior = {}
    for name in ("peaks", "peaks_runs", "peaks_runs_timed", "peaks_out",
                 "peaks_out_timed", "peaks_occupancy"):
        _, symbol, argtypes = _build.ENTRY[name]
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        if name in queue_arg and not takes_queue:
            i = queue_arg[name]
            fn.argtypes = argtypes[:i] + argtypes[i + 1:]
            fn = (lambda f, i: lambda *a: f(*a[:i], *a[i + 1:]))(fn, i)
        else:
            fn.argtypes = argtypes
        prior[name] = fn
    n_phases = {k: int(re.search(rf"#define {k.upper()}_PHASES (\d+)",
                                 src).group(1)) for k in ("runs", "out")}
    names = {k: PRIOR_SPLIT_PHASES[k].get(
        n, tuple(f"phase {i + 1}" for i in range(n)))
        for k, n in n_phases.items()}

    @contextlib.contextmanager
    def build_of(what):
        """The wrappers call the earlier entries inside `earlier`."""
        saved = dict(_build._entries)
        if what == "earlier":
            _build._entries.update(prior)
        try:
            yield
        finally:
            _build._entries.clear()
            _build._entries.update(saved)

    def prior_stamps(kind, launch, R):
        P = n_phases[kind]
        stamps = torch.zeros((R, P + 3), dtype=torch.int64, device=DEVICE)
        with build_of("earlier"):
            launch(stamps.data_ptr())
        return stamps[stamps[:, P + 1] > 0]

    model, _, _, dbg = mapped_planner()
    controls, consts = model.controls, model.plan.consts
    fmap = tonality_map(controls)
    energy, smoothed = dbg["energy"], dbg["smoothed"]
    tf, ltf = dbg["shifts"]
    cases = [("pitch+12 planner rows", energy, smoothed, tf, ltf)]
    for width in (512, 1000, 4096, 8192):
        e, s = (torch.as_tensor(a, device=DEVICE)
                for a in peaks_edge_rows(width))
        cases.append((f"edge rows at B = {width}", e, s, tf[:e.shape[0]],
                      ltf[:e.shape[0]]))
    for what, e, s, t1, t2 in cases:
        B = e.shape[1]
        outs = {}
        for build in ("earlier", "new"):
            with build_of(build):
                runs = peaks.peak_runs(e, s, consts)
                args = (runs[0], fmap(runs[1]), runs[2], t1, t2, B, consts)
                outs[build] = (runs, peaks.output_positions(*args),
                               peaks.peaks_positions(e, s, t1, t2, controls,
                                                     consts))
        for entry, new, old in zip(("runs", "out", "one-launch G"),
                                   outs["new"], outs["earlier"]):
            if not all(same_bits(a, b) for a, b in zip(new, old)):
                raise SystemExit(f"{what}: the {entry} entry differs from "
                                 f"the earlier one")
        print(f"G split against the earlier entries, {what} "
              f"{tuple(e.shape)}: runs, out and the one-launch G bit-equal")

    R, B = energy.shape
    runs = peaks.peak_runs(energy, smoothed, consts)
    mapped = fmap(runs[1])
    out_args = (runs[0], mapped, runs[2], tf, ltf, B, consts)
    one_args = (runs[0][:1], mapped[:1], runs[2][:1], tf[:1], ltf[:1], B,
                consts)
    map_args = (energy, smoothed, tf, ltf, controls, consts)
    calls = {
        "peaks_runs": lambda: peaks.peak_runs(energy, smoothed, consts),
        "peaks_out": lambda: peaks.output_positions(*out_args),
        "peaks_map": lambda: peaks.peaks_positions(*map_args),
        "peaks_runs one row": lambda: peaks.peak_runs(
            energy[:1], smoothed[:1], consts),
        "peaks_out one row": lambda: peaks.output_positions(*one_args)}
    turns = {}
    for name, f in calls.items():
        res = {"earlier": dict(ms=[], ms_b2b=[]),
               "new": dict(ms=[], ms_b2b=[])}
        for what in ("earlier", "new", "new", "earlier"):
            with build_of(what):
                res[what]["ms"].append(cuda_ms(f, KERNEL_REPS))
                res[what]["ms_b2b"].append(cuda_ms_b2b(f, KERNEL_REPS))
        turns[name] = res
        print(f"{name}: " + "; ".join(
            f"{w} alone {v['ms']}, back to back {v['ms_b2b']} ms"
            for w, v in res.items()))
    # the card's own streams over the same bytes, back to back: the runs
    # entry's two planes read and one plane's bytes written (torch.add), the
    # out entry's four planes written (zero_)
    total = torch.empty_like(energy)
    planes = torch.empty((R, 4, B), dtype=torch.float32, device=DEVICE)
    floors = {"peaks_runs": cuda_ms_b2b(
        lambda: torch.add(energy, smoothed, out=total), KERNEL_REPS),
        "peaks_out": cuda_ms_b2b(planes.zero_, KERNEL_REPS)}
    print(f"streams over the same bytes, back to back: torch.add of the two "
          f"planes {floors['peaks_runs']:.4f} ms, zero_ of four planes "
          f"{floors['peaks_out']:.4f} ms")
    del total, planes
    splits = {"earlier": {
        "peaks_runs": phase_split(
            lambda: prior_stamps("runs", lambda st: peaks._launch_runs(
                "peaks_runs_timed", energy, smoothed, consts, st), R),
            names["runs"], R, f"earlier G runs entry {(R, B)}"),
        "peaks_out": phase_split(
            lambda: prior_stamps("out", lambda st: peaks._launch_out(
                "peaks_out_timed", *out_args, st), R),
            names["out"], R, f"earlier G out entry {(R, B)}")}, "new": {
        "peaks_runs": phase_split(
            lambda: peaks.runs_stamps(energy, smoothed, consts),
            peaks.RUNS_PHASES, R, f"new G runs entry {(R, B)}"),
        "peaks_out": phase_split(lambda: peaks.out_stamps(*out_args),
                                 peaks.OUT_PHASES, R,
                                 f"new G out entry {(R, B)}")}}
    occ = {}
    for what in ("earlier", "new"):
        with build_of(what):
            occ[what] = peaks.split_occupancy(B)
        print(f"{what}: " + ", ".join(f"{k} {c} CTAs resident an SM, {g} "
                                      f"registers a thread"
                                      for k, (c, g) in occ[what].items()))
    bounds = split_bounds(energy, smoothed, int(runs[2].sum()),
                          tf.shape[0])
    print(smi_line())
    print(json.dumps({"prior_peaks_split": path, "shape": [R, B],
                      "bound_ms": {k: v[0] for k, v in bounds.items()},
                      "turns": turns, "stream_ms": floors,
                      "occupancy": occ,
                      "phases": {w: {k: v["phases"] for k, v in d.items()}
                                 for w, d in splits.items()},
                      "spread_us": {w: {k: [v["starts_us"], v["ends_us"]]
                                        for k, v in d.items()}
                                    for w, d in splits.items()}}))


# ---------------------------------------------------------------------------
# Phase 9: the scheduler (StretchNode) and the worklet host (WorkletHost)
# ---------------------------------------------------------------------------
NODE_QUANTUM = 128
NODE_SECONDS = 5.0
NODE_GATE_SECONDS = 0.5      # the kernels' node against the plain path
LIVE_SECONDS = 2.0
HOST_SECONDS = 2.0
QUANTUM_BUDGET_MS = 1e3 * NODE_QUANTUM / RATE      # 2.667 ms at 48 kHz
# examples/scheduled_playback.py's schedule at full width, every segment
# at its output time, and a vocal-tuner segment after it: half speed from
# 0 s; input 2 s at 1.0x, +5 st with the 8 kHz limit; a loop of 0.5-1.5 s
# at 0.8x for 2 s; then formant +3 st with compensation, the base
# estimated (with the +5 st map): D, A, H, C, G, E and F all launch
NODE_SCHEDULE = (
    dict(output=0.0, input=0.0, rate=0.5),
    dict(output=1.0, input=2.0, rate=1.0, semitones=5, tonality_hz=8000),
    dict(output=2.0, input=0.5, rate=0.8, loop_start=0.5, loop_end=1.5),
    dict(output=4.0, input=4.0, rate=1.0, semitones=5, tonality_hz=8000,
         formant_semitones=3, formant_compensation=True, formant_base_hz=0),
)
NODE_KERNELS = ("dft", "interp_multi", "block_sweep", "iir", "peaks_map",
                "decay", "top3")


def _scheduled_node(clip, device=None, plain=False):
    """A StretchNode (default preset, stereo 48 kHz, 128-sample quanta) with
    the clip in its store and NODE_SCHEDULE scheduled, on `device` (by
    default DEVICE)."""
    from signalsmith_stretch_torch.scheduler import StretchNode
    node = StretchNode(RATE, channels=2, quantum=NODE_QUANTUM,
                       preset="default", device=device or DEVICE,
                       plain=plain)
    node.add_buffers(clip)
    for seg in NODE_SCHEDULE:
        node.schedule(**seg)
    return node


class SyncCounter:
    """Synchronising calls under torch.cuda.set_sync_debug_mode("warn"):
    in all, and inside StreamingStretch._seek and _process (the loop body
    of process_many and process_many_live)."""

    def __enter__(self):
        import torch
        import warnings
        from signalsmith_stretch_torch.streaming import StreamingStretch
        self._cls, self.inside = StreamingStretch, 0
        self._caught = warnings.catch_warnings(record=True)
        self.caught = self._caught.__enter__()
        warnings.simplefilter("always")
        self._orig = {n: getattr(StreamingStretch, n)
                      for n in ("_seek", "_process")}

        def counted(fn):
            def wrapper(*a, **k):
                n0 = len(self.caught)
                r = fn(*a, **k)
                self.inside += len(self.caught) - n0
                return r
            return wrapper

        for n, fn in self._orig.items():
            setattr(StreamingStretch, n, counted(fn))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode("default")
        for n, fn in self._orig.items():
            setattr(self._cls, n, fn)
        self.total = sum("synchroniz" in str(w.message) for w in self.caught)
        self._caught.__exit__(*exc)


def node_per_quantum(clip, seconds):
    """The node rendered quantum by quantum, each process_quantum() timed
    on the host's clock (it returns numpy, so each waits for its quantum).
    Returns (output, ms of each quantum)."""
    node = _scheduled_node(clip)
    outs, times = [], []
    for _ in range(int(round(seconds * RATE / NODE_QUANTUM))):
        t0 = time.perf_counter()
        outs.append(node.process_quantum())
        times.append(1e3 * (time.perf_counter() - t0))
    return np.concatenate(outs, 1), times


def check_node_vs_plain(clip):
    """The first NODE_GATE_SECONDS through the kernels against the plain
    path on the CPU: bit-equal, or within 12 dB of the plain node's own
    response to a 1-ulp change of its store (up or down, the larger), band
    energies within 3 dB."""
    k = _scheduled_node(clip).render(NODE_GATE_SECONDS)

    def plain(x):
        return _scheduled_node(x, "cpu", plain=True).render(NODE_GATE_SECONDS)

    p = plain(clip)
    if np.array_equal(k, p):
        return f"first {NODE_GATE_SECONDS:g} s bit-equal to the plain path"
    sens = [rel_err_db(plain(np.nextafter(clip, np.float32(way))), p)
            for way in (np.inf, -np.inf)]
    dev_db = rel_err_db(k, p)
    band = np.abs(band_energy_db(k) - band_energy_db(p)).max()
    if not (np.isfinite(k).all() and dev_db < max(sens) + 12.0
            and band <= 3.0):
        raise SystemExit(f"node: the first {NODE_GATE_SECONDS:g} s through "
                         f"the kernels {dev_db:.1f} dB from the plain path "
                         f"(1-ulp sensitivity {sens[0]:.1f} / {sens[1]:.1f} "
                         f"dB), band energies within {band:.2f} dB")
    return (f"first {NODE_GATE_SECONDS:g} s {dev_db:.1f} dB from the plain "
            f"path on the CPU, its 1-ulp sensitivity {sens[0]:.1f} (up) / "
            f"{sens[1]:.1f} (down) dB, band energies within {band:.2f} dB")


def check_worklet(clip, want):
    """WorkletHost on the card with NODE_SCHEDULE, HOST_SECONDS pulled
    with batch_quanta 1 and 8: each bit-equal to `want` (the node driven
    directly); the render thread's ms a quantum (the consumer's wall time
    over the quanta, the ring holding 8).  Returns {batch_quanta: ms}."""
    from signalsmith_stretch_torch.worklet import WorkletHost
    n = int(round(HOST_SECONDS * RATE / NODE_QUANTUM))
    ms = {}
    for batch in (1, 8):
        host = WorkletHost(RATE, channels=2, quantum=NODE_QUANTUM,
                           preset="default", buffer_quanta=8,
                           batch_quanta=batch, device=DEVICE)
        try:
            host.add_buffers(clip)
            for seg in NODE_SCHEDULE:
                host.schedule(**seg)
            t0 = time.perf_counter()
            host.resume()
            got = host.read(n, timeout=300.0)
            ms[batch] = 1e3 * (time.perf_counter() - t0) / n
        finally:
            host.close()
        if not np.array_equal(got, want[:, :n * NODE_QUANTUM]):
            raise SystemExit(f"worklet (batch_quanta {batch}): differs from "
                             f"the node driven directly")
    return ms


def check_scheduler():
    """Phase 9.  Returns the launch counts of the per-quantum render."""
    import torch
    t0 = time.perf_counter()
    clip = make_corpus(1, 2, int(RATE * SECONDS), RATE, seed=5)[0]
    _scheduled_node(clip).render(NODE_SECONDS, batched=True)    # set-up
    reset_counters()
    with SyncCounter() as sq:
        out, times = node_per_quantum(clip, NODE_SECONDS)
    counts = counters()
    quanta = len(times)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with SyncCounter() as sb:
        batched = _scheduled_node(clip).render(NODE_SECONDS, batched=True)
    batched_ms = 1e3 * (time.perf_counter() - t1)
    if not np.array_equal(out, batched):
        raise SystemExit("node: render(batched=True) differs from the "
                         "quantum-by-quantum render")
    if sb.inside or sq.inside:
        raise SystemExit(f"node: {sb.inside} synchronising calls inside the "
                         f"process_many loop, {sq.inside} inside the "
                         f"per-quantum seek/process")
    missing = [k for k in NODE_KERNELS if counts[k] < 1]
    if missing or not np.isfinite(out).all():
        raise SystemExit(f"node: kernels never launched {missing}, or the "
                         f"output is not finite")
    med = statistics.median(times)
    p99 = float(np.percentile(times, 99))
    print(f"node (scheduler): {NODE_SECONDS:g} s stereo {RATE} Hz, "
          f"{quanta} quanta of {NODE_QUANTUM} (schedule: 0.5x, then +5 st "
          f"8 kHz from input 2 s, a 0.5-1.5 s loop at 0.8x, formant +3 st "
          f"with compensation, base estimated): a quantum median "
          f"{med:.3f} ms, p99 {p99:.3f} ms, budget {QUANTUM_BUDGET_MS:.3f} "
          f"ms; {sum(times):.1f} ms in all, realtime factor "
          f"{NODE_SECONDS / (sum(times) / 1e3):.2f}x; batched "
          f"(render(batched=True), one process_many a segment run) "
          f"{batched_ms:.1f} ms, realtime factor "
          f"{NODE_SECONDS / (batched_ms / 1e3):.2f}x, bit-equal; launches "
          f"{ {k: v for k, v in counts.items() if v} }; synchronising calls "
          f"{sq.total} per-quantum ({sq.total / quanta:.2f} a quantum, "
          f"{sq.inside} inside seek/process), {sb.total} batched "
          f"({sb.inside} inside the process_many loop)")
    print(f"node: {check_node_vs_plain(clip)}")

    live_in = clip[:, :int(LIVE_SECONDS * RATE)]
    lives = {}
    for batched in (False, True):
        from signalsmith_stretch_torch.scheduler import StretchNode
        node = StretchNode(RATE, channels=2, quantum=NODE_QUANTUM,
                           preset="default", device=DEVICE)
        node.start(rate=1.0)
        t2 = time.perf_counter()
        lives[batched] = node.render(LIVE_SECONDS, live_input=live_in,
                                     batched=batched)
        lives[batched, "ms"] = 1e3 * (time.perf_counter() - t2)
    if not np.array_equal(lives[False], lives[True]):
        raise SystemExit("node live input: batched differs from quantum by "
                         "quantum")
    print(f"node live input: {LIVE_SECONDS:g} s at 1.0x, quantum by quantum "
          f"{lives[False, 'ms']:.1f} ms, batched {lives[True, 'ms']:.1f} "
          f"ms, bit-equal")
    host_ms = check_worklet(clip, out)
    print(f"worklet: {HOST_SECONDS:g} s pulled through the render thread, "
          f"bit-equal to the node driven directly with batch_quanta 1 and "
          f"8; the render thread's ms a quantum {host_ms[1]:.3f} (1) and "
          f"{host_ms[8]:.3f} (8), budget {QUANTUM_BUDGET_MS:.3f} ms")
    print(f"phase 9 (scheduler and worklet): "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 10: the corpus pipeline and the parallel layer
# ---------------------------------------------------------------------------
CORPUS_CLIPS = 16
CORPUS_BATCH = 8
CORPUS_SETTINGS = (dict(time_factor=1.25), dict(semitones=5.0))
LONG_SECONDS = 60.0
LONG_CHUNKS = 8


def write_corpus(directory):
    """CORPUS_CLIPS stereo 48 kHz WAVs of 5 to 10 s, each channel one kind
    of utils/evaluation.synth_clip (a pair of kinds a clip).  Half the
    clips last 5.125-6 s and half 9.125-10 s, so that the whole-second
    buckets hold CORPUS_BATCH clips each and every batch is full."""
    from signalsmith_stretch_torch.io import write_wav
    from signalsmith_stretch_torch.utils import evaluation
    os.makedirs(directory, exist_ok=True)
    kinds = evaluation.KINDS
    full = {k: evaluation.synth_clip(k, RATE, 10.0)[0] for k in kinds}
    paths = []
    for i in range(CORPUS_CLIPS):
        half = CORPUS_CLIPS // 2
        n = int(RATE * (5.0 + 4.0 * (i >= half)
                        + (i % half + 1) / half))
        a, b = kinds[i % len(kinds)], kinds[(i + 3) % len(kinds)]
        path = os.path.join(directory, f"clip{i:02d}_{a}_{b}.wav")
        write_wav(path, np.stack([full[a][:n], full[b][:n]]), RATE)
        paths.append(path)
    return paths


def _bucket_model(key, cache):
    from signalsmith_stretch_torch.models import StretchModel
    if key not in cache:
        rate, ch, in_len, tf, st = key
        cache[key] = StretchModel.build(
            ch, rate, in_len, int(round(in_len * tf)), semitones=st,
            tonality_hz=8000 if st else 0, device=DEVICE)
    return cache[key]


def corpus_pass(items, mesh, models, check=False):
    """One pass of the corpus: load_directory's items -> batches -> the
    bucket's batch_render over the mesh, outputs to the host.  A batch is
    padded with silent clips to a multiple of the mesh's devices.
    check=True holds each batch bit-equal to StretchModel.batched on the
    same padded batch and seeds.  Returns (wall ms, batch sizes)."""
    import torch
    from signalsmith_stretch_torch.io import corpus
    from signalsmith_stretch_torch.parallel import batch as pbatch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sizes = []
    for b in corpus.batches(items, CORPUS_BATCH, device=mesh[0]):
        model = _bucket_model(b["key"], models)
        audio = b["audio"]
        rem = (-audio.shape[0]) % len(mesh)
        if rem:
            audio = torch.cat([audio, audio.new_zeros(
                (rem,) + tuple(audio.shape[1:]))])
        seeds = np.arange(audio.shape[0])
        run = pbatch.batch_render(model.plan, model.flags, mesh=mesh)
        out = run(audio, model.controls, seeds).cpu().numpy()
        sizes.append(len(b["names"]))
        if check:
            want = model.batched(audio, seeds).cpu().numpy()
            if not np.array_equal(out, want) or not np.isfinite(out).all():
                raise SystemExit(f"corpus: batch {b['key']} differs from "
                                 f"StretchModel.batched")
    return 1e3 * (time.perf_counter() - t0), sizes


def check_corpus(mesh):
    """The corpus through the pipeline twice: a first pass that builds the
    plans and holds every batch to StretchModel.batched, then the timed
    pass (its realtime factor, peak memory and launches)."""
    import torch
    from signalsmith_stretch_torch.io import corpus
    paths = write_corpus(os.path.join(ROOT, "build", "corpus"))
    items = []
    for kw in CORPUS_SETTINGS:
        items += corpus.load_directory(paths, **kw)
    seconds = sum(it.seconds for it in items)
    models = {}
    first_ms, sizes = corpus_pass(items, mesh, models, check=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    ms, _ = corpus_pass(items, mesh, models)
    counts = counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"corpus: {len(paths)} stereo {RATE} Hz WAVs of 5-10 s "
          f"(synth_clip kinds in pairs) at 1.25x and at +5 st (8 kHz "
          f"limit): {len(items)} items, {seconds:.1f} s of input, "
          f"{len(sizes)} batches of {sizes} clips in {len(models)} buckets "
          f"(batch_size {CORPUS_BATCH}) over "
          f"{len(mesh)} device(s): each batch bit-equal to "
          f"StretchModel.batched; first pass (plans built) {first_ms:.1f} "
          f"ms; {ms:.1f} ms a pass, realtime factor "
          f"{seconds / (ms / 1e3):.1f}x; peak memory {peak:.2f} GiB; "
          f"launches a pass { {k: v for k, v in counts.items() if v} }")
    return counts


def check_timechunk(mesh):
    """A LONG_SECONDS stereo clip at 1.25x as LONG_CHUNKS chunks
    (stretch_long over the mesh) against the monolithic render: envelopes
    within 1.5 dB away from the seams, the first chunk within -19 dB (the
    JAX package's gates, tests/test_sharding.py:45-84)."""
    import torch
    from signalsmith_stretch_torch import spectral
    from signalsmith_stretch_torch.models import StretchModel
    from signalsmith_stretch_torch.parallel.timechunk import stretch_long
    clip = make_corpus(1, 2, int(RATE * LONG_SECONDS), RATE, seed=6)[0]
    out_samples = int(round(clip.shape[1] * 1.25))
    cfg_model = StretchModel.build(2, RATE, clip.shape[1], out_samples,
                                   device=DEVICE)

    def chunked():
        return stretch_long(clip, out_samples, cfg_model.cfg,
                            spectral.Controls.make(),
                            spectral.SpectralFlags(False),
                            n_chunks=LONG_CHUNKS, mesh=mesh)

    def mono():
        return cfg_model(clip).cpu().numpy()

    walls = {}
    for name, fn in (("chunked", chunked), ("monolithic", mono)):
        t0 = time.perf_counter()
        fn()
        first = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        walls[name] = (fn(), first, 1e3 * (time.perf_counter() - t0))
    c, m = walls["chunked"][0], walls["monolithic"][0]
    win = RATE // 50
    n = out_samples // win

    def env(x):
        return np.sqrt(np.mean(x[:, :n * win].reshape(2, n, win) ** 2,
                               axis=(0, 2)))

    ratio_db = 20 * np.log10((env(c) + 1e-9) / (env(m) + 1e-9))
    per = -(-out_samples // LONG_CHUNKS)
    seam = {k * per // win + d for k in range(1, LONG_CHUNKS)
            for d in (-1, 0, 1)}
    keep = [i for i in range(1, n - 1) if i not in seam]
    env_db = float(np.max(np.abs(ratio_db[keep])))
    db0 = rel_err_db(c[:, 2000:per - 8], m[:, 2000:per - 8])
    if not (np.isfinite(c).all() and env_db < 1.5 and db0 < -19):
        raise SystemExit(f"time chunks: envelopes within {env_db:.2f} dB "
                         f"away from the seams, first chunk {db0:.1f} dB")
    print(f"time chunks: {LONG_SECONDS:g} s stereo {RATE} Hz at 1.25x as "
          f"{LONG_CHUNKS} chunks over {len(mesh)} device(s): envelopes "
          f"within {env_db:.2f} dB of the monolithic render away from the "
          f"seams, the first chunk {db0:.1f} dB; wall ms chunked "
          f"{walls['chunked'][2]:.1f} (first call {walls['chunked'][1]:.1f}),"
          f" monolithic {walls['monolithic'][2]:.1f} (first call "
          f"{walls['monolithic'][1]:.1f})")
    del cfg_model
    torch.cuda.empty_cache()


def check_distributed(mesh):
    """parallel.distributed in single-process mode on the card:
    initialize() is False, and a batch through global_batch and allgather
    comes back bit-equal."""
    from signalsmith_stretch_torch.parallel import distributed as dist
    if dist.initialize() is not False or dist.process_count() != 1:
        raise SystemExit("distributed: initialize() without a coordinator "
                         "is not single-process")
    local = make_corpus(2 * len(mesh), 2, RATE, RATE, seed=7)
    back = dist.allgather(dist.global_batch(local, dist.global_mesh()))
    if not np.array_equal(back, local):
        raise SystemExit("distributed: global_batch -> allgather differs")
    print(f"distributed: single-process (initialize() False), "
          f"global_batch -> allgather of {local.shape} over "
          f"{len(dist.global_mesh())} device(s) bit-equal")


def check_parallel():
    """Phase 10.  Returns the launch counts of the corpus's timed pass."""
    from signalsmith_stretch_torch.parallel import batch as pbatch
    t0 = time.perf_counter()
    mesh = pbatch.make_mesh()
    counts = check_corpus(mesh)
    check_timechunk(mesh)
    check_distributed(mesh)
    print(f"phase 10 (corpus and parallel): "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def main():
    import torch
    import signalsmith_stretch_torch  # noqa: F401  (fails outside a checkout)
    if sys.argv[1:] == ["--block-sweep-floor"]:
        return floor_only()
    if sys.argv[1:2] == ["--prior-block-sweep"] and len(sys.argv) == 3:
        return prior_block_sweep(sys.argv[2])
    if sys.argv[1:2] == ["--prior-peaks-split"] and len(sys.argv) == 3:
        return prior_peaks_split(sys.argv[2])
    if sys.argv[1:] == ["--coefficients"]:
        header()
        build_kernels()
        coefficients_only()
        return print(smi_line())
    if sys.argv[1:] == ["--synthesis"]:
        header()
        build_kernels()
        check_synthesis((BATCH, 32))
        return print(smi_line())
    if sys.argv[1:] == ["--scheduler-parallel"]:
        header()
        build_kernels()
        check_scheduler()
        check_parallel()
        return print(smi_line())
    t_start = time.perf_counter()
    header()
    build_kernels()
    entries = check_kernels()
    random_interp, random_draws = check_random_interp()
    entries["draws"] = random_draws[RANDOM[0]]
    entries.update(check_synthesis())
    launches = {name: 0 for name, _, _ in KERNELS}
    for counted in [render_config(cfg) for cfg in CONFIGS] + [
            check_automation()]:
        for k, v in counted.items():
            launches[k] += v
    check_cli()
    check_cli_dev()
    t_stream = time.perf_counter()
    counted, stream_rows = check_streaming()
    for k, v in counted.items():
        launches[k] += v
    print(f"streaming phase: {time.perf_counter() - t_stream:.1f} s of "
          f"{time.perf_counter() - t_start:.1f} s so far")
    for counted in (check_scheduler(), check_parallel()):
        for k, v in counted.items():
            launches[k] += v
    entries["block_sweep"] = stream_rows["block_sweep"][STREAMS[1][0]]
    table = []
    for name, source, replaces in KERNELS:
        e = entries[name]
        table.append(dict(name=name, route="cuda", source=source,
                          replaces=replaces, launches=launches[name],
                          max_abs_err=e["max_abs_err"], ms=e["ms"],
                          ms_b2b=e["ms_b2b"], plain_ms=e["plain_ms"],
                          bound_ms=e["bound"][0], bound_by=e["bound"][1],
                          library_ms=e.get("library_ms"),
                          chain_ms=e.get("chain_ms"),
                          chain_floor_ms=e.get("chain_floor_ms"))
                     | {k: e[k] for k in ("phases", "ctas_per_sm",
                                          "registers", "cells") if k in e})
    # each kernel at the stream's shapes (one row), by stream
    for t in table:
        rows = stream_rows.get("peaks_split" if t["name"] == "peaks_runs"
                               else t["name"], {})
        if rows:
            t["one_row"] = {
                stream: {k: v for k, v in e.items() if k != "bound"}
                | {"bound_ms": e["bound"][0], "bound_by": e["bound"][1]}
                for stream, e in rows.items()}
    table[0]["random_sets"] = {
        name: {k: v for k, v in e.items() if k != "bound"}
        | {"bound_ms": e["bound"][0]} for name, e in random_interp.items()}
    next(t for t in table if t["name"] == "draws")["cells"] = {
        name: {k: v for k, v in e.items() if k != "bound"}
        | {"bound_ms": e["bound"][0], "bound_by": e["bound"][1]}
        for name, e in random_draws.items()}
    missing = [t["name"] for t in table if t["launches"] < 1]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: {missing}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
