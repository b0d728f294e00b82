#!/usr/bin/env python3
"""Time kernels D (the analysis DFT), B (the diagonal sweep) and G (the
peaks and output map) of the PyTorch port alone, at the shapes of
chip_smoke.py, on one NVIDIA GPU.

    python3 tools/time_torch_kernels.py [--kernels dft,sweep,peaks]
                                        [--sweep-plain] [--prior-peaks FILE]

Builds the named kernels' sources (printing what ptxas reports), then: D on
the 1.25x render's 13,376 frames against the plain analysis (cuFFT, 3e-6 of
the peak) and the bare torch.fft.fft call; B on the pitch+12 render's
planner inputs, bit-equal to the plain sweep when --sweep-plain is given
(the plain sweep takes seconds); G on the same render's energy and smoothed
curve, timed and split by phase through its timed entry
(chip_smoke.peaks_phase_split).  --prior-peaks FILE takes the earlier
one-CTA-a-row csrc/peaks.cu (the kernel before its persistent redesign:
`git show 904a72e:signalsmith_stretch_torch/csrc/peaks.cu > FILE`), builds
it as it is and with clock64() stamps at its barriers
(`instrument_prior_peaks`), holds its two planes bit-equal to G's input bin
and freq_grad, and times and splits it on the same rows.  Times are medians
of CUDA events, one launch each, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="dft,sweep",
                    help="comma-separated: dft, sweep, peaks")
    ap.add_argument("--sweep-plain", action="store_true",
                    help="hold B bit-equal to the plain sweep")
    ap.add_argument("--prior-peaks", metavar="FILE",
                    help="the one-CTA-a-row csrc/peaks.cu to time and split "
                    "beside G (implies --kernels ...,peaks)")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if args.prior_peaks and "peaks" not in kernels:
        kernels.append("peaks")
    import torch
    from signalsmith_stretch_torch.ops import _build
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: torch.cuda.is_available() is "
                         "false")
    print(cs.smi_line())
    for name, (secs, log) in _build.build(kernels).items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built csrc/{name}.cu in {secs:.1f} s: {'; '.join(usage)}")

    if "dft" in kernels:
        time_dft()
    if "sweep" in kernels or "peaks" in kernels:
        time_mapped(kernels, args.sweep_plain, args.prior_peaks)


PRIOR_PHASES = ("load", "run tables", "sums", "histogram zeroing",
                "histogram atomics", "prefix", "map")


def _replace_once(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"instrument_prior_peaks: {old!r} found "
                         f"{text.count(old)} times, not once")
    return text.replace(old, new)


def instrument_prior_peaks(src):
    """The one-CTA-a-row csrc/peaks.cu (its text) with the stamps of G's
    timed entry: thread 0 of each CTA writes the clock64() cycles of each of
    PRIOR_PHASES (from the previous stamp to the barrier that ends it; a
    barrier is added after the map) into stamps[row, phase], then its start
    and end on the global timer (ns) and its SM.  sst_peaks_map takes the
    stamps [R, len(PRIOR_PHASES) + 3] int64 before its stream."""
    P = len(PRIOR_PHASES)
    head = ("__global__ void __launch_bounds__(PEAKS_THREADS)\n"
            "peaks_map_kernel(")
    start = src.index(head)
    end = src.index("\n}\n", start) + 3            # the kernel's last line
    body = src[start:end]
    body = _replace_once(
        body, "float above_off) {\n  extern __shared__ float smem[];\n",
        "float above_off,\n                 long long* stamps) {\n"
        "  extern __shared__ float smem[];\n"
        "  const unsigned long long gt0 = threadIdx.x ? 0 : global_ns();\n"
        "  long long clk = clock64();\n")
    parts = body.split("\n  __syncthreads();\n")
    if len(parts) != P:
        raise SystemExit(f"instrument_prior_peaks: {len(parts) - 1} "
                         f"barriers in the kernel, {P - 1} expected")
    body = "".join(part + f"\n  __syncthreads();\n  STAMP({i + 1})\n"
                   for i, part in enumerate(parts[:-1])) + parts[-1]
    body = body[:-2] + (
        f"  __syncthreads();\n  STAMP({P})\n"
        f"  if (threadIdx.x == 0) {{\n"
        f"    unsigned smid;\n"
        f"    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
        f"    long long* st = stamps + blockIdx.x * {P + 3};\n"
        f"    st[{P}] = (long long)gt0;\n"
        f"    st[{P + 1}] = (long long)global_ns();\n"
        f"    st[{P + 2}] = smid;\n  }}\n}}\n")
    stamp = (
        "__device__ __forceinline__ unsigned long long global_ns() {\n"
        "  unsigned long long t;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
        "  return t;\n}\n\n"
        "#define STAMP(i)                                                \\\n"
        "  if (threadIdx.x == 0) {                                       \\\n"
        "    const long long c = clock64();                              \\\n"
        f"    stamps[blockIdx.x * {P + 3} + (i) - 1] = c - clk;            "
        "\\\n"
        "    clk = c;                                                    \\\n"
        "  }\n\n")
    tail = _replace_once(src[end:], "float above_off,\n", "float above_off,"
                         " long long* stamps,\n")
    tail = _replace_once(tail, "      above_off);\n",
                         "      above_off, stamps);\n")
    return src[:start] + stamp + body + tail


def build_prior_peaks(path):
    """Build the one-CTA-a-row peaks source at `path` as it is and
    instrumented, with the port's nvcc flags, into build/torch_kernels/.
    Returns (plain entry, timed entry)."""
    from signalsmith_stretch_torch.ops import _build
    src = open(path).read()
    out = _build.BUILD_DIR / "prior_peaks"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, text in (("plain", src), ("timed", instrument_prior_peaks(src))):
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        procs.append((so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = []
    for (so, proc), extra in zip(procs, ([], [ctypes.c_void_p])):
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {so.name}:\n{log}")
        fn = ctypes.CDLL(str(so)).sst_peaks_map
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 3 + extra + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def time_prior_peaks(path, e, s, pos, freq_grad, controls, consts):
    """The one-CTA-a-row G at `path` on G's rows: its input bin and
    freq_grad bit-equal to G's pos[:, 0] and freq_grad, its time alone and
    back to back, and its phase split."""
    import numpy as np
    import torch
    plain, timed = build_prior_peaks(path)
    R, B = e.shape
    limit = np.float32(controls.freq_tonality_limit)
    mult = np.float32(controls.freq_multiplier)
    above_off = np.float32(np.float32(mult - np.float32(1)) * limit)
    ib, grad = torch.empty_like(e), torch.empty_like(e)

    def run(fn, *extra):
        rc = fn(e.data_ptr(), s.data_ptr(), ib.data_ptr(), grad.data_ptr(),
                R, B, consts.fft_samples, float(limit), float(mult),
                float(above_off), *extra,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"prior peaks kernel: CUDA error {rc}")

    run(plain)
    torch.cuda.synchronize()
    if not (cs.same_bits(ib, pos[:, 0]) and cs.same_bits(grad, freq_grad)):
        raise SystemExit("prior peaks kernel: its planes differ from G's")
    ms = cs.cuda_ms(lambda: run(plain), cs.KERNEL_REPS)
    b2b = cs.cuda_ms_b2b(lambda: run(plain), cs.KERNEL_REPS)
    print(f"prior G ({path}): {tuple(e.shape)}: input bin and freq_grad "
          f"bit-equal to G's; {ms:.4f} ms a launch alone, {b2b:.4f} ms back "
          f"to back")
    P = len(PRIOR_PHASES)

    def stamps():
        st = torch.zeros((R, P + 3), dtype=torch.int64, device=e.device)
        run(timed, st.data_ptr())
        return st

    cs.phase_split(stamps, PRIOR_PHASES, R,
                   f"prior G phase split {tuple(e.shape)}")


def time_dft():
    import torch
    import torch.nn.functional as F
    from signalsmith_stretch_torch import stft
    from signalsmith_stretch_torch.ops import dft
    frames, basis = cs.analysis_frames(cs.STRETCH)
    got = dft.analyze(frames, basis)
    ref = stft.analyze_plain(frames, basis)
    err = cs.max_abs(got, ref) / float(ref.abs().max())
    nF, block = frames.shape
    ms = cs.cuda_ms(lambda: dft.analyze(frames, basis), cs.KERNEL_REPS)
    plain = cs.cuda_ms(lambda: stft.analyze_plain(frames, basis),
                       cs.KERNEL_REPS)
    z = F.pad(frames * torch.as_tensor(basis.window, device=cs.DEVICE),
              (0, basis.fft_samples - block)) * torch.as_tensor(
                  basis.twist, device=cs.DEVICE)
    lib = cs.cuda_ms(lambda: torch.fft.fft(z, dim=-1), cs.KERNEL_REPS)
    nbytes = nF * (4 * block + 8 * basis.bands)
    print(f"D: {nF} frames: {ms:.4f} ms ({1e6 * ms / nF:.1f} ns a frame, "
          f"{1e-6 * nbytes / ms:.0f} GB/s), plain {plain:.4f} ms, "
          f"torch.fft.fft {lib:.4f} ms, bound "
          f"{cs.bound_ms(nbytes, 0)[0]:.4f} ms; error {err:.3g} of the peak")
    del frames, got, ref, z
    torch.cuda.empty_cache()


def time_mapped(kernels, sweep_plain, prior_peaks=None):
    import torch
    from signalsmith_stretch_torch import engine, planner, wavefront
    from signalsmith_stretch_torch.ops import peaks
    model, clips = cs._model(cs.MAPPED, cs.BATCH)
    plan = model.plan
    spectra, prev = engine.analyze_stage(torch.as_tensor(
        clips, device=cs.DEVICE), plan)
    inputs, dbg = planner.plan_spectral(spectra, prev, plan.arrays,
                                        model.controls, model.flags,
                                        plan.consts, debug=True)
    if "peaks" in kernels:
        e, s = dbg["energy"], dbg["smoothed"]
        args = (e, s, *dbg["shifts"], model.controls, plan.consts)
        ms = cs.cuda_ms(lambda: peaks.peaks_positions(*args), cs.KERNEL_REPS)
        b2b = cs.cuda_ms_b2b(lambda: peaks.peaks_positions(*args),
                             cs.KERNEL_REPS)
        print(f"G: {tuple(e.shape)}: {ms:.4f} ms a launch alone, {b2b:.4f} "
              f"ms back to back")
        cs.peaks_phase_split(*args)
        if prior_peaks:
            time_prior_peaks(prior_peaks, e, s, *peaks.peaks_positions(*args),
                             model.controls, plan.consts)
    if "sweep" not in kernels:
        return
    longv = plan.consts.long_vertical_step
    _, nB, B = inputs.a1.shape
    threads, sigma, diagonals = wavefront.sweep_schedule(nB, B, longv)
    ms = cs.cuda_ms(lambda: wavefront.sweep(inputs, longv), 5)
    gate = ""
    if sweep_plain:
        same = torch.equal(wavefront.sweep(inputs, longv),
                           wavefront.sweep_plain(inputs, longv))
        gate = "; bit-equal to the plain sweep" if same else \
            "; DIFFERS from the plain sweep"
    print(f"B: {tuple(inputs.a1.shape)}, LV {longv}, {threads} threads, "
          f"step {sigma}, {diagonals} diagonals: {ms:.4f} ms "
          f"({1e6 * ms / diagonals:.1f} ns a diagonal){gate}")
    if gate.startswith("; DIFFERS"):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
