#!/usr/bin/env python3
"""Time kernels D (the analysis DFT) and B (the diagonal sweep) of the
PyTorch port alone, at the shapes of chip_smoke.py, on one NVIDIA GPU.

    python3 tools/time_torch_kernels.py [--sweep-plain]

Builds csrc/dft.cu and csrc/sweep.cu (printing what ptxas reports), then:
D on the 1.25x render's 13,376 frames against the plain analysis (cuFFT,
3e-6 of the peak) and the bare torch.fft.fft call; B on the pitch+12
render's planner inputs, bit-equal to the plain sweep when --sweep-plain is
given (the plain sweep takes seconds).  Times are medians of CUDA events,
one launch each, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep-plain", action="store_true",
                    help="hold B bit-equal to the plain sweep")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from signalsmith_stretch_torch import engine, planner, stft, wavefront
    from signalsmith_stretch_torch.ops import _build, dft
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: torch.cuda.is_available() is "
                         "false")
    print(cs.smi_line())
    for name, (secs, log) in _build.build(["dft", "sweep"]).items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built csrc/{name}.cu in {secs:.1f} s: {'; '.join(usage)}")

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

    model, clips = cs._model(cs.MAPPED, cs.BATCH)
    plan = model.plan
    spectra, prev = engine.analyze_stage(torch.as_tensor(
        clips, device=cs.DEVICE), plan)
    inputs = planner.plan_spectral(spectra, prev, plan.arrays,
                                   model.controls, model.flags, plan.consts)
    longv = plan.consts.long_vertical_step
    _, nB, B = inputs.a1.shape
    threads, sigma, diagonals = wavefront.sweep_schedule(nB, B, longv)
    ms = cs.cuda_ms(lambda: wavefront.sweep(inputs, longv), 5)
    gate = ""
    if args.sweep_plain:
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
