#!/usr/bin/env python3
"""Where a render's time goes on the card, for the PyTorch port.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/profile_torch.py [--out FILE]

For each configuration that chip_smoke.py renders (batch 8 x 10 s stereo
48 kHz), after two set-up renders: the median wall time of three renders,
then each stage (analysis, plan, sweep, synthesis) alone under
torch.profiler, with a synchronise at both ends.  Per stage it prints the
host wall time, the device busy time (the sum of kernel and copy times on
the card, which run on one stream and do not overlap), the idle share
(1 - busy / wall), the number of kernels, host-to-device copies and stream
synchronisations, the kernels that took the most device time, and the
device time of each of the port's own kernels (csrc/).  With --out, the
same lines also go to that file.
"""
from __future__ import annotations

import argparse
import collections
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# the __global__ functions of csrc/ (unstage_kernel matches stage_kernel)
PORT_KERNELS = ("interp_multi_kernel", "stage_kernel", "sweep_kernel",
                "chain_kernel", "dft_kernel", "top3_kernel",
                "peaks_map_kernel", "draws_kernel")


def _summary(name, wall, prof, top=6):
    dev = cs.profiler_events(prof, "CUDA")
    if not dev:
        raise SystemExit(f"{name}: the profiler recorded no device events")
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    host = collections.Counter(
        e.name for e in cs.profiler_events(prof, "CPU"))
    h2d = sum(1 for e in dev if "HtoD" in e.name)
    syncs = sum(n for k, n in host.items() if "Synchronize" in k)
    kernels = sum(1 for e in dev if "Memcpy" not in e.name
                  and "Memset" not in e.name)
    lines = [f"  {name}: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
             f"idle share {1 - busy / wall:.3f}; {kernels} kernels, "
             f"{h2d} host-to-device copies, {syncs} synchronise calls"]
    for k, ms in by_name.most_common(top):
        lines.append(f"      {ms:9.3f} ms  {k[:110]}")
    port = [(k.split("(")[0].removeprefix("void "), ms)
            for k, ms in by_name.items() if any(p in k for p in PORT_KERNELS)]
    if port:
        lines.append("    the port's kernels: " + ", ".join(
            f"{k} {ms:.3f} ms" for k, ms in sorted(port)))
    return lines


def profile_config(cfg, batch):
    import torch
    from signalsmith_stretch_torch import engine, planner, wavefront
    name = cfg[0]
    model, clips = cs._model(cfg, batch)
    audio = torch.as_tensor(clips, device=cs.DEVICE)
    for _ in range(2):
        model.batched(audio)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.batched(audio)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(times)
    audio_s = batch * model.in_samples / cs.RATE
    lines = [f"{name}: batch {batch}, render {wall:.2f} ms (median of 3, "
             f"{[round(t, 2) for t in times]}), realtime factor "
             f"{audio_s / (wall / 1e3):.1f}x"]
    _, w, prof = cs.profiled(lambda: model.batched(audio))
    lines += _summary("whole render", w, prof, top=10)
    plan = model.plan
    (spectra, prev), w, prof = cs.profiled(
        lambda: engine.analyze_stage(audio, plan))
    lines += _summary("analysis", w, prof)
    inputs, w, prof = cs.profiled(lambda: planner.plan_spectral(
        spectra, prev, plan.arrays, model.controls, model.flags, plan.consts))
    lines += _summary("plan", w, prof)
    out_specs, w, prof = cs.profiled(
        lambda: wavefront.sweep(inputs, plan.consts.long_vertical_step))
    lines += _summary("sweep", w, prof)
    _, w, prof = cs.profiled(
        lambda: engine.synthesis_stage(out_specs, plan, audio=audio))
    lines += _summary("synthesis", w, prof)
    del spectra, prev, inputs, out_specs, audio
    torch.cuda.empty_cache()
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()
    cs.header()
    cs.build_kernels()
    lines = [cs.smi_line()]
    for cfg in cs.CONFIGS:
        lines += profile_config(cfg, cs.BATCH)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
