"""Dev/regression CLI, the cmd/main-dev.cpp equivalent; the port of
signalsmith_stretch_tpu/cli_dev.py.

    python -m signalsmith_stretch_torch.cli_dev input.wav out.wav --time=1.25

On top of the regular CLI (cmd/main-dev.cpp:60-233 feature map):
  - setup and process timing with the realtime factor;
  - golden-file regression: the first render is snapshotted as
    <output>.reference.npy; later runs fail above -60 dB RMS deviation from
    it (only for --time <= 1.6, outside the randomised-phase regime, the
    reference's rule, :98);
  - --profile: the time of each stage, written as profile.svg beside the
    output (utils/profiling.stage_breakdown);
  - the allocation guard: after the first call, the audio path allocates
    no device memory, builds no kernel and no plan (the reference's
    no-allocation invariant, :160-163; utils/profiling.AllocationGuard).

Renders on the card (--device cuda, the default) or, when asked for, on the
CPU with the plain versions of the kernels.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="signalsmith-stretch-torch-dev")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--time", type=float, default=1.0)
    p.add_argument("--semitones", type=float, default=0)
    p.add_argument("--tonality", type=float, default=8000)
    p.add_argument("--formant", type=float, default=0)
    p.add_argument("--formant-comp", action="store_true")
    p.add_argument("--formant-base", type=float, default=0)
    p.add_argument("--cheaper", action="store_true")
    p.add_argument("--split", action="store_true")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--raw", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="write per-stage timing to profile.svg beside the "
                        "output")
    p.add_argument("--no-reference", action="store_true",
                   help="skip the golden-file regression check")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; cpu runs "
                        "the plain versions of the kernels)")
    args = p.parse_args(argv)

    import torch

    from .io import read_raw, read_wav, write_raw, write_wav
    from .models import StretchModel
    from .utils import profiling

    reader = read_raw if args.raw else read_wav
    writer = write_raw if args.raw else write_wav
    audio, rate = reader(args.input)
    in_len = audio.shape[1]
    out_len = int(round(in_len * args.time))

    t0 = time.perf_counter()
    model = StretchModel.build(
        channels=audio.shape[0], sample_rate=rate, in_samples=in_len,
        out_samples=out_len, semitones=args.semitones,
        tonality_hz=args.tonality, formant_semitones=args.formant,
        formant_compensation=args.formant_comp,
        formant_base_hz=args.formant_base, cheaper=args.cheaper,
        split=args.split, device=args.device)
    setup_s = time.perf_counter() - t0
    print(f"Setup:\n\t{setup_s:.3f}s")

    guard = profiling.AllocationGuard(lambda a: model(a, args.seed),
                                      model.device)
    x = torch.as_tensor(audio, dtype=torch.float32, device=model.device)
    profiling.sync(guard(x))    # the first call: kernels built and loaded
    t0 = time.perf_counter()
    out = guard(x)
    profiling.sync(out)
    process_s = time.perf_counter() - t0
    out_np = out.cpu().numpy()
    # the third call holds what the second held (x alone), so the cached
    # device memory must serve it
    del out
    profiling.sync(guard(x))
    counts = guard.check()

    audio_s = in_len / rate
    print(f"Process:\n\t{process_s:.3f}s, {audio_s / process_s:.1f}x "
          f"realtime, {100 * process_s / audio_s:.2f}% of one "
          f"core-second/s")
    print(f"\tallocation guard: ok ({guard.calls} calls; after the first, "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + ", none new)")

    writer(args.output, out_np, rate)

    if args.profile:
        # per-step breakdown (cmd/main-dev.cpp:165-208), each stage alone
        times = profiling.stage_breakdown(model, x[None], [args.seed])
        for name, v in times.items():
            print(f"\t{name:14s} {v * 1e3:9.2f} ms")
        svg = os.path.join(os.path.dirname(os.path.abspath(args.output)),
                           "profile.svg")
        profiling.write_svg_bars(
            svg, {k: v * 1000 for k, v in times.items()},
            title=f"{os.path.basename(args.input)} @ {args.time}x")
        print(f"\t{svg} written")

    # golden-file regression (cmd/main-dev.cpp:97-103, 212-233)
    if not args.no_reference and args.time <= 1.6:
        ref_path = args.output + ".reference.npy"
        if os.path.exists(ref_path):
            ref = np.load(ref_path)
            if ref.shape != out_np.shape:
                print("Reference:\n\tlengths differ", file=sys.stderr)
                return 1
            diff2 = float(np.mean((ref.astype(np.float64) - out_np) ** 2))
            diff_db = 10 * np.log10(diff2 + 1e-300)
            print(f"Reference:\n\tdifference: {diff_db:.1f} dB")
            if diff_db > -60:
                print("too much difference", file=sys.stderr)
                return 1
        else:
            np.save(ref_path, out_np)
            print(f"Reference:\n\tsnapshotted {ref_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
