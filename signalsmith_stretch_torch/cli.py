"""Command-line front-end mirroring the reference CLI (cmd/main.cpp:11-86),
the port of signalsmith_stretch_tpu/cli.py.

    python -m signalsmith_stretch_torch.cli input.wav output.wav \
        --time=1.25 --semitones=3 --tonality=8000 \
        --formant=0 --formant-comp --formant-base=100 --cheaper --split

Renders with the exact() pipeline (sample-aligned output of exactly
round(input_length * time) samples) on the card; `--device cpu` renders on
the CPU with the plain versions of the kernels.
"""
from __future__ import annotations

import argparse
import sys
import time as _time

import numpy as np

from .api import SignalsmithStretch
from .io import read_raw, read_wav, write_raw, write_wav


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="signalsmith-stretch-torch",
        description="Time-stretching and pitch-shifting on an NVIDIA GPU")
    p.add_argument("input", nargs="?", help="input WAV (16-bit) or .raw file")
    p.add_argument("output", nargs="?", help="output file")
    p.add_argument("--time", type=float, default=1.0, help="time-stretch factor")
    p.add_argument("--semitones", type=float, default=0, help="pitch-shift amount")
    p.add_argument("--tonality", type=float, default=8000, help="tonality limit (Hz)")
    p.add_argument("--formant", type=float, default=0, help="formant shift (semitones)")
    p.add_argument("--formant-comp", action="store_true", help="formant compensation")
    p.add_argument("--formant-base", type=float, default=0,
                   help="formant base frequency (Hz, 0=auto detect)")
    p.add_argument("--cheaper", action="store_true", help="use the cheaper preset")
    p.add_argument("--split", action="store_true",
                   help="splitComputation latency contract (+one interval)")
    p.add_argument("--seed", type=int, default=0, help="random seed (>2x stretch)")
    p.add_argument("--raw", action="store_true", help="raw planar-float32 I/O")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; cpu runs "
                        "the plain versions of the kernels)")
    p.add_argument("-v", "--version", action="store_true")
    args = p.parse_args(argv)

    if args.version:
        from . import __version__
        print(__version__)
        return 0
    if not args.input or not args.output:
        p.error("input and output files are required")

    reader = read_raw if args.raw else read_wav
    writer = write_raw if args.raw else write_wav
    try:
        audio, rate = reader(args.input)
    except FileNotFoundError:
        print(f"error: cannot read {args.input}", file=sys.stderr)
        return 1
    print(f"{args.input} -> {args.output}")

    stretch = SignalsmithStretch(seed=args.seed, device=args.device)
    preset = stretch.preset_cheaper if args.cheaper else stretch.preset_default
    preset(audio.shape[0], rate, args.split)
    stretch.set_transpose_semitones(args.semitones, args.tonality / rate)
    stretch.set_formant_semitones(args.formant, args.formant_comp)
    stretch.set_formant_base(args.formant_base / rate)

    out_len = int(round(audio.shape[1] * args.time))
    t0 = _time.time()
    out, ok = stretch.exact(audio, out_len)
    dt = _time.time() - t0
    if not ok:
        print("input too short for exact(); output zeroed", file=sys.stderr)
    secs = audio.shape[1] / rate
    print(f"processed {secs:.2f}s audio in {dt:.2f}s "
          f"({secs/dt:.1f}x realtime incl. kernel build and plan)")
    writer(args.output, np.asarray(out), rate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
