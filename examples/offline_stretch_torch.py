"""Offline whole-file stretch (the cmd/main.cpp workflow) on the PyTorch
port.

    python examples/offline_stretch_torch.py input.wav output.wav 1.25 3 \
        [--device cuda]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from signalsmith_stretch_torch import SignalsmithStretch
from signalsmith_stretch_torch.io import read_wav, write_wav


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("time_factor", type=float, nargs="?", default=1.25)
    ap.add_argument("semitones", type=float, nargs="?", default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    audio, rate = read_wav(args.input)
    stretch = SignalsmithStretch(device=args.device)
    stretch.preset_default(audio.shape[0], rate)
    stretch.set_transpose_semitones(args.semitones, 8000 / rate)

    out, ok = stretch.exact(audio, int(round(audio.shape[1]
                                             * args.time_factor)))
    assert ok, "input shorter than outputSeekLength"
    write_wav(args.output, np.asarray(out), rate)
    print(f"{args.input} -> {args.output}: {args.time_factor}x, "
          f"{args.semitones:+.1f} st")


if __name__ == "__main__":
    main()
