"""Scheduled/scrubbed playback via the worklet-style node (web demo
analogue) on the PyTorch port.

Recreates the web demo's interactions (web/demo/index.html): load a buffer,
schedule segments with changing rate/pitch, loop a region, and render the
result to a WAV.

    python examples/scheduled_playback_torch.py in.wav [out.wav] \
        [--device cuda]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from signalsmith_stretch_torch.io import read_wav, write_wav
from signalsmith_stretch_torch.scheduler import StretchNode


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default="scheduled.wav")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    audio, rate = read_wav(args.input)
    node = StretchNode(rate, channels=audio.shape[0], preset="cheaper",
                       quantum=512, device=args.device)
    node.add_buffers(audio)
    node.set_update_interval(0.25, lambda t: print(f"  input time: {t:.2f}s"))

    # half-speed playback from the start...
    node.schedule(input=0.0, rate=0.5)
    part1 = node.render(1.0)
    # ...then jump ahead and pitch up a fourth at normal speed...
    node.schedule(input=min(2.0, node.buffer_seconds / 2), rate=1.0,
                  semitones=5, tonality_hz=8000)
    part2 = node.render(1.0)
    # ...then loop one second of audio at 80% speed
    node.schedule(input=0.5, rate=0.8, loop_start=0.5, loop_end=1.5)
    part3 = node.render(2.0)

    out = np.concatenate([part1, part2, part3], axis=1)
    write_wav(args.output, out, rate)
    print(f"wrote {out.shape[1] / rate:.1f}s to {args.output}")


if __name__ == "__main__":
    main()
