"""Corpus-scale batched rendering (BASELINE config #5) on the PyTorch port.

    python examples/batch_corpus_torch.py 'clips/*.wav' out_dir 1.25 \
        [--device cuda]
"""
import argparse
import glob
import os
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from signalsmith_stretch_torch.io import write_wav
from signalsmith_stretch_torch.io.corpus import batches, load_directory
from signalsmith_stretch_torch.models import StretchModel


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pattern")
    ap.add_argument("out_dir")
    ap.add_argument("time_factor", type=float, nargs="?", default=1.25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    items = load_directory(sorted(glob.glob(args.pattern)),
                           time_factor=args.time_factor)
    models = {}
    for batch in batches(items, batch_size=16, device=args.device):
        rate, ch, in_len, tf, st = batch["key"]
        out_len = int(round(in_len * tf))
        key = batch["key"]
        if key not in models:
            models[key] = StretchModel.build(
                channels=ch, sample_rate=rate, in_samples=in_len,
                out_samples=out_len, semitones=st, device=args.device)
        out = models[key].batched(batch["audio"]).cpu().numpy()
        for i, name in enumerate(batch["names"]):
            n_out = int(round(batch["lengths"][i] * tf))
            dest = os.path.join(args.out_dir, os.path.basename(name))
            write_wav(dest, out[i, :, :n_out], rate)
            print(f"  {dest}")


if __name__ == "__main__":
    main()
