"""Multi-process corpus rendering on the PyTorch port (run the SAME program
in every process).

One process (uses every local card):
    python examples/distributed_corpus_torch.py out_dir clip1.wav clip2.wav

Several processes (each loads and writes only its own slice; give each its
own cards with CUDA_VISIBLE_DEVICES):
    SST_COORDINATOR=host0:8476 SST_NUM_PROCESSES=2 SST_PROCESS_ID=0 \\
        python examples/distributed_corpus_torch.py out_dir *.wav
    SST_COORDINATOR=host0:8476 SST_NUM_PROCESSES=2 SST_PROCESS_ID=1 \\
        python examples/distributed_corpus_torch.py out_dir *.wav

--device cpu runs on the CPU (a gloo group).  The time factor comes from
SST_TIME (default 1.25).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from signalsmith_stretch_torch import engine, spectral
from signalsmith_stretch_torch.config import StretchConfig
from signalsmith_stretch_torch.io import corpus, wav
from signalsmith_stretch_torch.parallel import batch as pbatch
from signalsmith_stretch_torch.parallel import distributed as dist


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out_dir, paths = args.out_dir, sorted(args.paths)
    time_factor = float(os.environ.get("SST_TIME", "1.25"))
    os.makedirs(out_dir, exist_ok=True)

    dist.initialize(device=args.device)        # False single-process
    mesh = dist.global_mesh(args.device)
    mine = dist.shard_items(paths)
    print(f"[{dist.process_index()}] {len(mine)}/{len(paths)} clips, "
          f"{len(mesh)} local devices, {dist.process_count()} processes")

    items = corpus.load_directory(mine, time_factor=time_factor)
    for b in corpus.batches(items, batch_size=8, device=mesh[0]):
        rate, ch, pad_n = b["key"][0], b["key"][1], b["key"][2]
        out_n = int(round(pad_n * b["time_factor"]))
        cfg = StretchConfig.preset_default(ch, rate, False)
        plan = engine.build_exact_plan(cfg, pad_n, out_n)
        flags = spectral.SpectralFlags(False, False, False)
        fn = pbatch.batch_render(plan, flags, mesh=mesh)
        audio = b["audio"]
        # pad the local batch so that it divides over the local devices
        rem = (-audio.shape[0]) % len(mesh)
        if rem:
            audio = np.concatenate([audio.cpu().numpy(), np.zeros(
                (rem,) + tuple(audio.shape[1:]), np.float32)])
        seeds = np.arange(audio.shape[0], dtype=np.int32)
        out = fn(dist.global_batch(audio, mesh), spectral.Controls.make(),
                 seeds).cpu().numpy()
        for name, n_in, clip in zip(b["names"], b["lengths"], out):
            n_out = int(round(n_in * b["time_factor"]))
            dst = os.path.join(out_dir, os.path.basename(name))
            wav.write_wav(dst, clip[:, :n_out], rate)
            print(f"[{dist.process_index()}] {dst} ({n_out} samples)")


if __name__ == "__main__":
    main()
