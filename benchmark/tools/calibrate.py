#!/usr/bin/env python3
"""Readings for a cell's limits, on the card, in one process.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--kinds program,control,<fault>,...] [--seconds 3] [--out FILE]

For each seed and each kind, one run of the cell through the harness's
own path (runner.measure: set-up, a short window at the cell's own load,
the check): `program` as the benchmark runs it; `control` with the
reference computed in bfloat16 put in the program's place; a fault's name
(one of the FAULTS of the cell's loop, benchmark/loops/<loop>.py) with
that fault planted in the program.  One JSON line a reading, with the
result's `correct`, every compared number beside its limit and the
numbers that have none (or the error of a run that crashed), on standard
output and appended to --out."""
import argparse
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="program")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    from benchmark.harness import common, runner
    bench = common.benchmark()
    cell = common.cell(bench, args.workload)
    cfg = common.config(bench, cell["config"])
    traffic = common.traffic(cell["traffic"])
    limits = common.limits(cell["name"])
    faults = {f.__name__: f for f in
              common.load("loops", traffic["loop"]).FAULTS}
    kinds = args.kinds.split(",")
    unknown = set(kinds) - {"program", "control"} - set(faults)
    if unknown:
        sys.exit(f"calibrate: no kind {sorted(unknown)}; faults: "
                 f"{sorted(faults)}")
    import torch
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA card")
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        for kind in kinds:
            patch, undo = common.patcher()
            if kind in faults:
                faults[kind](patch)
            raw, log = {}, io.StringIO()
            t0 = time.perf_counter()
            rec = {"workload": cell["name"], "seed": seed, "kind": kind}
            try:
                line = runner.measure(bench, cell, cfg, traffic, limits,
                                      seed, args.seconds, False, t0,
                                      log=log, control=kind == "control",
                                      raw=raw)
            except Exception as e:     # a run that crashes gives no number
                rec["error"] = repr(e)[-2000:]
            else:
                rec.update(
                    correct=line["correct"], checks=line["checks"],
                    unlimited={k: v for k, v in raw.items()
                               if k not in line["checks"]},
                    attempted=line["attempted"],
                    metrics={k: v["value"]
                             for k, v in line["metrics"].items()},
                    notes=log.getvalue().splitlines()[0])
            finally:
                undo()
            rec["run_s"] = time.perf_counter() - t0
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
