#!/usr/bin/env python3
"""Runs of one cell, one `benchmark/run.py` process a seed, one after
another.

    python3 benchmark/tools/repeat.py --workload <cell> --seeds 1,2,3 \
        [--seconds 30] [--trace 0] [--out FILE]

Each run's exit code, wall time, result line and the end of its standard
error go out as one JSON line, on standard output and appended to --out;
at the end, for each metric, the median and common.spread of all runs."""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import common  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    values = {}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(args.seconds), "--trace",
             str(args.trace)], cwd=ROOT, capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = {"workload": args.workload, "seed": seed, "trace": args.trace,
               "rc": p.returncode, "wall_s": time.perf_counter() - t0,
               "result": result, "stderr": p.stderr[-3000:]}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        for k, v in (result or {}).get("metrics", {}).items():
            values.setdefault(k, []).append(v["value"])
    for k, v in values.items():
        sp = common.spread(v) if len(v) >= 2 else float("nan")
        print(f"{args.workload} {k}: median {statistics.median(v)!r}, "
              f"spread {sp!r}, values {v}")


if __name__ == "__main__":
    main()
