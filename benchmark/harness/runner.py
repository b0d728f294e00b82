"""One run of a cell after the look for a chip: set-up, the window (or the
traced window), the metrics, the check, the result line.

The cell's traffic mix names its loop, benchmark/loops/<loop>.py, which
the harness loads by that name.  Its class Loop(config, traffic, seed,
device) sets the system under test up and warms it.  window(seconds)
returns the window's record (attempted, failed, and what end_to_end
reads); traced() the traced record (the host and device events, the loop's
spans as `spans`, window_s, and what the per-layer readers read);
end_to_end(record) the end-to-end values; notes(record) a line for
standard error; free() drops the program's state that the check does not
need; numbers(control) gives the compared numbers, with control=True
those of the reference in bfloat16 put in the program's place."""
from __future__ import annotations

import sys
import time

from . import check, common, trace


class Forbidden(RuntimeError):
    """JAX or the JAX package was found loaded."""


def _sync(torch, device):
    if device != "cpu":
        torch.cuda.synchronize()


def measure(bench: dict, cell: dict, cfg: dict, traffic: dict,
            limits: dict, seed: int, seconds: float, traced: bool, t0: float,
            device="cuda", log=sys.stderr, control: bool = False,
            raw: dict | None = None) -> dict:
    """The result line of one run; t0 is the process's start on the
    perf_counter clock.  With control=True the compared numbers are the
    control's, judged by the same limits; `raw`, where given, receives
    every number the loop worked out, limited or not."""
    import torch
    sut = common.loop(traffic["loop"])(cfg, traffic, seed, device)
    _sync(torch, device)
    setup_s = time.perf_counter() - t0
    rec = sut.traced() if traced else sut.window(seconds)
    _sync(torch, device)
    if device == "cpu":
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    else:
        dev = common.device_info(torch, cell["chips"])
    bad = common.forbidden_loaded()
    if bad:
        raise Forbidden(f"loaded after the window: {', '.join(bad)}")
    breakdown = None
    if traced:
        metrics = {}
        for m in common.metrics_for(bench, cell["name"], "per_layer"):
            v = common.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        spans = rec["spans"]
        window = [(spans[0][0], spans[-1][1])]
        dev["busy_s"] = trace.busy_ns(rec["device"], window) / 1e9
        dev["window_s"] = rec["window_s"]
        breakdown = {
            "device_ops": trace.top_ops(rec["device"], window),
            "idle_gaps": trace.idle_gaps(
                rec["host"], rec["device"], window,
                outside="between calls (pacer or caller)")}
        if device != "cpu":
            print(f"card: {common.power_limit()}; rooflines against the "
                  f"H100 SXM's 3.35e12 B/s", file=log)
        attempted, failed = len(spans), 0
    else:
        values = sut.end_to_end(rec)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in common.metrics_for(bench, cell["name"],
                                               "end_to_end")}
        attempted, failed = rec["attempted"], rec["failed"]
        print(sut.notes(rec), file=log)
    del rec
    sut.free()
    numbers = sut.numbers(control=control)
    if raw is not None:
        raw.update(numbers)
    checks = check.decide(numbers, limits)
    bad = common.forbidden_loaded()
    if bad:
        raise Forbidden(f"loaded by the run: {', '.join(bad)}")
    line = {"correct": check.correct(checks), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=log)
    return line
