"""The program's own spans in a traced record, for the per-layer readers.

The port names its spans `sst.<layer>.<phase>` (its utils/profiling.span):
CPU operation events on the profiler's clock, nested by time, so they sit
in a record's `host` events beside the loop's request or quantum spans
(`spans`).  A device operation belongs to the program span that holds the
host call that launched it: the launch calls (LAUNCHES), taken in host
order, are matched one to one with the device operations, taken in start
order, which is the launch order on the one stream the cells' paths use.
Each pair has to agree in kind (a copy call with a Memcpy, a memset call
with a Memset, a kernel launch with any other operation).  Where the two
counts differ, over the record or inside any of the loop's spans, or a
pair's kinds disagree, nothing is attributed and the readers read None:
they never guess.  A call that puts several operations on the timeline
(cudaGraphLaunch) is not a launch here, so a record that holds one reads
None.  Where the record holds no such program span (a program without
spans), they read None too."""
from __future__ import annotations

import bisect
import statistics

from benchmark.harness import trace

# the host calls that put one operation on the device's timeline, and
# the kind of operation each puts there
LAUNCHES = {"cudaLaunchKernel": "kernel", "cudaLaunchKernelExC": "kernel",
            "cuLaunchKernel": "kernel", "cuLaunchKernelEx": "kernel",
            "cudaMemcpyAsync": "Memcpy", "cudaMemsetAsync": "Memset"}


def kind(device_name: str) -> str:
    """The kind of a device operation, as LAUNCHES names it."""
    for k in ("Memcpy", "Memset"):
        if device_name.startswith(k):
            return k
    return "kernel"


def mean(values):
    """The mean of values, or None where there are none."""
    return statistics.fmean(values) if values else None


def per_outer(rec, name: str):
    """For each of the loop's spans, the program spans called `name` that
    start inside it, [(start, end), ...]; None where the record has no
    loop span or no program span of that name."""
    outer = rec.get("spans")
    found = [(s, e) for n, s, e in rec.get("host", ()) if n == name]
    if not outer or not found:
        return None
    starts = [s for s, _ in found]
    return [found[bisect.bisect_left(starts, a):bisect.bisect_left(starts, b)]
            for a, b in outer]


def wall_ms(rec, name: str):
    """Per loop span, the summed wall time of its program spans called
    `name`, ms; None as per_outer."""
    groups = per_outer(rec, name)
    if groups is None:
        return None
    return [sum(e - s for s, e in g) / 1e6 for g in groups]


def self_ms(rec, name: str):
    """Per loop span, the summed self time of its program spans called
    `name`: each one's wall less the part of it that the program spans
    inside it cover, ms; None as per_outer."""
    groups = per_outer(rec, name)
    if groups is None:
        return None
    prog = [h for h in rec.get("host", ()) if h[0].startswith("sst.")]
    starts = [s for _, s, _ in prog]
    out = []
    for g in groups:
        total = 0
        for s, e in g:
            inner = [(a, min(b, e)) for n, a, b in
                     prog[bisect.bisect_left(starts, s):
                          bisect.bisect_left(starts, e)]
                     if (n, a, b) != (name, s, e)]
            total += (e - s) - trace.union_ns(inner)
        out.append(total / 1e6)
    return out


def attributed(rec):
    """The launch calls' host start times and the device operations,
    matched in order: ([launch start, ...], [(name, start, end), ...]);
    None where the record holds no device operation, where the counts
    differ over the record or inside any loop span, or where a launch
    call and its operation differ in kind."""
    device, outer = rec.get("device"), rec.get("spans")
    calls = [(s, LAUNCHES[n]) for n, s, _ in rec.get("host", ())
             if n in LAUNCHES]
    if not device or not outer or len(calls) != len(device):
        return None
    if any(k != kind(d[0]) for (_, k), d in zip(calls, device)):
        return None
    at = [s for s, _ in calls]
    dev_starts = [s for _, s, _ in device]
    for a, b in outer:
        n_at = bisect.bisect_left(at, b) - bisect.bisect_left(at, a)
        n_dev = (bisect.bisect_left(dev_starts, b)
                 - bisect.bisect_left(dev_starts, a))
        if n_at != n_dev:
            return None
    return at, device


def device_ops(rec, name: str):
    """Per loop span, the device operations launched inside its program
    spans called `name`, [(name, start, end), ...]; None where attribution
    fails or as per_outer."""
    pairs, groups = attributed(rec), per_outer(rec, name)
    if pairs is None or groups is None:
        return None
    at, device = pairs
    return [[device[i] for s, e in g
             for i in range(bisect.bisect_left(at, s),
                            bisect.bisect_left(at, e))]
            for g in groups]


def device_busy_ms(rec, name: str):
    """Per loop span, the device's busy time (the union of intervals) of
    the operations launched inside its program spans called `name`, ms;
    None as device_ops."""
    ops = device_ops(rec, name)
    if ops is None:
        return None
    return [trace.union_ns([(s, e) for _, s, e in g]) / 1e6 for g in ops]
