"""device_idle_pct.render: 1 - the device's busy time (the union of its
intervals) over the wall time of whole traced requests, in %."""
from benchmark.harness import trace


def read(rec):
    reqs = rec.get("spans")
    if not reqs:
        return None
    busy = trace.busy_ns(rec["device"], reqs)
    wall = sum(b - a for a, b in reqs)
    return 100.0 * (1 - busy / wall) if busy else None
