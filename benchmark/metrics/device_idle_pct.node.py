"""device_idle_pct.node: 1 - the device's busy time over the quanta's own
wall time (the pacer's waits between quanta left out), in %."""
from benchmark.harness import trace


def read(rec):
    quanta = rec.get("spans")
    if not quanta:
        return None
    busy = trace.busy_ns(rec["device"], quanta)
    wall = sum(b - a for a, b in quanta)
    return 100.0 * (1 - busy / wall) if busy else None
