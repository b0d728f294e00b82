"""node.launches_per_quantum: the device operations (kernels, copies,
memsets) inside all quantum spans of the traced window, over the
quanta."""
from benchmark.harness import trace


def read(rec):
    quanta = rec.get("spans")
    if not quanta:
        return None
    n = sum(len(trace.within(rec["device"], a, b)) for a, b in quanta)
    return n / len(quanta) if n else None
