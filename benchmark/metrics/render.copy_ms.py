"""render.copy_ms: the host<->device copies of a request (Memcpy HtoD and
DtoH in the profiler's device events inside each request span), ms a
request."""
from benchmark.harness import trace


def read(rec):
    reqs = rec.get("spans")
    if not reqs:
        return None
    ns = sum(e - s for a, b in reqs
             for name, s, e in trace.within(rec["device"], a, b)
             if "Memcpy HtoD" in name or "Memcpy DtoH" in name)
    return ns / 1e6 / len(reqs) if ns else None
