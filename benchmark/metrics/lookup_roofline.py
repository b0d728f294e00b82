"""lookup_roofline: kernel A's byte bound on the four per-bin position
sets (harness/roofline_random.py, from the request's shapes) over the
device busy time of `sst.plan.lookup`, in %."""
from benchmark.harness import roofline_random, spans


def read(rec):
    shapes = rec.get("shapes")
    per = spans.device_busy_ms(rec, "sst.plan.lookup")
    if not shapes or not per or not spans.mean(per):
        return None
    return 100.0 * roofline_random.lookup_bound_ms(shapes) / spans.mean(per)
