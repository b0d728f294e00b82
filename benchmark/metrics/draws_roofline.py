"""draws_roofline: kernel I's bound (harness/roofline_random.py, from the
request's shapes) over the device busy time of `sst.plan.draws`, in %."""
from benchmark.harness import roofline_random, spans


def read(rec):
    shapes = rec.get("shapes")
    per = spans.device_busy_ms(rec, "sst.plan.draws")
    if not shapes or not per or not spans.mean(per):
        return None
    return 100.0 * roofline_random.draws_bound_ms(shapes) / spans.mean(per)
