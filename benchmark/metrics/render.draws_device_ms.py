"""render.draws_device_ms: the device's busy time (the union of its
intervals) of the operations launched inside the program's
`sst.plan.draws` span (the per-bin draws above 2x, kernel I), ms a
request."""
from benchmark.harness import spans


def read(rec):
    per = spans.device_busy_ms(rec, "sst.plan.draws")
    return spans.mean(per) if per else None
