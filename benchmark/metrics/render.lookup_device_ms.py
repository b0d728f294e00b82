"""render.lookup_device_ms: the device's busy time (the union of its
intervals) of the operations launched inside the program's
`sst.plan.lookup` span (kernel A and its glue), ms a request."""
from benchmark.harness import spans


def read(rec):
    per = spans.device_busy_ms(rec, "sst.plan.lookup")
    return spans.mean(per) if per else None
