"""render.synthesis_device_ms: the device's busy time (the union of its
intervals) of the operations launched inside the program's
`sst.render.synthesis` span (engine.synthesis_stage inside a request), ms a
request."""
from benchmark.harness import spans


def read(rec):
    per = spans.device_busy_ms(rec, "sst.render.synthesis")
    return spans.mean(per) if per else None
