"""render.analysis_device_ms: the device's busy time (the union of its
intervals) of the operations launched inside the program's
`sst.render.analysis` span (engine.analyze_stage inside a request), ms a
request."""
from benchmark.harness import spans


def read(rec):
    per = spans.device_busy_ms(rec, "sst.render.analysis")
    return spans.mean(per) if per else None
