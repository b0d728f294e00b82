"""render.plan_host_ms: the host's wall time of the program's
`sst.render.plan` span (planner.plan_spectral inside a request), ms a
request; beside render.plan_device_ms it says whether the plan stage is
bound by its launches."""
from benchmark.harness import spans


def read(rec):
    per = spans.wall_ms(rec, "sst.render.plan")
    return spans.mean(per) if per else None
