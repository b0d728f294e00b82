"""plan_roofline: the plan stage's byte bound (its arguments read once
and its result written once, at the H100 SXM's 3.35 TB/s) over its device
time (the union of its device intervals in one traced call), in %."""


def read(rec):
    bound = rec.get("stage_bound_ms", {}).get("plan")
    ns = rec.get("stage_device_ns", {}).get("plan")
    if not bound or not ns:
        return None
    return 100.0 * bound / (ns / 1e6)
