"""render.plan_ms: planner.plan_spectral alone on the previous stage's outputs, host ms
between synchronises, the mean over all reps."""
import statistics


def read(rec):
    reps = rec.get("stage_ms", {}).get("plan")
    return statistics.fmean(reps) if reps else None
