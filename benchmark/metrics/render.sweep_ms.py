"""render.sweep_ms: wavefront.sweep alone on the previous stage's outputs, host ms
between synchronises, the mean over all reps."""
import statistics


def read(rec):
    reps = rec.get("stage_ms", {}).get("sweep")
    return statistics.fmean(reps) if reps else None
