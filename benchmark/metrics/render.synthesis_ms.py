"""render.synthesis_ms: engine.synthesis_stage alone on the previous stage's outputs, host ms
between synchronises, the mean over all reps."""
import statistics


def read(rec):
    reps = rec.get("stage_ms", {}).get("synthesis")
    return statistics.fmean(reps) if reps else None
