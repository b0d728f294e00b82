"""render.analysis_ms: engine.analyze_stage alone on the previous stage's outputs, host ms
between synchronises, the mean over all reps."""
import statistics


def read(rec):
    reps = rec.get("stage_ms", {}).get("analysis")
    return statistics.fmean(reps) if reps else None
