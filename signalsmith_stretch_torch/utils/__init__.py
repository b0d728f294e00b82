"""Profiling utilities of the port (program spans, timing, stage
breakdowns, the allocation guard)."""
