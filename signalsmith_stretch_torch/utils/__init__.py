"""Profiling utilities of the port (timing, stage breakdowns, the
allocation guard)."""
