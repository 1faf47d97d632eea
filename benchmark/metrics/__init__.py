"""Metric readers: one file a metric, its ``read(run)`` found by name."""
