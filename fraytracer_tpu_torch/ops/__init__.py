"""Compute ops: SDF eval, march, shading, tone map."""
