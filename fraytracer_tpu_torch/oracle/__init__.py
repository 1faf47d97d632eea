"""The float64 scalar oracle (``cpu_ref.Oracle``): the reference the
kernels' frames are gated against."""
