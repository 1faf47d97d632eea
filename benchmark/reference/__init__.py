"""The plain reference that decides a run's ``correct``: the renderer of the
configurations written again in plain PyTorch, dense over every primitive,
in the precision it is asked for (float64 for the check; a lower one for
the control).  It imports nothing of the port, and takes only what the
harness draws from the seed (``benchmark/scenes.py``); whatever the port
derives from that (flattened tables, cull tables, targets) it works out
again.

``render``: the distance, the relaxed march, the surface pass and the
shading of a frame; ``spectral``: the wavefront integrator of a spectral
frame; ``fit``: the loss, the gradients and the SGD steps of a fit.
"""
