"""The comparisons that decide ``correct``: the numbers a traffic kind
compares with the plain reference, each judged against its limit (a
number passes when it is at most its limit).

Frames are compared pixel by pixel at a sample of pixels drawn from the
seed.  A fit is compared step by step: each step's loss, the norm of the
first gradient as the optimizer got it, and the norm of the parameters'
change, leaf by leaf, each as the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and
of the median leaf.
"""
from __future__ import annotations

import numpy as np


def frame_numbers(prog: np.ndarray, ref: np.ndarray, ref_hit: np.ndarray,
                  bad_at: float) -> dict:
    """``prog`` and ``ref`` ``[n, 3]`` colours at the same pixels, and
    where the reference's primary ray hit → ``bad_share``: the share of
    pixels whose largest channel difference exceeds ``bad_at`` (a hit or
    a shadow that flipped, a wrong colour); ``median_err``: the median of
    that difference over the reference's hits (the bulk of the shaded
    frame, where only rounding and the epsilon shell differ)."""
    err = np.abs(np.asarray(prog, np.float64)
                 - np.asarray(ref, np.float64)).max(axis=1)
    err = np.where(np.isfinite(err), err, np.inf)
    hits = err[np.asarray(ref_hit, bool)]
    return {"bad_share": float(np.mean(err > bad_at)),
            "median_err": float(np.median(hits)) if hits.size else 0.0}


def worst(readings: list) -> dict:
    """Each number's worst (largest) reading over several answers."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def counted_leaves(ref_grads: dict, rule: float) -> list:
    """The leaves whose reference gradient norm is at least ``rule`` times
    the median leaf's (the others move by round-off alone)."""
    norms = {k: float(np.linalg.norm(v)) for k, v in ref_grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= rule * med and v > 0.0]


def leaf_gaps(prog: dict, ref: dict, leaves: list) -> dict:
    """Each leaf's ``|‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)`` over
    ``leaves`` (infinite where the program's norm is not finite)."""
    rn = {k: float(np.linalg.norm(ref[k])) for k in leaves}
    med = float(np.median(list(rn.values())))
    gaps = {}
    for k in leaves:
        pn = float(np.linalg.norm(np.asarray(prog[k], np.float64)))
        gaps[k] = (abs(pn - rn[k]) / max(rn[k], med) if np.isfinite(pn)
                   else np.inf)
    return gaps


def judge(numbers: dict, limits: dict) -> dict:
    """``{name: (value, limit)}`` for every number that has a limit."""
    return {k: (float(numbers[k]), float(limits[k])) for k in limits}
