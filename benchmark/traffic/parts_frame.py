"""Frames of the machined-parts scene back to back, as ``frame.py`` issues
them: one client, a closed loop of ``render_with_stats`` calls (on the
card, replays of the frame's captured graph) of the configuration's parts
(in the seed's order) from its camera at its size.  Parameters: those
of ``frame.py`` and ``kept_within``.

Check: as ``frame.py``, against the plain reference of this scene in
float64 (``reference/parts.py``).  The port's dense-form counters
(``parts.dense_counts``) are read after the warm-up and after the window,
so that ``run.dense`` holds the window's lane-steps and the program's
shape for the per-layer metrics (nothing where the port keeps none).
"""
from __future__ import annotations

import torch

from benchmark import parts, program, scenes
from benchmark.reference import parts as ref
from benchmark.traffic.frame import Traffic as FrameTraffic


class Traffic(FrameTraffic):

    def __init__(self, run):
        self.run = run
        c, p = run.config, run.params
        self.ft = program.port()
        self.arrays = parts.draw(c, run.seed)
        self.scene = parts.port_scene(self.arrays, run.device)
        self.camera = program.camera(c["camera"], run.device)
        self.cfg = self.entry_config()
        # a 15 s window holds about 11 frames here, not frame.py's 32: the
        # kept calls are drawn from the first ``kept_within`` calls, so that
        # every one of them is run and checked
        first = min(int(p["trace_calls"]) if run.trace else 32,
                    int(p["kept_within"]))
        self.keep = set(scenes.kept_calls(int(p["kept_calls"]), first,
                                          run.seed))
        self.kept, self.last = {}, None
        for _ in range(int(p["warm_calls"])):
            self.render()
        run.sync()
        self.counts0 = parts.dense_counts()
        run.dense = None

    def release(self) -> None:
        counts = parts.dense_counts()
        if counts is not None and self.counts0 is not None:
            self.run.dense = dict(counts, lane_steps=counts["lane_steps"]
                                  - self.counts0["lane_steps"])
        super().release()

    def reference(self, dtype=torch.float64) -> tuple:
        c = self.run.config
        w, h = self.size()
        dev = self.run.device
        lv = ref.leaves_of(self.arrays, dev, dtype)
        o, d = ref.camera_rays(c["camera"], w, h, self.pixels, dev, dtype)
        col, hit = ref.shade_rays(lv, self.arrays.light_kind, o, d,
                                  float(c["render"]["epsilon"]),
                                  float(c["render"]["length"]), c["march"])
        return col.double().cpu().numpy(), hit.cpu().numpy()
