"""Spectral frames back to back: one client, a closed loop of
``render_spectral_with_stats`` calls (on the card, replays of the spectral
frame's captured graph) of the configuration's scene (its tori in the
seed's order) from its camera, at the wavefront's size, bins and depth.

Check: as ``frame.py``, against the plain wavefront integrator in float64
(``reference/spectral.py``), every bin and bounce of each sampled pixel.
"""
from __future__ import annotations

import torch

from benchmark import program
from benchmark.reference import spectral as ref
from benchmark.traffic.frame import Traffic as FrameTraffic


class Traffic(FrameTraffic):

    def entry_config(self):
        c = self.run.config
        return program.wavefront_config(c["wavefront"], c["march"])

    def size(self):
        w = self.run.config["wavefront"]
        return int(w["width"]), int(w["height"])

    def render(self):
        w, h = self.size()
        return self.ft.render_spectral_with_stats(self.scene, self.camera, w,
                                                  h, self.cfg)[0]

    def reference(self, dtype=torch.float64) -> tuple:
        c = self.run.config
        w, h = self.size()
        col, hit = ref.spectral_pixels(self.arrays, c["camera"], w, h,
                                       self.pixels, c["wavefront"],
                                       c["march"], self.run.device, dtype)
        return col.double().cpu().numpy(), hit.cpu().numpy()
