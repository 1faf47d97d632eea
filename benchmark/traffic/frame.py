"""Frames back to back, as ``cli render`` issues them: one client, a closed
loop, each ``render_with_stats`` call issued when the last has returned
and the device is synchronized.  Every call renders the configuration's
scene (its tori in the seed's order) from its camera at its size (on the
card, a replay of the frame's captured graph).

Check: the outputs of a few calls drawn from the seed and of the last
call, at a sample of pixels drawn from the seed, against the plain
reference in float64 (``reference/render.py``).  Parameters (the
workload's ``params``): ``warm_calls``, ``trace_calls``, ``pixels``,
``kept_calls``, ``bad_at``, ``limits``.
"""
from __future__ import annotations

import torch

from benchmark import checks, program, scenes
from benchmark.reference import render as ref


class Traffic:
    """The cell's set-up (scene, camera, warm-up), one frame a call, and
    the check of the kept frames."""

    def __init__(self, run):
        self.run = run
        c, p = run.config, run.params
        self.ft = program.port()
        self.arrays = scenes.draw(c, run.seed)
        self.scene = program.scene(self.arrays, run.device)
        self.camera = program.camera(c["camera"], run.device)
        self.cfg = self.entry_config()
        first = int(p["trace_calls"]) if run.trace else 32
        self.keep = set(scenes.kept_calls(int(p["kept_calls"]), first,
                                          run.seed))
        self.kept, self.last = {}, None
        for _ in range(int(p["warm_calls"])):
            self.render()

    def entry_config(self):
        c = self.run.config
        return program.render_config(c["render"], c["march"])

    def render(self):
        return self.ft.render_with_stats(self.scene, self.camera, self.cfg)[0]

    def call(self, i: int) -> None:
        img = self.render()
        if i in self.keep:
            self.kept[i] = img
        self.last = (i, img)

    def size(self):
        r = self.run.config["render"]
        return int(r["width"]), int(r["height"])

    def release(self) -> None:
        """Keep the sampled pixels of the kept outputs; drop the rest."""
        w, h = self.size()
        self.pixels = scenes.sample_pixels(w, h, int(self.run.params["pixels"]),
                                           self.run.seed)
        idx = torch.as_tensor(self.pixels, device=self.run.device)
        outs = dict(self.kept)
        outs[self.last[0]] = self.last[1]
        self.outputs = {i: img.reshape(-1, 3).index_select(0, idx).double()
                        .cpu().numpy() for i, img in outs.items()}
        self.kept = self.last = self.scene = None

    def reference(self, dtype=torch.float64) -> tuple:
        """The plain frame at the sampled pixels: colours, and where the
        primary ray hit."""
        c = self.run.config
        w, h = self.size()
        dev = self.run.device
        lv = ref.leaves_of(self.arrays, dev, dtype)
        o, d = ref.camera_rays(c["camera"], w, h, self.pixels, dev, dtype)
        col, hit = ref.shade_rays(lv, self.arrays.light_kind, o, d,
                                  float(c["render"]["epsilon"]),
                                  float(c["render"]["length"]), c["march"])
        return col.double().cpu().numpy(), hit.cpu().numpy()

    def numbers(self, outputs: dict, refr: tuple) -> tuple:
        p = self.run.params
        per = {i: checks.frame_numbers(o, refr[0], refr[1],
                                       float(p["bad_at"]))
               for i, o in outputs.items()}
        judged = [checks.judge(v, p["limits"]) for v in per.values()]
        failed = sum(any(v > lim for v, lim in j.values()) for j in judged)
        return checks.judge(checks.worst(list(per.values())),
                            p["limits"]), failed

    def check(self) -> tuple:
        return self.numbers(self.outputs, self.reference())

    def control(self) -> dict:
        """The control: the reference in bfloat16 in the program's place."""
        low = self.reference(torch.bfloat16)[0]
        return self.numbers({0: low}, self.reference())[0]
