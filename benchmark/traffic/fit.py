"""Fit steps back to back, as ``cli fit`` takes them: inverse rendering of
the configuration's scene.  The target is the scene rendered at the
configuration's size; the start is every geometry parameter perturbed by
``perturb`` × N(0, 1) (``scenes.perturbed``), the tori in the seed's
order.  A step is the port's ``render_value_and_grad`` of
the mean squared error (on the card, a replay of the step's captured
graph), then SGD at ``lr`` on every floating leaf, then the loss read to
the host.  One client, a closed loop.

Set-up renders the target and takes the first ``check_steps`` steps
through the same call as the window, which then goes on from there.
Check: those steps against the plain fit in float64 (``reference/fit.py``),
which renders its own target: each step's loss, the first gradient as the
optimizer got it ((θ0 − θ1) / lr), and the change of the leaves after the
last of them, by the worst leaf.
"""
from __future__ import annotations

import torch

from benchmark import checks, program, scenes
from benchmark.harness import log
from benchmark.reference import fit as ref_fit
from benchmark.reference import render as ref


def image_mse(img, target):
    """The fit's loss: the mean squared difference to the target."""
    return torch.mean((img - target) ** 2)


def sgd(scene, grads: dict, lr: float):
    """One SGD step on every floating leaf (a new scene)."""
    with torch.no_grad():
        return scene.with_tensors({k: v - lr * grads[k]
                                   for k, v in scene.tensors().items()})


class Traffic:
    """The cell's set-up (target, start, the checked steps), one step a
    call, and the check; a step calls ``loss_fn`` and ``update``."""

    loss_fn = staticmethod(image_mse)
    update = staticmethod(sgd)

    def __init__(self, run):
        self.run = run
        c, p = run.config, run.params
        self.ft = program.port()
        self.lr = float(p["lr"])
        self.arrays, self.start = scenes.perturbed(c, float(p["perturb"]),
                                                   run.seed)
        self.camera = program.camera(c["camera"], run.device)
        self.cfg = program.render_config(c["render"], c["march"])
        target_scene = program.scene(self.arrays, run.device)
        self.target = self.ft.render(target_scene, self.camera, self.cfg)
        self.scene = program.scene(self.start, run.device)
        self.states = [self.leaves()]
        self.losses = []
        for _ in range(int(p["check_steps"])):
            self.losses.append(self.step())
            self.states.append(self.leaves())

    def leaves(self) -> dict:
        return {k: v.detach().double().cpu().numpy()
                for k, v in self.scene.tensors().items()}

    def step(self) -> float:
        loss, grads = self.ft.render_value_and_grad(
            self.loss_fn, self.scene, self.camera, self.cfg, self.target)
        self.scene = self.update(self.scene, grads, self.lr)
        return float(loss)

    def call(self, i: int) -> None:
        self.step()

    def release(self) -> None:
        self.scene = self.target = None

    def reference(self, dtype=torch.float64):
        """The plain fit's losses, first gradients and leaves."""
        c = self.run.config
        dev = self.run.device
        kinds = self.arrays.light_kind
        target, _ = ref_fit.frame(ref.leaves_of(self.arrays, dev, dtype),
                                  kinds, c["camera"], c["render"],
                                  c["march"])
        losses, first, states = ref_fit.fit(
            ref.leaves_of(self.start, dev, dtype), kinds, c["camera"],
            c["render"], c["march"], target, self.lr,
            int(self.run.params["check_steps"]))

        def np_(d):
            return {k: v.detach().double().cpu().numpy() for k, v in d.items()}
        return losses, np_(first), [np_(s) for s in states]

    def numbers(self, prog, refr) -> dict:
        """``prog``: (losses, θ0, θ1, θK) of the program's steps; ``refr``:
        (losses, first gradients, θ0, θK) of the plain fit."""
        (pl, p0, p1, pk), (rl, rg, r0, rk) = prog, refr
        leaves = checks.counted_leaves(rg, float(self.run.params["leaf_rule"]))
        grad = checks.leaf_gaps({k: (p0[k] - p1[k]) / self.lr
                                 for k in leaves}, rg, leaves)
        change = checks.leaf_gaps({k: pk[k] - p0[k] for k in leaves},
                                  {k: rk[k] - r0[k] for k in leaves}, leaves)
        log(f"losses {pl} reference {rl}")
        log(f"leaves counted {leaves}; gaps of the first gradient {grad}; "
            f"of the change {change}")
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(pl, rl)),
            "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
        }

    def check(self) -> tuple:
        prog = (self.losses, self.states[0], self.states[1], self.states[-1])
        rl, rg, rs = self.reference(torch.float64)
        judged = checks.judge(self.numbers(prog, (rl, rg, rs[0], rs[-1])),
                              self.run.params["limits"])
        failed = int(any(v > lim for v, lim in judged.values()))
        return judged, failed

    def control(self) -> dict:
        """The control: the plain fit in bfloat16 in the program's place."""
        ll, _lg, ls = self.reference(torch.bfloat16)
        rl, rg, rs = self.reference(torch.float64)
        return checks.judge(self.numbers((ll, ls[0], ls[1], ls[-1]),
                                         (rl, rg, rs[0], rs[-1])),
                            self.run.params["limits"])
