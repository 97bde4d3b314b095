"""Inverse-rendering steps back to back: `Trainer.step` on the scene, each a
loss, its gradients, the optimizer's update and the projection, returning
the loss as a float.

Traffic keys: `width`, `height`, `spp`, `optimizer`, `learning_rate`. The
target is an image drawn from the seed on the device; the renderer's seed is
`derive(seed, FRAME)`, advanced by one each step (`TrainConfig`'s
`reseed_each_step`). Set-up builds the one trainer the window drives and
takes it through its first `check.steps` steps, through the window's own
call and target: the first captures the graph. Those steps are what the
check holds against the reference: each step's loss, the first gradient of
each leaf as the optimizer holds it after one step (Adam's `mu / (1 - b1)`),
and each leaf's change over the steps.

The check also holds the trainer as the window leaves it. Once the window
has closed, the same trainer takes one more step through the same call,
untimed: its loss is held against the reference's at the parameters the
window left and at that step's seed. Its step count and Adam's must be the
steps taken, and the window's losses and every leaf finite.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import scenes, seeds

B1 = 0.9  # Adam's first decay (TrainConfig's optimizer at its defaults)


class Driver:
    metric = "step_ms"

    def __init__(self, ctx):
        import polaris_tpu_torch as P

        self.ctx = ctx
        cfg, trf = ctx.cell.config, ctx.cell.traffic
        opt = P.RenderOptions(
            width=trf["width"], height=trf["height"], spp=trf["spp"],
            num_bounces=cfg["num_bounces"], min_bounces_for_rr=cfg["min_bounces_for_rr"],
            exposure=cfg["exposure"], seed=seeds.derive(ctx.seed, seeds.FRAME),
        )
        self.opt = opt
        tc = P.TrainConfig(learning_rate=trf["learning_rate"], optimizer=trf["optimizer"])
        self.trainer = P.Trainer(scenes.program_scene(cfg), opt, tc, mode=cfg["mode"], device=ctx.device)
        g = torch.Generator(device=ctx.device).manual_seed(seeds.derive(ctx.seed, seeds.TARGET))
        self.target = torch.rand((opt.height, opt.width, 3), generator=g, device=ctx.device)
        leaves = self.trainer.trainable
        self.start = {k: v.detach().clone() for k, v in leaves.items()}
        self.losses = []
        for i in range(ctx.cell.spec["check"]["steps"]):
            self.losses.append(float(self.trainer.step(self.target)))
            if i == 0:
                state = self.trainer.optimizer.state
                self.first_grad = {k: _first_grad_norm(state.get(p, {})) for k, p in leaves.items()}
        self.change = {
            k: float(torch.linalg.vector_norm((leaves[k].detach() - self.start[k]).double()))
            for k in leaves
        }
        self.window_losses = []
        self.after = None

    def run(self, i: int) -> None:
        self.window_losses.append(self.trainer.step(self.target))

    def close(self) -> None:
        """One more step after the window (see the module's docstring), what
        the check needs of it kept; then the trainer is dropped."""
        if self.trainer is not None:
            self.after = after_window(self.trainer, self.target, self.start)
        self.trainer = None

    def taken(self) -> int:
        """The steps taken before the one after the window."""
        return self.ctx.cell.spec["check"]["steps"] + len(self.window_losses)

    def check(self):
        """([(name, value, limit)], steps compared)."""
        steps = self.ctx.cell.spec["check"]["steps"]
        limits = self.ctx.cell.spec["check"]["limits"]
        ref = reference_steps(self.ctx, self.opt, self.target, steps, torch.float32)
        numbers = compare(
            {"losses": self.losses, "first_grad": self.first_grad, "change": self.change}, ref, limits,
        )
        ref1 = reference_after(self.ctx, self.opt, self.target, self.after, self.taken(), torch.float32)
        numbers += compare_after(self.after, self.window_losses, ref1, self.taken(), limits)
        return numbers, steps + 1


def after_window(trainer, target, start: dict) -> dict:
    """The trainer's parameters (and ``start``, the ones it began from), one
    more step's loss, its step counts, and its leaves' non-finite values."""
    leaves = trainer.trainable
    params = {k: p.detach().clone() for k, p in leaves.items()}
    loss = trainer.step(target)
    state = trainer.optimizer.state
    counts = [trainer.step_idx] + [state[p]["count"] for p in leaves.values() if "count" in state.get(p, {})]
    nonfinite = sum(int((~torch.isfinite(p.detach())).sum()) for p in leaves.values())
    return {"start": start, "params": params, "loss": loss, "counts": counts, "nonfinite": nonfinite}


def _first_grad_norm(state: dict) -> float:
    """The norm of the first gradient an Adam state holds after one step,
    ``mu / (1 - b1)``; 0 where the step left no state."""
    mu = state.get("mu")
    return 0.0 if mu is None else float(torch.linalg.vector_norm(mu.double() / (1 - B1)))


def reference_steps(ctx, opt, target, steps: int, dtype, program=None, at_step: int = 0) -> dict:
    """The reference's losses, first gradients and changes over ``steps``
    steps of Adam (optax's arithmetic) with the trainer's projection, from
    the scene's materials or from the program's leaves (``program``, as
    `after_window` keeps them), the first step at the seed of step
    ``at_step``."""
    from reference.adam import Adam, project
    from reference.pathtracer import Integrator, RefRenderer
    from roofline.bvh import build

    cfg, trf = ctx.cell.config, ctx.cell.traffic
    rs = scenes.reference_scene(cfg)
    ref = RefRenderer(rs, build(rs.v0, rs.e1, rs.e2), ctx.device, dtype)
    integ = Integrator(cfg["num_bounces"], cfg["min_bounces_for_rr"], cfg["exposure"])
    P = ref.params(requires_grad=True)
    if program is not None:
        rows = _rows(program["start"], P)
        P = {k: program["params"][k][rows].to(ctx.device, dtype).requires_grad_(True) for k in P}
    start = {k: v.detach().clone() for k, v in P.items()}
    adam = Adam(list(P.values()), lr=trf["learning_rate"])
    losses, first = [], {}
    for i in range(steps):
        loss = ref.loss(P, opt.seed + at_step + i, target, opt.width, opt.height, opt.spp, integ)
        grads = torch.autograd.grad(loss, list(P.values()))
        losses.append(float(loss.detach()))
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(g.double())) for k, g in zip(P, grads)}
        adam.step(grads)
        project(P)
    change = {k: float(torch.linalg.vector_norm((P[k].detach() - start[k]).double())) for k in P}
    return {"losses": losses, "first_grad": first, "change": change}


def reference_after(ctx, opt, target, after: dict, taken: int, dtype) -> dict:
    """The reference's loss at the parameters the window left, at the seed
    of the step after it."""
    return reference_steps(ctx, opt, target, 1, dtype, program=after, at_step=taken)


def _rows(program_start: dict, ref_start: dict) -> list:
    """For each material row of the reference, the program's row that
    began equal to it in every leaf the reference has: the two sides may
    order a scene's materials differently."""
    def row(P, i):
        return torch.cat([P[k][i].detach().to(ref_start[k].dtype).reshape(-1).cpu().double()
                          for k in ref_start])

    n = next(iter(ref_start.values())).shape[0]
    rows = []
    for i in range(n):
        match = [j for j in range(n) if torch.equal(row(program_start, j), row(ref_start, i))]
        if len(match) != 1:
            raise ValueError(f"the reference's material {i} begins like {len(match)} of the program's")
        rows.append(match[0])
    return rows


def _worst_gap(got: dict, want: dict, floor_share: float = 1e-3):
    """The largest gap between the program's and the reference's norm of a
    leaf, over the larger of that leaf's reference norm and the median
    leaf's; leaves whose reference norm is under ``floor_share`` of the
    median are left out (returned apart); a leaf the program lacks reads
    as 0."""
    med = float(np.median(list(want.values())))
    kept = {k: v for k, v in want.items() if v >= floor_share * med}
    gap = max(abs(got.get(k, 0.0) - v) / max(v, med) for k, v in kept.items())
    return gap, set(want) - set(kept)


def compare(prog: dict, ref: dict, limits: dict):
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, quiet = _worst_gap(prog["first_grad"], ref["first_grad"])
    change_gap, _ = _worst_gap(prog["change"], ref["change"])
    # every leaf the reference does not move (no gradient reaches it there,
    # or under a thousandth of the median leaf's) stays where it was
    unmoved = [k for k in prog["change"] if k not in ref["change"] or k in quiet]
    unmoved_change = max((prog["change"][k] for k in unmoved), default=0.0)
    return [
        ("loss_gap", loss_gap, limits["loss_gap"]),
        ("grad_gap", grad_gap, limits["grad_gap"]),
        ("change_gap", change_gap, limits["change_gap"]),
        ("unmoved_change", unmoved_change, limits["unmoved_change"]),
    ]


def compare_after(after: dict, window_losses, ref1: dict, taken: int, limits: dict):
    """The numbers of the step after the window: its loss against the
    reference's at the same parameters and seed, its step counts off the
    steps taken, and the non-finite values it left."""
    loss = ref1["losses"][0]
    steps_off = max(abs(c - (taken + 1)) for c in after["counts"])
    nonfinite = after["nonfinite"] + sum(not np.isfinite(x) for x in window_losses)
    return [
        ("after_loss_gap", abs(after["loss"] - loss) / abs(loss), limits["after_loss_gap"]),
        ("steps_off", float(steps_off), limits["steps_off"]),
        ("nonfinite", float(nonfinite), limits["nonfinite"]),
    ]
