"""Inverse-rendering trainer: fit scene parameters to a target image, with
checkpoint and resume.

Counterpart of the JAX package's ``render/trainer.py``, with the same
configuration, bounds table and checkpoint files. Its optimizers compute
what optax computes. ``sgd`` is ``torch.optim.SGD``. ``adam`` and
``rmsprop`` are written out below in optax's arithmetic:
``torch.optim.Adam`` forms its bias corrections in double precision and
divides ``sqrt(nu)`` by ``sqrt(1 - b2^t)`` where optax forms them in float32
and takes ``sqrt(nu / (1 - b2^t))`` (after five steps the two differ by up to
6e-5 of a parameter's value), and ``torch.optim.RMSprop`` decays by 0.99 and
adds ``eps`` outside the square root where optax decays by 0.9 and adds it
inside. Every trainable leaf is handed a gradient on every step, zeros
included, so Adam's per-leaf step count stays optax's shared ``count``.

A checkpoint ``ckpt_%06d.npz`` holds ``param.<k>`` for every parameter
field, ``opt.<i>`` the optax state's leaves in their flatten order (adam:
``count``, then ``mu`` and ``nu`` over the sorted trainable keys; rmsprop:
``nu`` over them; sgd: none), ``step``, ``history`` and ``camera_eye``: a
checkpoint either package writes resumes in the other.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..asset.camera import Camera
from ..asset.scene_data import PARAM_FIELDS
from ..utils.log import Timer, get_logger
from .grad import DifferentiableRenderer
from .options import RenderOptions

_log = get_logger("trainer")


@dataclass
class TrainConfig:
    learning_rate: float = 5e-2
    optimizer: str = "adam"  # adam | sgd | rmsprop
    num_steps: int = 100
    # which parameter leaves to optimize (default: all material+texture)
    trainable: Sequence[str] = tuple(PARAM_FIELDS)
    optimize_camera: bool = False
    # per-step sample reseeding decorrelates gradient noise across steps
    reseed_each_step: bool = True
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25


_PARAM_BOUNDS = {
    # (min, max) projection applied after every update — keeps the physics
    # valid (the DSL validator enforces the same ranges at parse time,
    # asset/material/nodes.py)
    "mat_reflectance": (0.0, 0.999),
    "mat_specularity": (0.0, 1.0),
    "mat_transmittance": (0.0, 1.0),
    "mat_radiance": (0.0, None),
    "mat_scale": (0.0, None),
    "mat_roughness": (0.0, 1.0),
    "mat_mix_weight": (0.0, 1.0),
    "mat_int_ior": (0.0, 4.0),
    "mat_ext_ior": (0.0, 4.0),
    "mat_int_disp_ior": (0.0, 4.0),
    "mat_ext_disp_ior": (0.0, 4.0),
    "tex_data": (0.0, None),
}


@torch.no_grad()
def project_params(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Clamp every parameter leaf to its physically valid range, in place;
    returns ``params``."""
    for k, (lo, hi) in _PARAM_BOUNDS.items():
        if k in params:
            params[k].clamp_(lo, hi)
    return params


def _f32_bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax forms it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class OptaxAdam(torch.optim.Optimizer):
    """``optax.adam(lr)`` at its defaults (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0): ``mu`` and ``nu`` from zeros, ``p += -lr * mu_hat /
    (sqrt(nu_hat) + eps)``. State per parameter: ``count``, ``mu``, ``nu``."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if "mu" not in state:
                    state.update(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                state["count"] += 1
                mu, nu = state["mu"], state["nu"]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * g**2 + b2 * nu)
                mu_hat = mu / _f32_bias_correction(b1, state["count"])
                nu_hat = nu / _f32_bias_correction(b2, state["count"])
                p.add_(mu_hat / (torch.sqrt(nu_hat) + eps) * -lr)


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)`` at its defaults: ``nu = (1 - decay) g^2 +
    decay nu`` from zeros, then ``p += -lr * g * rsqrt(nu + eps)``; no bias
    correction, no momentum. State per parameter: ``nu``."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - decay) * g**2 + decay * nu)
                p.add_(torch.rsqrt(nu + eps) * g * -lr)


_OPTIMIZERS = {
    "adam": lambda params, lr: OptaxAdam(params, lr=lr),
    "sgd": lambda params, lr: torch.optim.SGD(params, lr=lr),
    "rmsprop": lambda params, lr: OptaxRMSprop(params, lr=lr),
}


class Trainer:
    def __init__(
        self,
        scene,
        opt: RenderOptions,
        cfg: TrainConfig,
        mode: str = "auto",
        device=None,
    ):
        self.renderer = DifferentiableRenderer(scene, device=device, mode=mode)
        self.opt = opt
        self.cfg = cfg
        self.step_idx = 0
        # the trainable leaves in optax's flatten order (sorted keys)
        self.trainable = {
            k: self.renderer.params[k]
            for k in sorted(self.renderer.params) if k in cfg.trainable
        }
        # torch's optimizers refuse an empty list, where optax takes an
        # empty tree (a camera-only fit)
        self.optimizer = _OPTIMIZERS[cfg.optimizer](
            list(self.trainable.values()), cfg.learning_rate
        ) if self.trainable else None
        self.camera = Camera.from_scene(self.renderer.scene, opt.width, opt.height)
        self.history: List[float] = []

    def step(self, target) -> float:
        """One optimization step; returns the loss."""
        opt = self.opt
        if self.cfg.reseed_each_step:
            opt = replace(opt, seed=self.opt.seed + self.step_idx)
        loss, g_params, g_cam = self.renderer.loss_and_grad(opt, target, self.camera)
        for k, p in self.trainable.items():
            p.grad = g_params[k]
        if self.optimizer is not None:
            self.optimizer.step()
        project_params(self.renderer.params)
        if self.cfg.optimize_camera:
            eye = torch.from_numpy(np.asarray(self.camera.position, np.float32))
            self.camera.position = (eye - self.cfg.learning_rate * g_cam["eye"].cpu()).numpy()
            self.camera.update()
        self.step_idx += 1
        self.history.append(loss)
        return loss

    def fit(self, target) -> List[float]:
        for _ in range(self.cfg.num_steps):
            with Timer() as t:
                loss = self.step(target)
            _log.info("step %d: loss %.6f (%.0f ms)", self.step_idx, loss, t.ms)
            if (
                self.cfg.checkpoint_dir
                and self.step_idx % self.cfg.checkpoint_every == 0
            ):
                self.save_checkpoint()
        if self.cfg.checkpoint_dir:
            self.save_checkpoint()
        return self.history

    # ----- checkpoint / resume -----

    def _opt_leaves(self) -> List[np.ndarray]:
        """The optimizer state as the optax state's leaves, in order."""
        ps = list(self.trainable.values())

        def moment(p, name):
            v = self.optimizer.state[p].get(name)
            return (torch.zeros_like(p) if v is None else v).detach().cpu().numpy()

        if self.cfg.optimizer == "adam":
            count = self.optimizer.state[ps[0]].get("count", 0) if ps else 0
            return (
                [np.asarray(count, np.int32)]
                + [moment(p, "mu") for p in ps]
                + [moment(p, "nu") for p in ps]
            )
        if self.cfg.optimizer == "rmsprop":
            return [moment(p, "nu") for p in ps]
        return []

    def _set_opt_leaves(self, leaves: List[np.ndarray]) -> None:
        ps = list(self.trainable.values())
        dev = self.renderer.device

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        if self.cfg.optimizer == "adam":
            count, k = int(leaves[0]), len(ps)
            for i, p in enumerate(ps):
                self.optimizer.state[p] = {
                    "count": count, "mu": t(leaves[1 + i]), "nu": t(leaves[1 + k + i]),
                }
        elif self.cfg.optimizer == "rmsprop":
            for p, nu in zip(ps, leaves):
                self.optimizer.state[p] = {"nu": t(nu)}

    def save_checkpoint(self) -> str:
        d = self.cfg.checkpoint_dir
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"ckpt_{self.step_idx:06d}.npz")
        flat = {
            f"param.{k}": v.detach().cpu().numpy() for k, v in self.renderer.params.items()
        }
        for i, leaf in enumerate(self._opt_leaves()):
            flat[f"opt.{i}"] = leaf
        flat["step"] = np.asarray(self.step_idx)
        flat["history"] = np.asarray(self.history, np.float32)
        flat["camera_eye"] = np.asarray(self.camera.position)
        np.savez_compressed(path, **flat)
        _log.info("wrote checkpoint %s", path)
        return path

    def restore_checkpoint(self, path: Optional[str] = None) -> None:
        if path is None:
            d = self.cfg.checkpoint_dir
            ckpts = sorted(
                f for f in os.listdir(d) if f.startswith("ckpt_") and f.endswith(".npz")
            )
            if not ckpts:
                raise FileNotFoundError(f"no checkpoints in {d}")
            path = os.path.join(d, ckpts[-1])
        data = np.load(path)
        with torch.no_grad():
            for k in data.files:
                if k.startswith("param."):
                    self.renderer.params[k[len("param."):]].copy_(torch.from_numpy(data[k]))
        n = len(self._opt_leaves())
        self._set_opt_leaves([data[f"opt.{i}"] for i in range(n)])
        self.step_idx = int(data["step"])
        self.history = list(np.asarray(data["history"]))
        self.camera.position = np.asarray(data["camera_eye"])
        self.camera.update()
        _log.info("restored checkpoint %s (step %d)", path, self.step_idx)
