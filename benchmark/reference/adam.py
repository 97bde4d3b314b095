"""Adam in optax's arithmetic (b1 0.9, b2 0.999, eps 1e-8, bias corrections
formed in float32, `p -= lr * mu_hat / (sqrt(nu_hat) + eps)`), and the
trainer's projection of each leaf onto its valid range, in plain PyTorch."""

from __future__ import annotations

import numpy as np
import torch

BOUNDS = {"mat_reflectance": (0.0, 0.999), "mat_radiance": (0.0, None), "mat_scale": (0.0, None)}


class Adam:
    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.count += 1
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g**2 + self.b2 * nu)
            p.add_((mu / c1) / (torch.sqrt(nu / c2) + self.eps) * -self.lr)


@torch.no_grad()
def project(params: dict) -> None:
    for k, (lo, hi) in BOUNDS.items():
        params[k].clamp_(lo, hi)
