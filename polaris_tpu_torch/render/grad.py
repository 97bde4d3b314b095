"""Differentiable rendering: pixel gradients with respect to materials,
textures and the camera.

Counterpart of the JAX package's ``render/grad.py``. The sample loop is
plain PyTorch, so autograd flows through

  * the material leaves of ``PARAM_FIELDS`` (colors, IORs, roughness,
    scale, mix weights),
  * the float texture atlas ``tex_data`` (bilinear sampling is piecewise
    differentiable),
  * the camera's eye and frustum corner rays,

while hit geometry and every discrete decision (light and lobe selection,
Russian roulette, material-mix branches) carry no gradient: the traversal
kernels run on detached rays (``integrator._trace_bounce``), exactly as in a
frame, and have no backward of their own, as the JAX package's Pallas
kernels have no VJP.

The loss is the JAX ``_build_loss``: samples ``0 .. spp-1`` of
``render_sample_block`` summed from zeros in sample order
(``integrator.render_band_eager`` over the whole frame), the frame brought
to pixel order, ``tonemap_reinhard(accum + 1e-6, 1/spp, exposure)``, and the
mean squared error against a target image. ``loss_and_grad_eager`` runs it
op by op: the reference. ``DifferentiableRenderer`` runs the same function as
one step over static tensors (``render/graph.py``): called directly on the
CPU, and on a card captured once per frame shape (forward and
``torch.autograd.grad`` in one CUDA graph) and replayed; a capture that fails
raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..asset.camera import Camera
from ..asset.scene_data import PARAM_FIELDS
from ..utils.log import get_logger
from .integrator import TorchRenderer, render_band_eager
from .options import RenderOptions
from .shade import tonemap_reinhard

CAMERA_FIELDS = ("eye", "frustum")


def render_loss(r: TorchRenderer, opt: RenderOptions, *, seed, target, frustum, eye,
                closest=None, any_hit=None) -> torch.Tensor:
    """The scalar loss of ``opt.spp`` samples of ``r``'s scene against
    ``target`` [H, W, 3] (tonemapped). Lanes run in the renderer's blocked
    order; one gather restores pixel order before the tonemap. ``seed`` is a
    Python int or a 0-d tensor; ``closest`` / ``any_hit`` default to the
    renderer's."""
    closest = closest or r.closest
    accum = render_band_eager(
        r, opt, frustum=frustum, eye=eye, seed=seed, closest=closest, any_hit=any_hit,
        closest_bounce=closest,  # the JAX loss peels no bounce onto another kernel
    )
    img = tonemap_reinhard(r.finalize(accum, opt) + 1e-6, 1.0 / opt.spp, opt.exposure)
    return torch.mean((img - target) ** 2)


def _grads_or_zeros(loss, leaves):
    """Gradients of ``loss`` for ``leaves``; a leaf that no gradient reaches
    gets zeros, never None."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, gs)]


def loss_and_grad_eager(
    r: "DifferentiableRenderer", opt: RenderOptions, target, camera: Optional[Camera] = None,
    *, closest=None, any_hit=None,
) -> Tuple[float, Dict, Dict]:
    """``r.loss_and_grad`` op by op, every kernel launched on its own: the
    reference the compiled step is held against. ``closest`` / ``any_hit``
    replace the renderer's traversal (its plain version, say)."""
    frustum, eye = r._camera_tensors(opt, camera)
    frustum.requires_grad_(True)
    eye.requires_grad_(True)
    params = list(r.params.values())
    with torch.enable_grad():
        loss = render_loss(
            r, opt, seed=int(opt.seed) & 0xFFFFFFFF, target=r._target(target),
            frustum=frustum, eye=eye, closest=closest, any_hit=any_hit,
        )
        gs = _grads_or_zeros(loss, params + [eye, frustum])
    return (
        float(loss.detach()),
        dict(zip(r.params, gs[: len(params)])),
        dict(zip(CAMERA_FIELDS, gs[len(params):])),
    )


class _LossProgram:
    """The static tensors of one loss shape and its step: inputs the host
    fills before a launch (seed, target, eye and frustum, the last two
    leaves that take a gradient), and results the step writes in place (the
    loss, with ``grad`` one gradient buffer per parameter field and for the
    eye and the frustum)."""

    def __init__(self, r: "DifferentiableRenderer", opt: RenderOptions, grad: bool):
        dev = r.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.target = torch.zeros((opt.height, opt.width, 3), **f32)
        self.eye = torch.zeros(3, **f32, requires_grad=grad)
        self.frustum = torch.zeros((4, 3), **f32, requires_grad=grad)
        self.loss = torch.zeros((), **f32)
        leaves = list(r.params.values()) + [self.eye, self.frustum]
        self.grads = [torch.zeros_like(x) for x in leaves] if grad else []

        def run():
            with torch.set_grad_enabled(grad):
                loss = render_loss(
                    r, opt, seed=self.seed, target=self.target, frustum=self.frustum,
                    eye=self.eye,
                )
                gs = _grads_or_zeros(loss, leaves) if grad else []
            with torch.no_grad():
                self.loss.copy_(loss)
                for buf, g in zip(self.grads, gs):
                    buf.copy_(g)

        self.step = r.step(run)
        self.steps = [self.step]

    @torch.no_grad()
    def set(self, seed: int, target: torch.Tensor, frustum, eye) -> None:
        self.seed.fill_(int(seed) & 0xFFFFFFFF)
        self.target.copy_(target)
        self.frustum.copy_(frustum)
        self.eye.copy_(eye)


class DifferentiableRenderer(TorchRenderer):
    """``TorchRenderer`` with the loss and its gradient over the scene's
    parameter leaves.

    ``params`` maps each field of ``PARAM_FIELDS`` to the very tensor of
    ``self.S`` (a copy of the scene's array made at construction, with
    ``requires_grad`` set); ``geom`` holds the rest of ``S``. The CUDA
    graphs read ``S`` by address, so parameters change in place (an
    optimizer's step, ``render_from_params``), never by rebinding a key of
    ``S``.
    """

    def __init__(self, scene, *args, **kwargs):
        super().__init__(scene, *args, **kwargs)
        # tensors of their own: on the CPU ``upload_scene`` shares the
        # caller's arrays, which an optimizer's in-place step must not reach
        for k in PARAM_FIELDS:
            self.S[k] = self.S[k].detach().clone().requires_grad_(True)
        self.params = {k: self.S[k] for k in PARAM_FIELDS}
        self.geom = {k: v for k, v in self.S.items() if k not in self.params}
        store = getattr(self.scene, "tex_store", None)
        if store is not None and np.any(np.asarray(store) != 0):
            get_logger("grad").warning(
                "scene has byte-stored textures (the compile default): "
                "their texels are NOT differentiable and tex_data "
                "gradients will be zero — recompile with "
                "compile_scene(..., float_textures=True) to train textures"
            )

    def _target(self, target) -> torch.Tensor:
        if not torch.is_tensor(target):
            target = torch.from_numpy(np.asarray(target, np.float32))
        return target.to(self.device, torch.float32)

    def _loss_program(self, opt: RenderOptions, grad: bool) -> _LossProgram:
        """Kept beside the frame programs, under the JAX ``_jit_cache`` keys."""
        key = (opt.width, opt.height, opt.spp, opt.num_bounces, opt.min_bounces_for_rr,
               opt.rr_tile_coherent, "loss" if grad else "lossval")
        return self.program(key, lambda: _LossProgram(self, opt, grad))

    def _run_loss(self, opt, target, camera, grad: bool) -> _LossProgram:
        prog = self._loss_program(opt, grad)
        prog.set(opt.seed, self._target(target), *self._camera_tensors(opt, camera))
        prog.step()
        return prog

    def loss_and_grad(
        self, opt: RenderOptions, target, camera: Optional[Camera] = None
    ) -> Tuple[float, Dict, Dict]:
        """Returns (loss, gradients over the parameter fields, camera
        gradients ``eye`` [3] and ``frustum`` [4, 3]); tensors on the
        renderer's device, zeros where no gradient arrives."""
        prog = self._run_loss(opt, target, camera, grad=True)
        gs = [g.clone() for g in prog.grads]
        n = len(self.params)
        return float(prog.loss), dict(zip(self.params, gs[:n])), dict(zip(CAMERA_FIELDS, gs[n:]))

    def loss_only(self, opt: RenderOptions, target, camera: Optional[Camera] = None) -> float:
        """The same loss without the gradient: the forward side of the
        backward/forward ratio. (The JAX method returns its jitted function;
        this one runs its step.)"""
        return float(self._run_loss(opt, target, camera, grad=False).loss)

    def render_from_params(self, opt: RenderOptions, params: Dict, camera=None) -> torch.Tensor:
        """``render_accum`` with the parameter values of ``params`` (a dict
        over some of ``self.params``' keys): copied into the tensors of
        ``S`` in place for the render, and the old values copied back."""
        saved = {}
        try:
            with torch.no_grad():
                for k, v in params.items():
                    dst = self.params[k]
                    saved[k] = dst.clone()
                    dst.copy_(v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
            return self.render_accum(opt, camera)
        finally:
            with torch.no_grad():
                for k, v in saved.items():
                    self.params[k].copy_(v)
