"""A tile x sample device mesh in one process.

Counterpart of the JAX package's ``parallel/mesh.py``, which runs one SPMD
program over a ``jax.sharding.Mesh`` of local devices (``shard_map`` +
``psum``). Here the mesh is a (tile, sample) grid of torch devices, which
may name one device more than once (four shards on one card, say):

  * the 'tile' axis splits the image rows: shard (t, s) renders the band of
    rows ``[t * rows, (t + 1) * rows)``, through its device's renderer
    (``TorchRenderer.render_band_accum``'s work, queued without a wait, so
    the devices of a mesh run at once)
  * the 'sample' axis splits the samples: shard (t, s) renders samples
    ``[s * spp_local, (s + 1) * spp_local)``, and the shards of a tile are
    summed in sample order on the tile's first device: the ``psum`` over
    'sample'
  * the tiles are stacked on the mesh's first device, the primary

Because the RNG is counter-based and keyed on (pixel, sample), the image of
a tile-only mesh is bit-identical to the single renderer's, and a split of
the samples differs only by the order of the float additions.

``multihost.py`` runs the same split over processes with
``torch.distributed``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional

import numpy as np
import torch

from ..asset.camera import Camera
from ..asset.scene_data import PARAM_FIELDS
from ..render.integrator import TorchRenderer, render_band_eager
from ..render.options import RenderOptions
from ..render.shade import tonemap_reinhard
from ..scene import as_scene_data
from ..utils.log import Timer


class Mesh:
    """A (tile, sample) grid of torch devices: ``devices[t][s]`` is shard
    (t, s)'s, ``shape`` maps each axis name to its size, as a JAX mesh's
    does."""

    def __init__(self, devices: List[List]):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.shape = {"tile": len(self.devices), "sample": len(self.devices[0])}


def split(opt: RenderOptions, shape: dict):
    """Rows per tile and samples per sample shard of a mesh of ``shape``;
    raises where the frame does not divide (the JAX package asserts)."""
    tiles, samples = shape["tile"], shape["sample"]
    if opt.height % tiles:
        raise ValueError(
            f"rows must divide: the frame's {opt.height} rows do not split into {tiles} tiles"
        )
    if opt.spp % samples:
        raise ValueError(
            f"spp must divide: {opt.spp} samples do not split into {samples} sample shards"
        )
    return opt.height // tiles, opt.spp // samples


def make_mesh(tile: int, sample: int, devices=None) -> Mesh:
    """A (tile, sample) mesh over the first ``tile * sample`` of ``devices``,
    tile-major; ``devices`` defaults to every CUDA device and raises without
    one. A list may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices=['cpu', ...] explicitly "
                "to build a mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < tile * sample:
        raise ValueError(f"need {tile * sample} devices, have {len(devices)}")
    return Mesh([devices[t * sample:(t + 1) * sample] for t in range(tile)])


class DistributedRenderer:
    """Renders an image sharded over rows ('tile') and samples ('sample').

    One ``TorchRenderer`` per distinct device of the mesh; the shards on a
    device share its renderer and its programs. ``params`` holds the
    scene's material parameters on the primary device; ``train_step``
    updates them, and copies them in place into every renderer's scene
    tensors, so later renders see them (the graphs read those tensors by
    address)."""

    def __init__(self, scene, mesh: Mesh, mode: str = "auto"):
        self.scene = as_scene_data(scene)
        self.mesh = mesh
        self.renderers: Dict[torch.device, TorchRenderer] = {}
        for row in mesh.devices:
            for d in row:
                if d not in self.renderers:
                    r = TorchRenderer(self.scene, device=d, mode=mode)
                    # tensors of their own, which a train step updates in
                    # place (on the CPU upload_scene shares the caller's)
                    for k in PARAM_FIELDS:
                        r.S[k] = r.S[k].clone()
                    self.renderers[d] = r
        self.device = mesh.devices[0][0]
        self.params = {k: self.renderers[self.device].S[k].clone() for k in PARAM_FIELDS}
        self.last_render_ms = 0.0

    def _camera(self, opt: RenderOptions, camera: Optional[Camera]) -> Camera:
        return camera or Camera.from_scene(self.scene, opt.width, opt.height)

    @torch.no_grad()
    def render_accum(self, opt: RenderOptions, camera: Optional[Camera] = None) -> torch.Tensor:
        """The f32 accumulator [H, W, 3] on the primary device."""
        rows, spp_local = split(opt, self.mesh.shape)
        local = replace(opt, spp=spp_local)
        cam = self._camera(opt, camera)
        with Timer() as t:
            views = {d: r._camera_tensors(opt, cam) for d, r in self.renderers.items()}
            tiles = []
            for ti, row in enumerate(self.mesh.devices):
                acc = None
                for si, d in enumerate(row):
                    band = self.renderers[d]._render_band(
                        local, ti * rows, rows, *views[d], si * spp_local
                    ).to(row[0])
                    # ≙ the psum over 'sample' (accumulator.cl:13-19's merge)
                    acc = band if acc is None else acc + band
                tiles.append(acc.to(self.device))
            out = torch.cat(tiles, dim=0)
            for d in self.renderers:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
        self.last_render_ms = t.ms
        return out

    def render(self, opt: RenderOptions, camera: Optional[Camera] = None) -> np.ndarray:
        accum = self.render_accum(opt, camera)
        return tonemap_reinhard(accum, 1.0 / opt.spp, opt.exposure).cpu().numpy()

    # ----- distributed differentiable training -----

    def make_train_step(self, opt: RenderOptions, lr: float = 0.1):
        """The distributed training step: render -> loss against a target ->
        parameter gradients summed over BOTH mesh axes -> SGD.

        Returns ``step(params, frustum, eye, target) -> (loss, new params)``
        (tensors on the primary device). Each shard renders its band's
        samples op by op with autograd (``render_band_eager``), the
        parameters reaching it as ``.to(device)`` copies of ``params``; a
        tile's shards are summed in sample order; each tile's loss is the JAX
        ``local_loss``: ``tonemap_reinhard(accum + 1e-6, 1/spp, exposure)``,
        ``sum((img - target)^2) / (W*H*3)``; the tiles' losses are summed on
        the primary device, and one ``torch.autograd.grad`` sums every
        shard's gradient into ``params``'."""
        rows, spp_local = split(opt, self.mesh.shape)
        local = replace(opt, spp=spp_local)
        norm = opt.width * opt.height * 3

        def step(params, frustum, eye, target):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            with torch.enable_grad():
                loss = None
                for ti, row in enumerate(self.mesh.devices):
                    acc = None
                    for si, d in enumerate(row):
                        r = self.renderers[d]
                        band = render_band_eager(
                            r, local, frustum=frustum.to(d), eye=eye.to(d), y0=ti * rows,
                            band_h=rows, sample_offset=si * spp_local,
                            S=dict(r.S, **{k: v.to(d) for k, v in leaves.items()}),
                        )
                        band = r.finalize(band, replace(local, height=rows)).to(row[0])
                        acc = band if acc is None else acc + band
                    img = tonemap_reinhard(acc + 1e-6, 1.0 / opt.spp, opt.exposure)
                    want = target[ti * rows:(ti + 1) * rows].to(row[0])
                    tile_loss = (torch.sum((img - want) ** 2) / norm).to(self.device)
                    loss = tile_loss if loss is None else loss + tile_loss
                grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            new = {
                k: (params[k] - lr * g).detach() if g is not None else params[k].clone()
                for (k, _), g in zip(leaves.items(), grads)
            }
            return loss.detach(), new

        return step

    def train_step(self, opt: RenderOptions, target, lr: float = 0.1, camera=None) -> float:
        """Run one distributed optimization step; updates ``self.params``
        and every renderer's scene tensors in place. Returns the loss."""
        cam = self._camera(opt, camera)
        frustum, eye = self.renderers[self.device]._camera_tensors(opt, cam)
        if not torch.is_tensor(target):
            target = torch.from_numpy(np.asarray(target, np.float32))
        target = target.to(self.device, torch.float32)
        loss, new = self.make_train_step(opt, lr)(self.params, frustum, eye, target)
        with torch.no_grad():
            for k, v in new.items():
                self.params[k].copy_(v)
                for r in self.renderers.values():
                    r.S[k].copy_(v)
        return float(loss)
