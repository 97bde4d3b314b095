"""The PyTorch integrator: the sample/bounce loops and the renderer object.

Counterpart of the JAX package's ``render/integrator.py`` (itself the
counterpart of the reference's host-driven pipeline,
``tracer/opencl/pipeline.go:94-213`` + ``tracer/opencl/tracer.go:194-247``).
Everything runs eagerly on the renderer's device: raygen, traversal (the CUDA
kernel on a card, the plain PyTorch traversal on the CPU), shading, NEE
occlusion and accumulation are tensor ops over fixed-shape lanes, ray i <->
pixel i throughout, so the accumulator update is a lanewise add (no scatter).
The RNG is counter-based (ops/rng.py), which makes the image independent of
lane order and of how the samples are chunked into launches.

This slice holds the sequential sample loop (``render_sample_block``),
wavefront path regeneration (``render_block_regen``) and the renderer API
around them. The forward path runs under ``torch.no_grad()``; traversal
inputs are detached (hit geometry is non-differentiable by design).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch

from ..asset.camera import Camera
from ..ops import rng
from ..ops import vec as V
from ..ops.intersect import make_intersectors
from ..ops.material import material_tree_depth
from ..scene import as_scene_data, resolve_device, upload_scene
from ..utils.log import Timer, get_logger
from .options import RenderOptions
from .raygen import gen_rays
from .shade import shade, shade_miss, tonemap_reinhard

_log = get_logger("integrator")

TILE_RAYS = 1024  # lanes per screen block (32x32 pixels)


def blocked_pixel_order(width: int, height: int, block: int = 0):
    """Host-side lane->pixel mapping in block x block screen tiles.

    1024 consecutive lanes then cover a 32x32 pixel block instead of a
    2-row strip, so the rays of a warp (and of a thread block) are
    neighbours on screen and stay coherent through traversal. Returns
    (xs, ys, pixel_idx, inv_lane) as numpy arrays; inv_lane[p] is the lane
    holding pixel p (constant gather used once per render to restore pixel
    order). Falls back to row-major when the frame doesn't divide into
    blocks.
    """
    if not block:
        block = int(round(TILE_RAYS ** 0.5))
    n = width * height
    if width % block or height % block:
        idx = np.arange(n, dtype=np.int64)
        return (
            (idx % width).astype(np.int32),
            (idx // width).astype(np.int32),
            idx.astype(np.uint32),
            idx.astype(np.int32),
        )
    bw = width // block
    lane = np.arange(n, dtype=np.int64)
    b = lane // (block * block)
    within = lane % (block * block)
    bx = (b % bw) * block
    by = (b // bw) * block
    xs = (bx + within % block).astype(np.int32)
    ys = (by + within // block).astype(np.int32)
    pixel_idx = (ys.astype(np.int64) * width + xs).astype(np.uint32)
    inv_lane = np.empty(n, np.int64)
    inv_lane[pixel_idx] = lane
    return xs, ys, pixel_idx, inv_lane.astype(np.int32)


def _trace_bounce(
    S, closest, any_hit, *, ray_o, ray_d, maxt, alive, throughput, flags,
    radiance, U, bounce, is_primary, min_bounces_for_rr, num_emissives,
    scene_diffuse_mat, material_depth,
):
    """One closest-hit + shade + NEE-occlusion pass over all lanes — the body
    both sample loops share. Returns (radiance, shade-output dict)."""
    hit = closest(
        S, ray_o.detach().contiguous(), ray_d.detach().contiguous(), maxt, alive
    )
    t = torch.where(hit.mask, hit.t, 0.0)
    if scene_diffuse_mat >= 0:
        miss = alive & (~hit.mask)
        bg = shade_miss(S, ray_d, throughput, is_primary, scene_diffuse_mat)
        radiance = radiance + torch.where(miss[..., None], bg, 0.0)
    out = shade(
        S,
        U,
        bounce=bounce,
        min_bounces_for_rr=min_bounces_for_rr,
        num_emissives=num_emissives,
        material_depth=material_depth,
        ray_o=ray_o,
        ray_d=ray_d,
        t=t,
        inst=hit.inst,
        tri=hit.tri,
        bary_u=hit.u,
        bary_v=hit.v,
        hit_mask=hit.mask,
        throughput=throughput,
        flags=flags,
    )
    radiance = radiance + out["emit_add"]
    if num_emissives > 0:
        om = out["occl_mask"]
        occluded = any_hit(
            S,
            out["occl_o"].detach().contiguous(),
            out["occl_d"].detach().contiguous(),
            out["occl_maxt"].detach(),
            om,
        )
        nee = om & (~occluded)
        radiance = radiance + torch.where(nee[..., None], out["occl_value"], 0.0)
    return radiance, out


def render_sample_block(
    S: Dict,
    closest,
    any_hit,
    *,
    frustum,
    eye,
    width: int,
    height: int,
    pixel_x,
    pixel_y,
    pixel_idx,
    sample_idx,
    seed,
    num_bounces: int,
    min_bounces_for_rr: int,
    num_emissives: int,
    scene_diffuse_mat: int,
    material_depth: Optional[int] = None,
    rr_tile_coherent: bool = False,
    active_init=None,
    closest_bounce=None,
):
    """Trace ONE sample for a block of pixels; returns radiance [N, 3].

    ``pixel_*`` are full-frame coordinates, so a block of any shape behaves
    exactly like the same pixels of a full-frame render. ``closest_bounce``,
    when given, finds the closest hits of every bounce after the first
    (the 'hybrid' traversal: another kernel for incoherent rays).
    """
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    U0 = rng.make_uniform(seed, pixel_idx, sample_idx, 0)
    ray_o, ray_d = gen_rays(frustum, eye, width, height, pixel_x, pixel_y, U0)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    flags = torch.zeros(n, dtype=torch.int32, device=dev)
    alive = (
        torch.ones(n, dtype=torch.bool, device=dev)
        if active_init is None
        else active_init
    )
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    maxt = torch.full((n,), V.FLT_MAX, dtype=torch.float32, device=dev)
    rr_key = rng.rr_block_key(pixel_idx, width) if rr_tile_coherent else None

    for b in range(num_bounces):
        U = rng.make_uniform(seed, pixel_idx, sample_idx, b, rr_key=rr_key)
        radiance, out = _trace_bounce(
            S, closest_bounce if (closest_bounce is not None and b > 0) else closest,
            any_hit,
            ray_o=ray_o, ray_d=ray_d, maxt=maxt, alive=alive,
            throughput=throughput, flags=flags, radiance=radiance, U=U,
            bounce=b, is_primary=(b == 0),
            min_bounces_for_rr=min_bounces_for_rr,
            num_emissives=num_emissives,
            scene_diffuse_mat=scene_diffuse_mat,
            material_depth=material_depth,
        )
        ray_o, ray_d = out["next_o"], out["next_d"]
        throughput, flags, alive = out["throughput"], out["flags"], out["next_mask"]
    return radiance


def render_block_regen(
    S: Dict,
    closest,
    any_hit,
    *,
    frustum,
    eye,
    width: int,
    height: int,
    pixel_x,
    pixel_y,
    pixel_idx,
    sample_offset: int,
    spp: int,
    seed,
    num_bounces: int,
    min_bounces_for_rr: int,
    num_emissives: int,
    scene_diffuse_mat: int,
    material_depth: Optional[int] = None,
    rr_tile_coherent: bool = False,
):
    """Wavefront PATH REGENERATION: all ``spp`` samples of the block in one
    flat loop; the moment a lane's path ends (RR death, absorbed bounce,
    miss, bounce cap) it restarts at its OWN pixel with its next sample
    index. No permutation and no coherence loss: the pixel<->lane binding
    never changes, and regenerated rays are block-coherent primaries.

    The RNG keys every draw by (pixel, sample, bounce, stream), so each path
    sees EXACTLY the draws the sequential sample loop gives it — the
    estimator is unchanged; only the float accumulation order differs
    (contributions stream into one accumulator in per-lane chronological
    order instead of per-sample partial sums).

    Runs until every lane exhausts its sample budget. The loop condition is
    read back to the host once per trip (one device synchronisation each);
    b strictly increases to the bounce cap and s strictly increases on every
    regeneration, so trips <= spp * num_bounces. Returns (radiance, trips).
    """
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    maxt = torch.full((n,), V.FLT_MAX, dtype=torch.float32, device=dev)
    s_end = sample_offset + spp

    def primary(s_idx):
        U0 = rng.make_uniform(seed, pixel_idx, s_idx, 0)
        return gen_rays(frustum, eye, width, height, pixel_x, pixel_y, U0)

    s = torch.full((n,), int(sample_offset), dtype=torch.int64, device=dev)
    ray_o, ray_d = primary(s)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    flags = torch.zeros(n, dtype=torch.int32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    b = torch.zeros(n, dtype=torch.int64, device=dev)  # per-lane bounce
    rr_key = rng.rr_block_key(pixel_idx, width) if rr_tile_coherent else None
    trips = 0

    while bool(alive.any()):
        U = rng.make_uniform(seed, pixel_idx, s, b, rr_key=rr_key)
        radiance, out = _trace_bounce(
            S, closest, any_hit,
            ray_o=ray_o, ray_d=ray_d, maxt=maxt, alive=alive,
            throughput=throughput, flags=flags, radiance=radiance, U=U,
            bounce=b, is_primary=(b == 0)[..., None],
            min_bounces_for_rr=min_bounces_for_rr,
            num_emissives=num_emissives,
            scene_diffuse_mat=scene_diffuse_mat,
            material_depth=material_depth,
        )
        cont = alive & out["next_mask"] & (b + 1 < num_bounces)
        regen = alive & (~cont) & (s + 1 < s_end)
        s = torch.where(regen, s + 1, s)
        o0, d0 = primary(s)  # cheap vector math; where-selected below
        regen3 = regen[..., None]
        ray_o = torch.where(regen3, o0, out["next_o"])
        ray_d = torch.where(regen3, d0, out["next_d"])
        throughput = torch.where(regen3, 1.0, out["throughput"])
        flags = torch.where(regen, 0, out["flags"])
        b = torch.where(cont, b + 1, 0)
        alive = cont | regen
        trips += 1
    return radiance, trips


class TorchRenderer:
    """Single-device renderer over a compiled scene.

    ``device=None`` means the CUDA device and raises when there is none;
    the CPU is used only on request (``device="cpu"``). ``mode`` selects the
    traversal backend (``ops/intersect.py::make_intersectors`` lists the
    modes) and ``tri_test`` the binary kernel's triangle test (``"mt"`` or
    ``"hh"``; ``None`` reads ``POLARIS_TRI_TEST``); ``regen`` switches the sample loop to wavefront path
    regeneration. A mode that peels the bounces after the first onto another
    kernel ('hybrid') cannot regenerate, because regeneration mixes bounce
    depths in one pass: the renderer then warns and takes the sequential
    sample loop.
    """

    # samples per launch of the sample loop: bounds the work queued between
    # two host-side accumulator updates, and is the unit progressive
    # accumulation advances by
    spp_per_launch = 8

    def __init__(
        self, scene, device=None, mode: str = "auto", regen: bool = False,
        tri_test: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.scene = as_scene_data(scene)
        self.regen = regen
        self.S = upload_scene(self.scene, self.device)
        self.closest, self.any_hit = make_intersectors(self.S, mode, tri_test)
        self.closest_bounce = getattr(self.closest, "closest_bounce", None)
        if self.regen and self.closest_bounce is not None:
            _log.warning(
                "regen is unsupported with the hybrid traversal's peeled "
                "bounce kernel; using the sequential sample loop"
            )
            self.regen = False
        self.num_emissives = int(self.scene.emis_area.shape[0])
        self.scene_diffuse_mat = int(self.scene.scene_diffuse_mat)
        self.material_depth = material_tree_depth(
            self.scene.mat_type, self.scene.mat_left, self.scene.mat_right
        )
        self.last_render_ms = 0.0
        self.last_trips = 0
        self._order_cache: Dict = {}

    # ----- plumbing -----

    def _pixel_order(self, W: int, H: int):
        """Device copies of the blocked lane->pixel mapping for a frame."""
        key = (W, H)
        if key not in self._order_cache:
            h_xs, h_ys, h_pix, h_inv = blocked_pixel_order(W, H)
            blocked = not np.array_equal(h_pix, np.arange(W * H, dtype=np.uint32))
            dev = self.device
            self._order_cache[key] = (
                torch.from_numpy(h_xs).to(dev),
                torch.from_numpy(h_ys).to(dev),
                torch.from_numpy(h_pix.astype(np.int64)).to(dev),
                torch.from_numpy(h_inv.astype(np.int64)).to(dev) if blocked else None,
            )
        return self._order_cache[key]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _camera_tensors(self, opt: RenderOptions, camera: Optional[Camera]):
        cam = camera or Camera.from_scene(self.scene, opt.width, opt.height)
        frustum = torch.from_numpy(np.asarray(cam.frustum, np.float32)).to(self.device)
        eye = torch.from_numpy(np.asarray(cam.position, np.float32)).to(self.device)
        return frustum, eye

    def _block_partial(self, opt: RenderOptions, frustum, eye, sample_offset: int):
        """Sum of ``opt.spp`` samples' radiance in BLOCKED lane order — the
        single implementation behind one-launch and chunked renders.
        Dispatches to wavefront regeneration or the sequential sample loop;
        the partial is summed from zero."""
        W, H = opt.width, opt.height
        xs, ys, pix, _ = self._pixel_order(W, H)
        common = dict(
            frustum=frustum,
            eye=eye,
            width=W,
            height=H,
            pixel_x=xs,
            pixel_y=ys,
            pixel_idx=pix,
            seed=int(opt.seed),
            num_bounces=opt.num_bounces,
            min_bounces_for_rr=opt.min_bounces_for_rr,
            num_emissives=self.num_emissives,
            scene_diffuse_mat=self.scene_diffuse_mat,
            material_depth=self.material_depth,
            rr_tile_coherent=opt.rr_tile_coherent,
        )
        if self.regen:
            part, trips = render_block_regen(
                self.S, self.closest, self.any_hit,
                sample_offset=sample_offset, spp=opt.spp, **common,
            )
            self.last_trips += trips
            return part
        accum = torch.zeros((W * H, 3), dtype=torch.float32, device=self.device)
        for s in range(opt.spp):
            accum = accum + render_sample_block(
                self.S, self.closest, self.any_hit,
                sample_idx=sample_offset + s,
                closest_bounce=self.closest_bounce, **common,
            )
        self.last_trips += opt.spp * opt.num_bounces
        return accum

    def _render_accum_blocked(self, opt: RenderOptions, camera, sample_offset: int = 0):
        """Render opt.spp samples in spp_per_launch chunks into a device
        accumulator in blocked lane order. Each chunk's partial is summed
        from zero and then added — (chunk0)+(chunk1)+... — so the float
        association does not depend on anything but the chunk size."""
        frustum, eye = self._camera_tensors(opt, camera)
        n = opt.width * opt.height
        accum = torch.zeros((n, 3), dtype=torch.float32, device=self.device)
        self.last_trips = 0
        done = 0
        while done < opt.spp:
            chunk = min(self.spp_per_launch, opt.spp - done)
            part = self._block_partial(
                replace(opt, spp=chunk), frustum, eye, sample_offset + done
            )
            accum = accum + part
            done += chunk
        return accum

    def _unblock(self, accum, opt: RenderOptions):
        """Restore pixel order from blocked lane order: [H, W, 3]."""
        inv = self._pixel_order(opt.width, opt.height)[3]
        if inv is not None:
            accum = accum[inv]
        return accum.reshape(opt.height, opt.width, 3)

    # ----- public API -----

    @torch.no_grad()
    def render_accum_offset(
        self,
        opt: RenderOptions,
        camera: Optional[Camera] = None,
        sample_offset: int = 0,
    ) -> torch.Tensor:
        """Render opt.spp samples starting at an absolute sample index
        (progressive accumulation); returns the f32 accumulator [H, W, 3]
        on the renderer's device."""
        with Timer() as t:
            out = self._unblock(
                self._render_accum_blocked(opt, camera, sample_offset), opt
            )
            self._sync()
        self.last_render_ms = t.ms
        return out

    def render_accum(
        self, opt: RenderOptions, camera: Optional[Camera] = None
    ) -> torch.Tensor:
        return self.render_accum_offset(opt, camera, sample_offset=0)

    @torch.no_grad()
    def render(self, opt: RenderOptions, camera: Optional[Camera] = None):
        """Tonemapped float image [H, W, 3] in [0, 1] as a numpy array."""
        accum = self.render_accum(opt, camera)
        img = tonemap_reinhard(accum, 1.0 / opt.spp, opt.exposure)
        return img.cpu().numpy()

    @torch.no_grad()
    def render_u8(self, opt: RenderOptions, camera: Optional[Camera] = None):
        """Render and tonemap fully on the device; returns [H, W, 3] uint8
        on the host. The timed span covers render, tonemap, quantize and the
        fetch of the u8 image."""
        with Timer() as t:
            accum = self._unblock(self._render_accum_blocked(opt, camera), opt)
            # sample weight x exposure as one float32 product
            scale = float(np.float32(1.0 / opt.spp) * np.float32(opt.exposure))
            img = tonemap_reinhard(accum, scale, 1.0)
            out = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
        self.last_render_ms = t.ms
        return out
