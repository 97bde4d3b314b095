"""The PyTorch integrator: the sample/bounce loops and the renderer object.

Counterpart of the JAX package's ``render/integrator.py`` (itself the
counterpart of the reference's host-driven pipeline,
``tracer/opencl/pipeline.go:94-213`` + ``tracer/opencl/tracer.go:194-247``).
Raygen, traversal (the CUDA kernel on a card, the plain PyTorch traversal on
the CPU), shading, NEE occlusion and accumulation are tensor ops over
fixed-shape lanes, ray i <-> pixel i throughout, so the accumulator update
is a lanewise add (no scatter). The RNG is counter-based (ops/rng.py), which
makes the image independent of lane order and of how the samples are
chunked into launches.

The loops exist twice over the same bodies. The eager functions
(``render_sample_block``, ``render_band_eager``, ``render_block_regen``
over ``regen_start`` / ``regen_trip``, ``render_blocked_eager``) launch
every op on its own; the CPU, autograd and the reference checks run them.
``TorchRenderer`` runs one step of a loop as a function of static device
tensors, replayed from a CUDA graph on a card (``render/graph.py``; run
uncaptured there with a traversal that reads back to the host): the
counterpart of the JAX package's compiled programs (``_get_render_fn``,
``_get_chunk_carry_fn``, ``_get_finalize_fn``, ``_get_adaptive_fn``), and
bit-equal to the eager loops. The forward path runs under
``torch.no_grad()``; traversal inputs are detached (hit geometry is
non-differentiable by design).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch

from ..asset.camera import Camera
from ..ops import rng
from ..ops import vec as V
from ..ops.intersect import Hit, make_intersectors
from ..ops.material import material_tree_depth
from ..scene import as_scene_data, resolve_device, upload_scene
from ..utils.log import Timer, get_logger
from .graph import Step
from .options import RenderOptions
from .raygen import gen_rays
from .shade import shade, shade_miss, tonemap_reinhard

_log = get_logger("integrator")

TILE_RAYS = 1024  # lanes per screen block (32x32 pixels)
TILE_LANES = TILE_RAYS  # lanes per adaptive-sampling block: one screen block


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


# ----- lane permutations of the opt-in modes (compact, sort_rays) -----


def _compact_pos(mask):
    """Stable partition target slots: masked lanes first, the others after,
    each in lane order: ``position[i]`` is lane i's rank within its class,
    from prefix sums (no sort)."""
    a = mask.to(torch.int64)
    live_pos = torch.cumsum(a, 0) - 1
    dead_pos = a.sum() + torch.cumsum(1 - a, 0) - 1
    return torch.where(mask, live_pos, dead_pos)


def _inv_perm(pos):
    """Invert a permutation with one integer scatter; data then moves with
    row gathers (``_take``)."""
    lanes = torch.arange(pos.shape[0], dtype=pos.dtype, device=pos.device)
    return torch.zeros_like(pos).scatter_(0, pos, lanes)


def _take(x, idx):
    """Rows ``idx`` of ``x`` (a gather, capturable into a CUDA graph)."""
    return torch.index_select(x, 0, idx)


def _octant_key(d, mask):
    """Bucket id per lane: direction octant (0..7), dead lanes last (8)."""
    octant = (
        (d[..., 0] < 0).to(torch.int64)
        | ((d[..., 1] < 0).to(torch.int64) << 1)
        | ((d[..., 2] < 0).to(torch.int64) << 2)
    )
    return torch.where(mask, octant, 8)


def _bucket_positions(key, num_buckets: int):
    """Stable counting-sort target slots from one prefix sum per bucket:
    lanes keep their blocked order inside each bucket, which keeps ray
    origins coherent."""
    pos = torch.zeros_like(key)
    offset = torch.zeros((), dtype=key.dtype, device=key.device)
    for b in range(num_buckets):
        m = key == b
        c = torch.cumsum(m.to(key.dtype), 0)
        pos = torch.where(m, offset + c - 1, pos)
        offset = offset + c[-1]
    return pos


def sorted_pass(fn, *, any_hit: bool):
    """Wrap an intersector so each call traverses its rays grouped by
    direction octant, dead lanes last (the JAX package's
    ``make_sorted_pass``): rays that descend the BVH the same way sit
    together while same-block rays stay adjacent. Hits are gathered back to
    lane order, so images are bit-identical: the RNG keys by pixel id, not
    by lane."""

    def run(S, o, d, maxt, mask):
        pos = _bucket_positions(_octant_key(d, mask), 9)
        perm = _inv_perm(pos)  # slot -> lane
        res = fn(S, _take(o, perm), _take(d, perm), _take(maxt, perm), _take(mask, perm))
        if any_hit:
            return _take(res, pos)
        return Hit(*(_take(x, pos) for x in res))

    return run


def _trace_bounce(
    S, closest, any_hit, *, ray_o, ray_d, maxt, alive, throughput, flags,
    radiance, U, bounce, is_primary, min_bounces_for_rr, num_emissives,
    scene_diffuse_mat, material_depth, compact: bool = False,
):
    """One closest-hit + shade + NEE-occlusion pass over all lanes — the body
    both sample loops share. Returns (radiance, shade-output dict).
    ``compact`` packs the shadow rays into the leading lanes for the any-hit
    pass and maps the verdicts back."""
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
        rays = (out["occl_o"].detach(), out["occl_d"].detach(), out["occl_maxt"].detach(), om)
        if compact:
            # shadow rays are far sparser than live lanes: packed apart
            opos = _compact_pos(om)
            oinv = _inv_perm(opos)
            occluded = _take(any_hit(S, *(_take(x, oinv) for x in rays)), opos)
        else:
            occluded = any_hit(S, *(x.contiguous() for x in rays))
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
    compact: bool = False,
):
    """Trace ONE sample for a block of pixels; returns radiance [N, 3].

    ``pixel_*`` are full-frame coordinates, so a block of any shape behaves
    exactly like the same pixels of a full-frame render. ``sample_idx`` is
    one index (an int or a 0-d tensor) or one per lane. ``closest_bounce``,
    when given, finds the closest hits of every bounce after the first
    (the 'hybrid' traversal: another kernel for incoherent rays).
    ``compact`` packs the live lanes into the leading lanes before each
    closest-hit pass, carrying each lane's pixel (and sample) index, which
    key its draws, and its own lane id, which brings the radiance back to
    lane order at the end: the result is bit-identical.
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
    pix, lane = pixel_idx, (torch.arange(n, device=dev) if compact else None)

    for b in range(num_bounces):
        if compact:
            inv = _inv_perm(_compact_pos(alive))
            ray_o, ray_d, throughput, flags, alive, radiance, pix, lane = (
                _take(x, inv)
                for x in (ray_o, ray_d, throughput, flags, alive, radiance, pix, lane)
            )
            if rr_key is not None:
                rr_key = _take(rr_key, inv)
            if torch.is_tensor(sample_idx) and sample_idx.dim():
                sample_idx = _take(sample_idx, inv)
        U = rng.make_uniform(seed, pix, sample_idx, b, rr_key=rr_key)
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
            compact=compact,
        )
        ray_o, ray_d = out["next_o"], out["next_d"]
        throughput, flags, alive = out["throughput"], out["flags"], out["next_mask"]
    if compact:
        radiance = _take(radiance, _inv_perm(lane))
    return radiance


def render_sample_batch(S, closest, any_hit, *, pixel_x, pixel_y, pixel_idx, spp: int,
                        sample_offset, **kw):
    """``spp`` samples from ``sample_offset`` (an int or a 0-d tensor) of
    every lane as ONE wide batch of ``spp * n`` lanes, sample-major, through
    ``render_sample_block`` (``kw``: its other arguments); the partials are
    summed in sample order, ``parts[0] + parts[1] + ...``, the association
    of the sequential loop, so the sum is bit-identical to it. The JAX
    package's ``batch_samples`` program. Returns [n, 3]."""
    n = pixel_idx.shape[0]
    sample = sample_offset + torch.arange(spp, device=pixel_idx.device).repeat_interleave(n)
    rad = render_sample_block(
        S, closest, any_hit, pixel_x=pixel_x.repeat(spp), pixel_y=pixel_y.repeat(spp),
        pixel_idx=pixel_idx.repeat(spp), sample_idx=sample, **kw,
    )
    parts = rad.reshape(spp, n, 3)
    accum = parts[0]
    for s in range(1, spp):
        accum = accum + parts[s]
    return accum


def _primary(*, seed, frustum, eye, width, height, pixel_x, pixel_y, pixel_idx, s):
    """Primary rays of sample(s) ``s`` of every lane."""
    U0 = rng.make_uniform(seed, pixel_idx, s, 0)
    return gen_rays(frustum, eye, width, height, pixel_x, pixel_y, U0)


def band_pixels(xs, ys, row0, width: int):
    """Full-frame ``(pixel_x, pixel_y, pixel_idx)`` of the lanes of a row
    band whose top row is ``row0`` (a Python int or a 0-d tensor), from the
    band's own lane order ``xs``, ``ys``. The full frame's pixel index keys
    the RNG, so a band renders exactly the same rows of a full frame."""
    ys = ys + row0
    return xs, ys, ys.to(torch.int64) * width + xs.to(torch.int64)


def render_band_eager(r, opt: RenderOptions, *, frustum, eye, seed=None, y0=0,
                      band_h: Optional[int] = None, sample_offset=0, S: Optional[Dict] = None,
                      closest=None, any_hit=None, closest_bounce=None,
                      compact: bool = False) -> torch.Tensor:
    """The sequential sample loop op by op: ``opt.spp`` samples from
    ``sample_offset`` of ``render_sample_block`` over the lanes of rows
    ``[y0, y0 + band_h)`` (the whole frame by default), summed from zeros in
    sample order; [band_h * W, 3] in the band's blocked lane order
    (``r.finalize`` with the band's height brings it to pixel order).

    The reference of ``r``'s sequential program, and the forward of the loss
    (``render/grad.py``) and of the distributed train step
    (``parallel/mesh.py``), which pass scene tensors ``S`` that carry a
    gradient. ``seed`` (a Python int or a 0-d tensor) defaults to
    ``opt.seed``; ``closest`` / ``any_hit`` / ``closest_bounce`` to the
    renderer's; ``compact`` as ``render_sample_block``'s."""
    W = opt.width
    band_h = band_h or opt.height
    xs, ys, _, _ = r._pixel_order(W, band_h)
    px, py, pix = band_pixels(xs, ys, y0, W)
    common = dict(
        frustum=frustum, eye=eye, width=W, height=opt.height, pixel_x=px, pixel_y=py,
        pixel_idx=pix, seed=int(opt.seed) & 0xFFFFFFFF if seed is None else seed,
        num_bounces=opt.num_bounces, min_bounces_for_rr=opt.min_bounces_for_rr,
        num_emissives=r.num_emissives, scene_diffuse_mat=r.scene_diffuse_mat,
        material_depth=r.material_depth, rr_tile_coherent=opt.rr_tile_coherent,
        closest_bounce=closest_bounce or r.closest_bounce, compact=compact,
    )
    accum = torch.zeros((W * band_h, 3), dtype=torch.float32, device=r.device)
    for s in range(opt.spp):
        accum = accum + render_sample_block(
            r.S if S is None else S, closest or r.closest, any_hit or r.any_hit,
            sample_idx=sample_offset + s, **common,
        )
    return accum


# the fields of the regeneration loop's carry (the JAX carry less its trip
# counter, which the compiled driver keeps beside it)
REGEN_FIELDS = ("ray_o", "ray_d", "throughput", "flags", "alive", "radiance", "s", "b")


def regen_start(
    *, frustum, eye, width, height, pixel_x, pixel_y, pixel_idx, sample_offset, seed,
) -> Dict[str, torch.Tensor]:
    """The regeneration loop's carry before its first trip: every lane alive
    at bounce 0 of sample ``sample_offset`` (a Python int or a 0-d tensor)."""
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    s = torch.zeros(n, dtype=torch.int64, device=dev) + sample_offset
    ray_o, ray_d = _primary(
        seed=seed, frustum=frustum, eye=eye, width=width, height=height,
        pixel_x=pixel_x, pixel_y=pixel_y, pixel_idx=pixel_idx, s=s,
    )
    return {
        "ray_o": ray_o,
        "ray_d": ray_d,
        "throughput": torch.ones((n, 3), dtype=torch.float32, device=dev),
        "flags": torch.zeros(n, dtype=torch.int32, device=dev),
        "alive": torch.ones(n, dtype=torch.bool, device=dev),
        "radiance": torch.zeros((n, 3), dtype=torch.float32, device=dev),
        "s": s,
        "b": torch.zeros(n, dtype=torch.int64, device=dev),  # per-lane bounce
    }


def regen_trip(
    S: Dict,
    closest,
    any_hit,
    carry: Dict[str, torch.Tensor],
    *,
    s_end,
    frustum,
    eye,
    width: int,
    height: int,
    pixel_x,
    pixel_y,
    pixel_idx,
    seed,
    num_bounces: int,
    min_bounces_for_rr: int,
    num_emissives: int,
    scene_diffuse_mat: int,
    material_depth: Optional[int] = None,
    rr_tile_coherent: bool = False,
) -> Dict[str, torch.Tensor]:
    """One trip of the regeneration loop: one bounce of every live lane, and
    a new path at the lane's next sample (below ``s_end``) for each path that
    ended. Returns the new carry.

    On a carry whose lanes are all dead it changes nothing that reaches the
    image or the stop test: ``radiance`` gains exact zeros (never -0.0, as
    it starts from +0.0), and ``alive``, ``s`` and ``b`` (0 once a lane dies)
    keep their values. Only the dead lanes' rays and throughput move.
    """
    n = pixel_idx.shape[0]
    ray_o, ray_d, throughput, flags, alive, radiance, s, b = (carry[k] for k in REGEN_FIELDS)
    maxt = torch.full((n,), V.FLT_MAX, dtype=torch.float32, device=pixel_idx.device)
    rr_key = rng.rr_block_key(pixel_idx, width) if rr_tile_coherent else None
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
    o0, d0 = _primary(  # cheap vector math; where-selected below
        seed=seed, frustum=frustum, eye=eye, width=width, height=height,
        pixel_x=pixel_x, pixel_y=pixel_y, pixel_idx=pixel_idx, s=s,
    )
    regen3 = regen[..., None]
    return {
        "ray_o": torch.where(regen3, o0, out["next_o"]),
        "ray_d": torch.where(regen3, d0, out["next_d"]),
        "throughput": torch.where(regen3, 1.0, out["throughput"]),
        "flags": torch.where(regen, 0, out["flags"]),
        "alive": cont | regen,
        "radiance": radiance,
        "s": s,
        "b": torch.where(cont, b + 1, 0),
    }


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

    The eager loop: ``regen_trip`` until every lane exhausts its sample
    budget, the loop condition read back to the host once per trip (one
    device synchronisation each); b strictly increases to the bounce cap and
    s strictly increases on every regeneration, so trips <= spp *
    num_bounces. ``TorchRenderer`` runs the same trip from a CUDA graph.
    Returns (radiance, trips).
    """
    frame = dict(
        frustum=frustum, eye=eye, width=width, height=height, pixel_x=pixel_x,
        pixel_y=pixel_y, pixel_idx=pixel_idx, seed=seed,
    )
    carry = regen_start(sample_offset=sample_offset, **frame)
    trips = 0
    while bool(carry["alive"].any()):
        carry = regen_trip(
            S, closest, any_hit, carry, s_end=sample_offset + spp, **frame,
            num_bounces=num_bounces, min_bounces_for_rr=min_bounces_for_rr,
            num_emissives=num_emissives, scene_diffuse_mat=scene_diffuse_mat,
            material_depth=material_depth, rr_tile_coherent=rr_tile_coherent,
        )
        trips += 1
    return carry["radiance"], trips


class _Program:
    """The static tensors of one frame shape and the steps of one loop over
    them. The host fills the inputs (seed, camera, sample offset) before a
    launch; the steps read them from device memory."""

    def __init__(self, r: "TorchRenderer", opt: RenderOptions):
        W, H = opt.width, opt.height
        xs, ys, pix, _ = r._pixel_order(W, H)
        dev = r.device
        self.r = r
        self.n = W * H
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.offset = torch.zeros((), dtype=torch.int64, device=dev)
        self.frustum = torch.zeros((4, 3), dtype=torch.float32, device=dev)
        self.eye = torch.zeros(3, dtype=torch.float32, device=dev)
        self.frame = dict(
            frustum=self.frustum, eye=self.eye, width=W, height=H, pixel_x=xs,
            pixel_y=ys, pixel_idx=pix, seed=self.seed,
        )
        self.common = dict(
            self.frame,
            num_bounces=opt.num_bounces,
            min_bounces_for_rr=opt.min_bounces_for_rr,
            num_emissives=r.num_emissives,
            scene_diffuse_mat=r.scene_diffuse_mat,
            material_depth=r.material_depth,
            rr_tile_coherent=opt.rr_tile_coherent,
        )
        self.steps = []

    def step(self, fn) -> Step:
        s = self.r.step(fn)
        self.steps.append(s)
        return s

    def set(self, seed: int, frustum, eye, sample_offset: int) -> None:
        self.seed.fill_(int(seed) & 0xFFFFFFFF)
        self.frustum.copy_(frustum)
        self.eye.copy_(eye)
        self.offset.fill_(int(sample_offset))


class _RegenProgram(_Program):
    """Path regeneration (``regen_start``, ``regen_trip``) over a static
    carry, with a trip counter that counts on the device, and only while a
    lane is alive: trips that run after the last lane died (overshoot)
    leave the counter as they leave ``radiance``, ``alive``, ``s`` and
    ``b``."""

    def __init__(self, r, opt, chunk: int):
        super().__init__(r, opt)
        self.s_end = torch.zeros((), dtype=torch.int64, device=r.device)
        self.carry = regen_start(sample_offset=0, **self.frame)
        self.trips = torch.zeros((), dtype=torch.int64, device=r.device)

        def start():
            for k, v in regen_start(sample_offset=self.offset, **self.frame).items():
                self.carry[k].copy_(v)
            self.trips.zero_()

        def trip():
            live = self.carry["alive"].any()
            new = regen_trip(
                r.S, r.closest, r.any_hit, self.carry, s_end=self.s_end, **self.common
            )
            for k, v in new.items():
                self.carry[k].copy_(v)
            self.trips.add_(live)

        self.start = self.step(start)
        self.trip = self.step(trip)


class _BandProgram(_Program):
    """The sequential sample loop over a row band of ``band_h`` rows, the
    whole frame by default (the JAX package's ``_get_band_fn``, and its frame
    loop): one step is one sample of every lane of the band
    (``render_sample_block``, ``num_bounces`` passes), added to a partial
    summed from zero, and the sample index moved on, on the device. The
    lanes walk the band in its own blocked order; the band's top row
    ``row0`` is a device input like the seed, the camera and the sample
    offset, so one program serves every band of its height."""

    def __init__(self, r, opt, chunk: int, band_h: Optional[int] = None):
        # the lanes of a band_h-row frame; raygen keeps the full frame's height
        super().__init__(r, replace(opt, height=band_h or opt.height))
        self.row0 = torch.zeros((), dtype=torch.int64, device=r.device)
        self.part = torch.zeros((self.n, 3), dtype=torch.float32, device=r.device)
        xs, ys = self.frame["pixel_x"], self.frame["pixel_y"]

        def sample():
            px, py, pix = band_pixels(xs, ys, self.row0, opt.width)
            common = dict(self.common, height=opt.height, pixel_x=px, pixel_y=py, pixel_idx=pix)
            self.part.add_(
                render_sample_block(
                    r.S, r.closest, r.any_hit, sample_idx=self.offset,
                    closest_bounce=r.closest_bounce, compact=r.compact, **common,
                )
            )
            self.offset.add_(1)

        self.sample = self.step(sample)


class _AdaptiveProgram(_Program):
    """One chunk of ``chunk`` samples of adaptive sampling as one step: the
    blocks still drawing samples (``block_active``) trace, the stopped
    blocks' lanes start dead, and the luminance sums and each block's
    confidence interval are formed on the device. ``accum``, ``lsum`` and
    ``l2sum`` are the frame's carry, shared by the programs of every chunk
    size of this frame shape."""

    def __init__(self, r, opt, chunk: int):
        super().__init__(r, opt)
        n, dev = self.n, r.device
        nblocks = -(-n // TILE_LANES)
        pad = nblocks * TILE_LANES - n
        lane_block = torch.clamp(
            torch.arange(n, device=dev) // TILE_LANES, max=nblocks - 1
        )
        # divide by each block's REAL lane count: the zero-padded tail block
        # would otherwise under-read its CI and stop too early
        lanes_per_block = torch.from_numpy(
            np.minimum(TILE_LANES, n - np.arange(nblocks) * TILE_LANES).astype(np.float32)
        ).to(dev)
        self.block_active = torch.zeros(nblocks, dtype=torch.bool, device=dev)
        self.block_spp = torch.zeros(nblocks, dtype=torch.float32, device=dev)
        self.block_ci = torch.zeros(nblocks, dtype=torch.float32, device=dev)
        self.accum, self.lsum, self.l2sum = r._adaptive_carry(opt.width, opt.height)

        def run_chunk():
            act = self.block_active[lane_block]
            for s in range(chunk):
                rad = render_sample_block(
                    r.S, r.closest, r.any_hit, sample_idx=self.offset + s,
                    closest_bounce=r.closest_bounce, active_init=act, compact=r.compact,
                    **self.common,
                )
                lum = V.luminance(rad)
                self.accum.add_(rad)
                self.lsum.add_(lum)
                self.l2sum.add_(lum * lum)
            # per-block convergence stat: 95% CI of the mean per-sample
            # luminance, relative to the mean (the 0.05 floor keeps black
            # and near-black blocks from never converging), averaged over
            # the block's pixels
            ns = torch.clamp(self.block_spp[lane_block], min=1.0)
            mean = self.lsum / ns
            var = torch.clamp(self.l2sum / ns - mean * mean, min=0.0)
            ci = 1.96 * torch.sqrt(var / ns) / (mean + 0.05)
            ci = torch.nn.functional.pad(ci, (0, pad))
            self.block_ci.copy_(ci.reshape(nblocks, TILE_LANES).sum(dim=1) / lanes_per_block)

        self.run_chunk = self.step(run_chunk)


class _BatchProgram(_Program):
    """The sample-batched loop (``batch_samples``): one step renders all
    ``chunk`` samples of a launch as one batch of ``chunk * n`` lanes
    (``render_sample_batch``) into ``part``."""

    def __init__(self, r, opt, chunk: int):
        super().__init__(r, opt)
        self.part = torch.zeros((self.n, 3), dtype=torch.float32, device=r.device)

        def launch():
            self.part.copy_(render_sample_batch(
                r.S, r.closest, r.any_hit, spp=chunk, sample_offset=self.offset,
                closest_bounce=r.closest_bounce, compact=r.compact, **self.common,
            ))

        self.launch = self.step(launch)


_LOOPS = {
    "regen": _RegenProgram, "sequential": _BandProgram, "adaptive": _AdaptiveProgram,
    "batch": _BatchProgram,
}


class TorchRenderer:
    """Single-device renderer over a compiled scene.

    ``device=None`` means the CUDA device and raises when there is none;
    the CPU is used only on request (``device="cpu"``). ``mode`` selects the
    traversal backend (``ops/intersect.py::make_intersectors`` lists the
    modes) and ``tri_test`` the binary kernel's triangle test (``"mt"`` or
    ``"hh"``; ``None`` reads ``POLARIS_TRI_TEST``); ``regen`` switches the
    sample loop to wavefront path regeneration. A mode that peels the
    bounces after the first onto another kernel ('hybrid') cannot
    regenerate, because regeneration mixes bounce depths in one pass: the
    renderer then warns and takes the sequential sample loop.

    Three opt-in modes of the sample loop, each bit-identical to the
    sequential loop, and each turning ``regen`` off silently, as in the JAX
    package: ``compact`` packs the live lanes (and, apart, the shadow rays)
    into the leading lanes before each traversal (``render_sample_block``);
    ``sort_rays`` groups every traversal's rays by direction octant
    (``sorted_pass``); ``batch_samples`` renders the samples of a launch as
    one wide batch of lanes (``render_sample_batch``; frames only, bands and
    adaptive sampling keep the sequential loop). ``compact`` reaches frames,
    bands and adaptive sampling.

    Every frame runs as compiled launches, the counterpart of the JAX
    package's programs: one step of the loop (a regeneration trip, a sample
    of the sequential loop, a chunk of adaptive sampling) is a function of
    static device tensors, called on the CPU and replayed from a CUDA graph
    on a card (``render/graph.py``); the regeneration loop reads its stop
    test once every ``num_bounces`` trips; a chunk's partial is added to a
    device accumulator in blocked lane order, and one finalize restores
    pixel order, tonemaps and quantizes. Graphs are kept per (width, height,
    chunk spp, bounces, RR threshold, tile-coherent RR, loop), and are
    captured by a frame's first launch of that shape. A traversal that
    reads its loop test back to the host ('bvh', 'packet': the intersectors
    carry ``reads_back``) cannot be captured; with it the same steps run
    uncaptured, op by op, on the caller's stream, on a card as on the CPU,
    and every other mode keeps its graphs.

    A captured graph reads the scene tensors ``self.S`` (and the packed
    buffers of the traversal kernels) by address: it stays valid only while
    they keep their storage. Update them in place, or drop the graphs
    (``self._programs.clear()``).

    The eager loop functions (``render_sample_block``, ``render_block_regen``,
    ``render_blocked_eager``) stay the reference the graphs are held against.
    """

    # samples per launch of the sample loop: bounds the work queued between
    # two accumulator updates, and is the unit progressive accumulation
    # advances by
    spp_per_launch = 8

    def __init__(
        self, scene, device=None, mode: str = "auto", compact: bool = False,
        sort_rays: bool = False, batch_samples: bool = False, regen: bool = False,
        tri_test: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.scene = as_scene_data(scene)
        self.compact = compact
        self.sort_rays = sort_rays
        self.batch_samples = batch_samples
        self.regen = regen and not (compact or sort_rays or batch_samples)
        self.S = upload_scene(self.scene, self.device)
        self.closest, self.any_hit = make_intersectors(self.S, mode, tri_test)
        # a traversal that reads back to the host cannot be captured: its
        # steps run uncaptured, op by op, on a card too
        self.reads_back = getattr(self.closest, "reads_back", False)
        self.closest_bounce = getattr(self.closest, "closest_bounce", None)
        if self.regen and self.closest_bounce is not None:
            _log.warning(
                "regen is unsupported with the hybrid traversal's peeled "
                "bounce kernel; using the sequential sample loop"
            )
            self.regen = False
        if sort_rays:
            self.closest = sorted_pass(self.closest, any_hit=False)
            self.any_hit = sorted_pass(self.any_hit, any_hit=True)
            if self.closest_bounce is not None:
                self.closest_bounce = sorted_pass(self.closest_bounce, any_hit=False)
        self.num_emissives = int(self.scene.emis_area.shape[0])
        self.scene_diffuse_mat = int(self.scene.scene_diffuse_mat)
        self.material_depth = material_tree_depth(
            self.scene.mat_type, self.scene.mat_left, self.scene.mat_right
        )
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self._programs: Dict = {}
        self._order_cache: Dict = {}
        self._carry_cache: Dict = {}
        self.last_render_ms = 0.0
        self.last_device = str(self.device)  # the progressive viewer's block rows name it
        # the last frame's loop: trips that had a live lane (the eager
        # loop's count), trips run (overshoot included: one closest-hit
        # launch each) and the loop's own reads of a device value by the
        # host (a traversal that reads back, 'bvh' or 'packet', reads more
        # inside every call; those are not counted)
        self.last_trips = 0
        self.last_trips_run = 0
        self.last_host_syncs = 0

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

    def _adaptive_carry(self, W: int, H: int):
        """The adaptive loop's device carry for a frame shape: accumulator,
        luminance sum and sum of squares, in blocked lane order."""
        if (W, H) not in self._carry_cache:
            n, f32 = W * H, dict(dtype=torch.float32, device=self.device)
            self._carry_cache[W, H] = (
                torch.zeros((n, 3), **f32), torch.zeros(n, **f32), torch.zeros(n, **f32)
            )
        return self._carry_cache[W, H]

    def program(self, key, make):
        """The program kept under ``key``, made by ``make()`` on its first
        use: the static tensors and steps of one shape of a loop (a frame's,
        the loss step's, the denoiser's guide pass or filter). Each has a
        ``steps`` list."""
        if key not in self._programs:
            self._programs[key] = make()
        return self._programs[key]

    def step(self, fn) -> Step:
        """A ``Step`` of ``fn`` on this renderer's capture stream and graph
        pool; uncaptured when the traversal reads back to the host."""
        return Step(fn, self.device, self._stream, self._pool, capture=not self.reads_back)

    def _program(self, opt: RenderOptions, chunk: int, loop: str, band_h: int = 0) -> _Program:
        """``loop``'s program for frames of ``opt``'s shape, ``chunk``
        samples a launch; ``band_h``: the rows of the sequential loop's band,
        the whole frame when 0."""
        key = (opt.width, opt.height, chunk, opt.num_bounces, opt.min_bounces_for_rr,
               opt.rr_tile_coherent, loop, band_h or opt.height)
        band = (band_h,) if band_h else ()
        return self.program(key, lambda: _LOOPS[loop](self, opt, chunk, *band))

    @property
    def capture_seconds(self) -> float:
        """Seconds spent capturing this renderer's graphs (outside replays)."""
        return sum(s.capture_seconds for p in self._programs.values() for s in p.steps)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _camera_tensors(self, opt: RenderOptions, camera: Optional[Camera]):
        cam = camera or Camera.from_scene(self.scene, opt.width, opt.height)
        frustum = torch.from_numpy(np.asarray(cam.frustum, np.float32)).to(self.device)
        eye = torch.from_numpy(np.asarray(cam.position, np.float32)).to(self.device)
        return frustum, eye

    def _block_partial(self, opt: RenderOptions, frustum, eye, sample_offset: int,
                       band=None):
        """Sum of ``opt.spp`` samples' radiance in BLOCKED lane order, summed
        from zero, through the regeneration loop, the sequential sample
        loop or, with ``batch_samples`` and more than one sample, one batch
        of lanes; ``band`` = ``(y0, band_h)``: those rows' lanes, through the
        sequential loop whichever loop this renderer runs. Returns a static
        buffer of the loop's program: the next launch of that shape
        overwrites it."""
        if self.regen and band is None:
            prog = self._program(opt, opt.spp, "regen")
            prog.set(opt.seed, frustum, eye, sample_offset)
            prog.s_end.fill_(int(sample_offset) + opt.spp)
            prog.start()
            # a path ends within num_bounces trips, so the stop test is read
            # once every num_bounces trips: at most num_bounces - 1 trips
            # run after the last lane died
            k = opt.num_bounces
            while True:
                for _ in range(k):
                    prog.trip()
                self.last_trips_run += k
                self.last_host_syncs += 1
                if not bool(prog.carry["alive"].any()):
                    break
            self._trips.add_(prog.trips)
            return prog.carry["radiance"]
        if self.batch_samples and band is None and opt.spp > 1:
            prog = self._program(opt, opt.spp, "batch")
            prog.set(opt.seed, frustum, eye, sample_offset)
            prog.launch()
            # one pass a bounce over the launch's samples together
            self.last_trips += opt.num_bounces
            self.last_trips_run += opt.num_bounces
            return prog.part
        y0, band_h = band or (0, 0)
        prog = self._program(opt, opt.spp, "sequential", band_h)
        prog.set(opt.seed, frustum, eye, sample_offset)
        prog.row0.fill_(y0)
        prog.part.zero_()
        for _ in range(opt.spp):
            prog.sample()
        self.last_trips += opt.spp * opt.num_bounces
        self.last_trips_run += opt.spp * opt.num_bounces
        return prog.part

    def _render_blocked(self, opt: RenderOptions, frustum, eye, sample_offset: int,
                        chunked: bool, band=None):
        """One frame's accumulator in blocked lane order, or a band's
        (``band`` = ``(y0, band_h)``, ``_block_partial``): ``opt.spp``
        samples from ``sample_offset`` as one partial, or, when ``chunked``
        and ``opt.spp > spp_per_launch``, in ``spp_per_launch`` chunks whose
        partials are added to a device accumulator — (chunk0)+(chunk1)+...,
        the association of the JAX package's chunk carry."""
        self._trips = torch.zeros((), dtype=torch.int64, device=self.device)
        self.last_trips = self.last_trips_run = self.last_host_syncs = 0
        if not chunked or opt.spp <= self.spp_per_launch:
            return self._block_partial(opt, frustum, eye, sample_offset, band)
        rows = band[1] if band else opt.height
        accum = torch.zeros((opt.width * rows, 3), dtype=torch.float32, device=self.device)
        done = 0
        while done < opt.spp:
            chunk = min(self.spp_per_launch, opt.spp - done)
            accum.add_(self._block_partial(
                replace(opt, spp=chunk), frustum, eye, sample_offset + done, band
            ))
            done += chunk
        return accum

    def _end_frame(self):
        """Read the regeneration loop's trip count, once a frame (the
        sequential loop's is known on the host)."""
        if self.regen:
            self.last_trips = int(self._trips)
            self.last_host_syncs += 1

    def finalize(self, accum, opt: RenderOptions, emit: str = "f32"):
        """Close a frame: restore pixel order from blocked lane order (one
        gather) and, for ``emit="u8"``, tonemap with the weight 1/spp times
        the exposure (one float32 product) and quantize. Returns a new
        [H, W, 3] tensor on the device."""
        inv = self._pixel_order(opt.width, opt.height)[3]
        a = (torch.index_select(accum, 0, inv) if inv is not None else accum.clone())
        a = a.reshape(opt.height, opt.width, 3)
        if emit == "f32":
            return a
        return self.tonemap_u8(a, 1.0 / opt.spp, opt.exposure)

    @staticmethod
    def tonemap_u8(accum, sample_weight, exposure) -> torch.Tensor:
        """``accum`` [H, W, 3] tonemapped with the weight ``sample_weight``
        times ``exposure`` (one float32 product, as the JAX package's
        ``tonemap_u8`` multiplies its two float32 scalars) and quantized to
        uint8 (truncated), on its device."""
        scale = float(np.float32(sample_weight) * np.float32(exposure))
        img = tonemap_reinhard(accum, scale, 1.0)
        return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)

    # ----- public API -----

    @torch.no_grad()
    def render_accum_offset(
        self,
        opt: RenderOptions,
        camera: Optional[Camera] = None,
        sample_offset: int = 0,
    ) -> torch.Tensor:
        """Render opt.spp samples starting at an absolute sample index, as one
        partial (progressive accumulation); returns the f32 accumulator
        [H, W, 3] on the renderer's device."""
        with Timer() as t:
            out = self.finalize(
                self._render_blocked(opt, *self._camera_tensors(opt, camera), sample_offset, False),
                opt,
            )
            self._end_frame()
        self.last_render_ms = t.ms
        return out

    @torch.no_grad()
    def render_accum(
        self, opt: RenderOptions, camera: Optional[Camera] = None
    ) -> torch.Tensor:
        """Render opt.spp samples from sample 0, in chunks of
        ``spp_per_launch`` when there are more; returns the f32 accumulator
        [H, W, 3] on the renderer's device."""
        with Timer() as t:
            out = self.finalize(
                self._render_blocked(opt, *self._camera_tensors(opt, camera), 0, True), opt
            )
            self._end_frame()
        self.last_render_ms = t.ms
        return out

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
            accum = self._render_blocked(opt, *self._camera_tensors(opt, camera), 0, True)
            img = self.finalize(accum, opt, "u8")
            out = img.cpu().numpy()
            self._end_frame()
        self.last_render_ms = t.ms
        return out

    # ----- row bands: the work unit of the worker pool and the mesh -----

    @torch.no_grad()
    def render_band_accum(
        self,
        opt: RenderOptions,
        y0: int,
        band_h: int,
        camera: Optional[Camera] = None,
        sample_offset: int = 0,
    ) -> torch.Tensor:
        """Render rows ``[y0, y0 + band_h)`` of the frame, the work unit a
        ``BlockRequest`` describes (``render/scheduler.py``): ``opt.spp``
        samples from ``sample_offset`` through the sequential sample loop, in
        chunks of ``spp_per_launch`` added to a device accumulator as
        ``render_accum`` adds them, so the band equals those rows of a
        ``render_accum`` frame of the sequential loop (``regen=False``) bit
        for bit, whichever loop this renderer runs. Returns [band_h, W, 3] f32 on the
        renderer's device; ``last_render_ms`` runs until the band's work on
        the current stream is done."""
        with Timer() as t:
            out = self._render_band(opt, y0, band_h, *self._camera_tensors(opt, camera),
                                    sample_offset)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        self.last_render_ms = t.ms
        return out

    def _render_band(self, opt: RenderOptions, y0: int, band_h: int, frustum, eye,
                     sample_offset: int) -> torch.Tensor:
        """``render_band_accum``'s work, queued on the current stream: the
        device work is not waited for."""
        if not (0 <= y0 and band_h > 0 and y0 + band_h <= opt.height):
            raise ValueError(f"rows [{y0}, {y0 + band_h}) are not inside a frame of {opt.height}")
        accum = self._render_blocked(opt, frustum, eye, sample_offset, True, (y0, band_h))
        return self.finalize(accum, replace(opt, height=band_h))

    # ----- adaptive per-block sampling -----
    #
    # Whole 32x32 screen blocks stop drawing samples once their per-pixel
    # variance says they converged; a stopped block's lanes start dead, and
    # the traversal kernels write inactive rays without tracing them. The
    # RNG's absolute sample indices make the result reproducible: a block
    # that stopped at n samples holds exactly the accumulator a fixed
    # n-sample render (one partial) would produce.

    @torch.no_grad()
    def render_adaptive(
        self,
        opt: RenderOptions,
        camera: Optional[Camera] = None,
        *,
        tol: float = 0.02,
        chunk: int = 0,
        min_spp: int = 0,
    ):
        """Variance-driven adaptive render on the sequential sample loop.
        ``opt.spp`` is the per-pixel budget CAP; blocks stop early once
        converged (95% CI of mean luminance below ``tol`` relative), checked
        from ``min_spp`` samples on (default: two chunks). Returns
        ``(accum [H,W,3] f32, spp_map [H,W] int32)``, tensors on the
        renderer's device — divide per pixel to get the image."""
        W, H = opt.width, opt.height
        n = W * H
        nblocks = -(-n // TILE_LANES)
        chunk = chunk or min(self.spp_per_launch, opt.spp)
        min_spp = min_spp or min(2 * chunk, opt.spp)
        frustum, eye = self._camera_tensors(opt, camera)
        accum, lsum, l2sum = self._adaptive_carry(W, H)
        block_active = np.ones(nblocks, bool)
        block_spp = np.zeros(nblocks, np.int32)
        done = 0
        self.last_trips_run = self.last_host_syncs = 0
        with Timer() as t:
            accum.zero_()
            lsum.zero_()
            l2sum.zero_()
            while done < opt.spp and block_active.any():
                k = min(chunk, opt.spp - done)  # never exceed the budget cap
                prog = self._program(opt, k, "adaptive")
                block_spp_new = block_spp + np.where(block_active, k, 0)
                prog.set(opt.seed, frustum, eye, done)
                prog.block_active.copy_(torch.from_numpy(block_active))
                prog.block_spp.copy_(torch.from_numpy(block_spp_new.astype(np.float32)))
                prog.run_chunk()
                block_ci = prog.block_ci.cpu().numpy()  # the one host read a chunk
                self.last_host_syncs += 1
                self.last_trips_run += k * opt.num_bounces
                block_spp = block_spp_new
                done += k
                if done >= min_spp:
                    # >= keeps tol=0 a true "never converge" mode: a
                    # zero-variance block (ci exactly 0) must not stop
                    block_active &= block_ci >= tol
            out = self.finalize(accum, opt)
            self._sync()
        self.last_render_ms = t.ms
        self.last_trips = self.last_trips_run
        self.last_spp_blocks = block_spp
        lane_block = np.minimum(np.arange(n, dtype=np.int64) // TILE_LANES, nblocks - 1)
        h_inv = blocked_pixel_order(W, H)[3]
        spp_map = block_spp[lane_block][h_inv].reshape(H, W).astype(np.int32)
        return out, torch.from_numpy(spp_map).to(self.device)

    @torch.no_grad()
    def render_adaptive_u8(self, opt: RenderOptions, camera: Optional[Camera] = None, **kw):
        """``render_adaptive``, each pixel weighted by 1/its sample count,
        tonemapped and rounded to u8 (``+0.5``) on the device; returns
        ``(image [H,W,3] uint8, spp_map [H,W] int32)`` as numpy arrays."""
        accum, spp_map = self.render_adaptive(opt, camera, **kw)
        weight = 1.0 / spp_map[..., None].to(torch.float32)
        img = tonemap_reinhard(accum, weight, opt.exposure)
        u8 = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        return u8.cpu().numpy(), spp_map.cpu().numpy()


@torch.no_grad()
def render_blocked_eager(r: TorchRenderer, opt: RenderOptions, camera: Optional[Camera] = None,
                         *, closest=None, any_hit=None):
    """``r``'s ``render_accum`` / ``render_u8`` frame through the eager loop
    functions, every op launched on its own and the regeneration loop's stop
    test read every trip: the same samples, chunks and additions as ``r``'s
    compiled driver. The reference that driver is held against, bit for
    bit, and the eager baseline of its time. ``closest`` / ``any_hit``
    replace the renderer's traversal (its plain version, say). Returns
    (accumulator in blocked lane order, trips); ``r.finalize`` closes it."""
    frustum, eye = r._camera_tensors(opt, camera)
    common = dict(frustum=frustum, eye=eye, closest=closest, any_hit=any_hit)

    def partial(offset: int, spp: int):
        if r.regen:
            xs, ys, pix, _ = r._pixel_order(opt.width, opt.height)
            return render_block_regen(
                r.S, closest or r.closest, any_hit or r.any_hit, frustum=frustum, eye=eye,
                width=opt.width, height=opt.height, pixel_x=xs, pixel_y=ys, pixel_idx=pix,
                sample_offset=offset, spp=spp, seed=int(opt.seed),
                num_bounces=opt.num_bounces, min_bounces_for_rr=opt.min_bounces_for_rr,
                num_emissives=r.num_emissives, scene_diffuse_mat=r.scene_diffuse_mat,
                material_depth=r.material_depth, rr_tile_coherent=opt.rr_tile_coherent,
            )
        if r.batch_samples and spp > 1:
            xs, ys, pix, _ = r._pixel_order(opt.width, opt.height)
            part = render_sample_batch(
                r.S, closest or r.closest, any_hit or r.any_hit, pixel_x=xs, pixel_y=ys,
                pixel_idx=pix, spp=spp, sample_offset=offset, frustum=frustum, eye=eye,
                width=opt.width, height=opt.height, seed=int(opt.seed) & 0xFFFFFFFF,
                num_bounces=opt.num_bounces, min_bounces_for_rr=opt.min_bounces_for_rr,
                num_emissives=r.num_emissives, scene_diffuse_mat=r.scene_diffuse_mat,
                material_depth=r.material_depth, rr_tile_coherent=opt.rr_tile_coherent,
                closest_bounce=r.closest_bounce, compact=r.compact,
            )
            return part, opt.num_bounces
        part = render_band_eager(r, replace(opt, spp=spp), sample_offset=offset,
                                 compact=r.compact, **common)
        return part, spp * opt.num_bounces

    if opt.spp <= r.spp_per_launch:
        return partial(0, opt.spp)
    accum = torch.zeros((opt.width * opt.height, 3), dtype=torch.float32, device=r.device)
    trips = done = 0
    while done < opt.spp:
        chunk = min(r.spp_per_launch, opt.spp - done)
        part, t = partial(done, chunk)
        accum = accum + part
        trips += t
        done += chunk
    return accum, trips
