"""Debug output renders (≙ the reference's 6 debug kernels + 8 DebugFlags).

Counterpart of the JAX package's ``render/debug.py``. The reference dumps
diagnostic PNGs per debug flag (``tracer/opencl/pipeline.go:20-30,116-200``;
kernels in ``CL/kernels/debug.cl:16-156``): primary intersection depth,
normals, emissive-sample occlusion masks, path throughput, per-bounce
accumulator.

Each channel is one pass over the primary rays of sample 0, in pixel order,
run op by op: the renderer's closest hit (K1 on a card), the port's
``shade`` for the first bounce where a channel needs it, and its any hit
for the NEE shadow rays of ``emissive_vis``.
"""

from __future__ import annotations

import torch

from ..asset.camera import Camera
from ..ops import rng
from ..ops import vec as V
from .options import RenderOptions
from .raygen import gen_rays
from .shade import shade

DEBUG_CHANNELS = (
    "depth",
    "normals",
    "uv",
    "hitmask",
    "instance",
    "emissive_vis",
    "throughput",
    "accumulator",
)


def _interpolate(rows, w, u, v, k: int):
    """Barycentric mix of the three ``k``-wide vertex attributes of ``rows``."""
    return (w[..., None] * rows[..., 0:k] + u[..., None] * rows[..., k:2 * k]
            + v[..., None] * rows[..., 2 * k:3 * k])


@torch.no_grad()
def render_debug(renderer, opt: RenderOptions, channel: str, camera=None, *,
                 closest=None, any_hit=None) -> torch.Tensor:
    """Render one debug channel to a [H, W, 3] float image in [0, 1], a
    tensor on the renderer's device. ``closest`` / ``any_hit`` replace the
    renderer's traversal (its plain version, say); the ``accumulator``
    channel then renders through the eager loops (``render_blocked_eager``),
    as a plain traversal cannot be captured into a graph, and otherwise
    through the renderer's graphs."""
    if channel not in DEBUG_CHANNELS:
        raise ValueError(f"unknown debug channel {channel!r}")
    r = renderer
    cam = camera or Camera.from_scene(r.scene, opt.width, opt.height)
    if channel == "accumulator":
        # raw radiance accumulator normalized by sample count
        # (≙ debugAccumulator, debug.cl:143-156)
        if closest is None and any_hit is None:
            acc = r.render_accum(opt, camera=cam)
        else:
            from .integrator import render_blocked_eager

            acc = r.finalize(
                render_blocked_eager(r, opt, cam, closest=closest, any_hit=any_hit)[0], opt
            )
        return torch.clamp(acc / max(opt.spp, 1), 0.0, 1.0)
    closest, any_hit = closest or r.closest, any_hit or r.any_hit
    S = r.S
    W, H = opt.width, opt.height
    n = W * H
    dev = r.device
    frustum, eye = r._camera_tensors(opt, cam)
    pixel_idx = torch.arange(n, dtype=torch.int64, device=dev)
    xs = (pixel_idx % W).to(torch.int32)
    ys = (pixel_idx // W).to(torch.int32)
    U = rng.make_uniform(int(opt.seed) & 0xFFFFFFFF, pixel_idx, 0, 0)
    o, d = gen_rays(frustum, eye, W, H, xs, ys, U)
    maxt = torch.full((n,), V.FLT_MAX, dtype=torch.float32, device=dev)
    hit = closest(S, o, d, maxt, torch.ones(n, dtype=torch.bool, device=dev))
    mask3 = hit.mask[..., None]
    if channel == "depth":
        # normalized inverse depth (debugRayIntersectionDepth computes a
        # host-side max reduction, resources.go:378-419; here on the device)
        t = torch.where(hit.mask, hit.t, 0.0)
        tmax = torch.clamp(torch.max(t), min=1e-6)
        v = (t / tmax)[..., None].expand(n, 3)
    elif channel == "normals":
        w = 1.0 - hit.u - hit.v
        n_obj = _interpolate(S["tri_normals"][hit.tri.long()], w, hit.u, hit.v, 3)
        w2o = V.take_small(S["inst_w2o"], hit.inst)
        nw = V.normalize3(V.transform_normal(w2o, n_obj))
        v = torch.where(mask3, nw * 0.5 + 0.5, 0.0)
    elif channel == "uv":
        w = 1.0 - hit.u - hit.v
        uv = _interpolate(S["tri_uvs"][hit.tri.long()], w, hit.u, hit.v, 2)
        v = torch.cat([torch.remainder(uv, 1.0), torch.zeros_like(uv[..., :1])], dim=-1)
        v = torch.where(mask3, v, 0.0)
    elif channel == "hitmask":
        v = mask3.to(torch.float32).expand(n, 3)
    elif channel == "instance":
        # (inst + 1) * 2654435761 in uint32 arithmetic, its three low bytes;
        # XLA divides by the constant 255 as a product with its reciprocal
        k = ((hit.inst.to(torch.int64) + 1) * 2654435761) & 0xFFFFFFFF
        v = torch.stack(
            [((k >> s) & 0xFF).to(torch.float32) * (1.0 / 255.0) for s in (16, 8, 0)], dim=-1
        )
        v = torch.where(mask3, v, 0.0)
    else:
        out = shade(
            S, U,
            bounce=0,
            min_bounces_for_rr=99,
            num_emissives=r.num_emissives,
            material_depth=r.material_depth,
            ray_o=o, ray_d=d, t=torch.where(hit.mask, hit.t, 0.0),
            inst=hit.inst, tri=hit.tri, bary_u=hit.u, bary_v=hit.v,
            hit_mask=hit.mask,
            throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
            flags=torch.zeros(n, dtype=torch.int32, device=dev),
        )
        if channel == "throughput":
            # path throughput after the first bounce's BxDF sample
            # (≙ debugThroughput, debug.cl:122-140)
            v = torch.where(out["next_mask"][..., None], out["throughput"], 0.0)
        else:  # emissive_vis
            # visibility of the NEE occlusion rays from the first bounce
            # (≙ debugEmissiveSamples occluded/visible masks)
            om = out["occl_mask"]
            occluded = any_hit(
                S, out["occl_o"].contiguous(), out["occl_d"].contiguous(),
                out["occl_maxt"].contiguous(), om,
            )
            v = torch.stack(
                [(om & ~occluded).to(torch.float32), (om & occluded).to(torch.float32),
                 torch.zeros(n, dtype=torch.float32, device=dev)],
                dim=-1,
            )
    return torch.clamp(v.reshape(H, W, 3), 0.0, 1.0)
