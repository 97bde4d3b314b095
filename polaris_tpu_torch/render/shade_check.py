"""What a comparison of the shading kernel (``ops/shade_cuda.py``) with its
plain version (``render/shade.py``) runs on: a scene that reaches every
material operator, BxDF, light kind and texture storage, the inputs of a
frame's first bounces, and the results a later stage reads only under a
mask. The CPU tests (``tests/test_torch_shade_kernel.py``, the kernel's
device code built for the host) and the card's check (``chip_smoke.py``'s
``shade`` phase) both take them from here.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from ..ops import rng
from ..ops import vec as V
from .options import RenderOptions
from .raygen import gen_rays
from .shade import nee_add_plain, shade_bounce_plain

# what a later stage reads of a result that carries a mask: only its lanes
MASKED_BY = {"next_o": "next_mask", "next_d": "next_mask", "occl_o": "occl_mask",
             "occl_d": "occl_mask", "occl_maxt": "occl_mask", "occl_value": "occl_mask"}

# mitsuba's geometry under materials that reach what the five scenes of
# ``scenes/`` leave out: every material operator (mix, mixMap, bumpMap,
# normalMap, disperse), the conductor with and without an IOR, a texture on
# each texturable field, all three storage kinds at once (Rgba8, Luminance8,
# float32), an area light beside the environment light, a textured
# background
COVERAGE_MTL = """newmtl floor
mat_expr mixMap(bumpMap(diffuse(reflectance: "checker.png"), "gray.png"), conductor(specularity: {0.9, 0.9, 0.9}, intIOR: 1.5), "gray.png")

newmtl rough_gold
mat_expr normalMap(roughConductor(specularity: "checker.png", roughness: "gray.png"), "checker.png")

newmtl rough_glass
mat_expr mix(disperse(roughDielectric(transmittance: "checker.png", roughness: 0.15), intIOR: {1.5, 1.52, 1.54}, extIOR: {0, 0, 0}), mix(dielectric(transmittance: {0.95, 0.95, 0.95}, intIOR: 1.5), conductor(specularity: "gray.png"), 0.3), 0.5)

newmtl lamp
mat_expr emissive(radiance: "checker.png", scale: 14)

newmtl scene_diffuse_material
mat_expr diffuse(reflectance: "env.hdr")

newmtl scene_emissive_material
mat_expr emissive(radiance: "env.hdr", scale: 1)
"""


def coverage_scene(scenes_dir: str):
    """``COVERAGE_MTL`` on mitsuba's geometry, compiled from a temporary
    directory (with ``scenes_dir``'s checker and environment, and a 16x16
    grey ramp)."""
    from PIL import Image

    from ..asset.compiler.compiler import compile_scene
    from ..asset.wavefront import read_scene

    with tempfile.TemporaryDirectory() as d:
        for f in ("mitsuba.obj", "checker.png", "env.hdr"):
            shutil.copy(os.path.join(scenes_dir, f), os.path.join(d, f))
        ramp = (np.add.outer(np.arange(16), np.arange(16)) * 8).astype(np.uint8)
        Image.fromarray(ramp, "L").save(os.path.join(d, "gray.png"))
        with open(os.path.join(d, "mitsuba.mtl"), "w") as f:
            f.write(COVERAGE_MTL)
        return compile_scene(read_scene(os.path.join(d, "mitsuba.obj")))


def shade_bounces(r, width: int, seed: int, per_lane: bool, bounces: int = 3):
    """The arguments of the first ``bounces`` bounces of sample 0 of a
    ``width``^2 frame of renderer ``r`` (RR from bounce 1, so that roulette
    runs), each bounce's inputs made by the plain version from the last:
    yields (bounce, closest hits, arguments). ``per_lane``: the bounce and
    sample as one value a lane and tile-coherent RR, as path regeneration
    and ``batch_samples`` pass them."""
    opt = RenderOptions(width=width, height=width, spp=1)
    xs, ys, pix, _ = r._pixel_order(width, width)
    frustum, eye = r._camera_tensors(opt, None)
    n, dev = pix.shape[0], pix.device
    lane = dict(dtype=torch.int64, device=dev)
    sample = torch.zeros(n, **lane) if per_lane else 0
    seed_t = torch.tensor(seed, **lane)  # a captured graph's seed: a 0-d tensor
    ray_o, ray_d = gen_rays(frustum, eye, width, width, xs, ys,
                            rng.make_uniform(seed_t, pix, sample, 0))
    tp = torch.ones((n, 3), dtype=torch.float32, device=dev)
    flags = torch.zeros(n, dtype=torch.int32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    maxt = torch.full((n,), V.FLT_MAX, dtype=torch.float32, device=dev)
    rr_key = rng.rr_block_key(pix, width) if per_lane else None
    for b in range(bounces):
        bounce = torch.full((n,), b, **lane) if per_lane else b
        U = rng.make_uniform(seed_t, pix, sample, bounce, rr_key=rr_key)
        hit = r.closest(r.S, ray_o, ray_d, maxt, alive)
        kw = dict(
            ray_o=ray_o, ray_d=ray_d, alive=alive, throughput=tp, flags=flags, radiance=rad,
            U=U, bounce=bounce, is_primary=(bounce == 0)[..., None] if per_lane else b == 0,
            min_bounces_for_rr=1, num_emissives=r.num_emissives,
            scene_diffuse_mat=r.scene_diffuse_mat, material_depth=r.material_depth,
        )
        yield b, hit, kw
        rad, out = shade_bounce_plain(r.S, hit, **kw)
        if r.num_emissives > 0:
            occluded = r.any_hit(r.S, out["occl_o"], out["occl_d"], out["occl_maxt"],
                                 out["occl_mask"])
            rad = nee_add_plain(rad, out["occl_mask"], occluded, out["occl_value"])
        ray_o, ray_d, tp, flags, alive = (
            out[k] for k in ("next_o", "next_d", "throughput", "flags", "next_mask")
        )
