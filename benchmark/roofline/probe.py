"""The traversal roofline of a frame cell: the least time the card could
take for the closest-hit queries of two probe sets, over the time the
renderer's own closest-hit intersector takes for them.

Probe rays, made by the benchmark from the seed: the frame's primary rays
(sample 0 of every pixel), and one cosine-weighted ray from each of as many
points sampled on the scene's surfaces (triangles picked by area, the
normal turned toward the camera), the rays a bounce traces. The bound
counts the work of the benchmark's own walk of its own BVH (`bound.py`);
the time is the renderer's closest-hit intersector for the cell's mode (the
metric's reader hands it over), on the same rays, timed with CUDA events
over repeated launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .bound import closest_bound_s
from .bvh import build
from .traverse import FLT_MAX, Traverser

REPEATS = 10


def probe_rays(rs, width: int, height: int, seed: int, device):
    """[(origin, direction)] of the two probe sets, float32 on ``device``."""
    from harness import seeds
    from reference.pathtracer import primary_rays

    n = width * height
    pix = torch.arange(n, device=device)
    frustum = torch.from_numpy(rs.frustum(width, height)).to(device)
    eye = torch.from_numpy(rs.eye).to(device)
    prim = primary_rays(seeds.derive(seed, seeds.PROBE), pix, pix % width, pix // width,
                        torch.zeros_like(pix), width, height, frustum, eye, torch.float32)

    g = seeds.generator(seed, seeds.PROBE)
    area = 0.5 * np.linalg.norm(np.cross(rs.e1.astype(np.float64), rs.e2), axis=1)
    tri = g.choice(rs.num_tris, size=n, p=area / area.sum())
    u1, u2, u3, u4 = (g.random(n, dtype=np.float32) for _ in range(4))
    r1 = np.sqrt(u1)
    ru, rv = (1 - u2) * r1, u2 * r1
    p = (rs.v0[tri] + ru[:, None] * rs.e1[tri] + rv[:, None] * rs.e2[tri]).astype(np.float64)
    fn = np.cross(rs.e1[tri].astype(np.float64), rs.e2[tri])
    fn /= np.linalg.norm(fn, axis=1, keepdims=True)
    fn *= np.where(np.einsum("ij,ij->i", fn, rs.eye[None, :] - p) < 0, -1.0, 1.0)[:, None]
    # cosine-weighted about the normal
    a = np.where(np.abs(fn[:, 2:3]) < 0.999, np.array([[0, 0, 1.0]]), np.array([[1.0, 0, 0]]))
    tu = np.cross(a, fn)
    tu /= np.linalg.norm(tu, axis=1, keepdims=True)
    tv = np.cross(fn, tu)
    rd, phi = np.sqrt(u3), 2 * np.pi * u4
    d = tu * (rd * np.cos(phi))[:, None] + tv * (rd * np.sin(phi))[:, None] + fn * np.sqrt(1 - u3)[:, None]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if not np.isfinite(d).all():
        raise ValueError("a probe ray without a direction")
    o = p + 1e-5 * fn
    bounce = tuple(torch.from_numpy(x.astype(np.float32)).to(device) for x in (o, d))
    return [("primary", prim), ("bounce", bounce)]


def _time_s(fn, repeats: int = REPEATS) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3 / repeats


def traversal_roofline(rs, closest, S, width: int, height: int, seed: int, device) -> dict:
    """Share (%) of the bound in the time of ``closest(S, o, d, maxt,
    active)`` on the probe rays, with its parts."""
    walk = Traverser(build(rs.v0, rs.e1, rs.e2), rs.v0, rs.e1, rs.e2, device)
    total_bound = total_time = 0.0
    parts = {}
    for name, (o, d) in probe_rays(rs, width, height, seed, device):
        n = o.shape[0]
        maxt = torch.full((n,), FLT_MAX, dtype=torch.float32, device=device)
        active = torch.ones(n, dtype=torch.bool, device=device)
        stats: dict = {}
        walk.closest(o, d, maxt, active, stats)
        b = closest_bound_s(n, n, stats)
        t = _time_s(lambda: closest(S, o, d, maxt, active))
        parts[name] = {"bound_s": b["bound_s"], "by": b["by"], "kernel_s": t}
        total_bound += b["bound_s"]
        total_time += t
    return {"pct": 100.0 * total_bound / total_time, "parts": parts}
