"""The port against the benchmark's plain microfacet reference
(``benchmark/reference/microfacet.py``), and the lane census of the
shading step (``utils/profiling.py::shade_census``), on the CPU.

  * mitsuba's geometry under materials drawn from a seed (roughness in
    [0.1, 1], specularity, transmittance, a numeric intIOR, a random byte
    texture on the floor): the port's summed radiance per pixel against the
    reference's, at 24x24, 4 samples
  * the comparison is tight enough that the reference in bfloat16, or with
    its roughness 1% off, fails it
  * the census adds up, equals counts taken by hand from the plain path's
    inputs and results, is the same for the sequential loop and path
    regeneration, and records nothing while it is off
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from polaris_tpu_torch.asset.compiler.compiler import compile_scene  # noqa: E402
from polaris_tpu_torch.asset.wavefront import read_scene  # noqa: E402
from polaris_tpu_torch.ops import bxdf as B  # noqa: E402
from polaris_tpu_torch.ops import vec as V  # noqa: E402
from polaris_tpu_torch.ops.rng import STREAM_BXDF_U, STREAM_RR  # noqa: E402
from polaris_tpu_torch.render.integrator import TorchRenderer  # noqa: E402
from polaris_tpu_torch.render.options import RenderOptions  # noqa: E402
from polaris_tpu_torch.render.shade import shade_bounce_plain  # noqa: E402
from polaris_tpu_torch.render.shade_check import coverage_scene, shade_bounces  # noqa: E402
from polaris_tpu_torch.utils import profiling  # noqa: E402
from reference import microfacet as M  # noqa: E402
from roofline.bvh import build  # noqa: E402

SIZE, SPP = 24, 4

# Where a pixel's paths take the same branches on both sides, its summed
# radiance differs only by rounding: the port's K1 det^2 triangle test and
# the reference's quotient test give hits an ulp or two apart, and every
# later operation carries that on (seen: at most 5.3e-4 absolute over
# sums up to ~60). So a pixel agrees within 1e-3 of the two sums' size,
# plus 1e-4 for sums near 0.
REL, ABS = 1e-3, 1e-4
# A path whose choice (Russian roulette, the dielectric's lobe, a light
# edge) falls on the other side of a rounding changes its pixel by a
# whole sample: at most 2% of the pixels may (seen: none of 576 on 8 seeds)
CEILING_PCT = 2.0


def variant(scenes_dir, d, seed: int) -> str:
    """mitsuba's geometry under materials drawn from ``seed``, in ``d``; an
    even seed also textures the conductor's specularity (RGB) and the
    dielectric's roughness (a luminance image: its red channel)."""
    from PIL import Image

    g = np.random.default_rng(seed)
    shutil.copy(os.path.join(scenes_dir, "mitsuba.obj"), d)
    Image.fromarray(g.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(os.path.join(d, "tex.png"))
    Image.fromarray(g.integers(0, 256, (8, 12, 3), dtype=np.uint8)).save(os.path.join(d, "spec.png"))
    Image.fromarray(g.integers(26, 256, (8, 8), dtype=np.uint8), "L").save(os.path.join(d, "rough.png"))

    def colour():
        return "{%.4f, %.4f, %.4f}" % tuple(g.uniform(0.05, 1.0, 3))

    textured = seed % 2 == 0
    spec = '"spec.png"' if textured else colour()
    rough = '"rough.png"' if textured else "%.4f" % g.uniform(0.1, 1.0)
    with open(os.path.join(d, "mitsuba.mtl"), "w") as f:
        f.write('newmtl floor\nmat_expr diffuse(reflectance: "tex.png")\n\n')
        f.write("newmtl rough_gold\nmat_expr roughConductor(specularity: %s, roughness: %.4f, "
                "intIOR: %.4f)\n\n" % (spec, g.uniform(0.1, 1.0), g.uniform(1.2, 2.2)))
        f.write("newmtl rough_glass\nmat_expr roughDielectric(specularity: %s, transmittance: %s, "
                "intIOR: %.4f, roughness: %s)\n\n"
                % (colour(), colour(), g.uniform(1.2, 2.0), rough))
        f.write("newmtl lamp\nmat_expr emissive(radiance: {1, 1, 1}, scale: 14)\n\n")
    return os.path.join(d, "mitsuba.obj")


def port_accum(path, seed):
    torch.set_num_threads(2)
    r = TorchRenderer(compile_scene(read_scene(path)), device="cpu")
    opt = RenderOptions(width=SIZE, height=SIZE, spp=SPP, num_bounces=5, min_bounces_for_rr=3,
                        exposure=1.2, seed=seed)
    return r.render_accum(opt).reshape(-1, 3)


def reference_accum(rs, seed, dtype=torch.float32):
    ref = M.RefRenderer(rs, build(rs.v0, rs.e1, rs.e2), "cpu", dtype)
    acc = ref.render_frames([seed], torch.arange(SIZE * SIZE), SIZE, SIZE, SPP, M.Integrator(5, 3, 1.2))
    return acc[0].float()


def pixels_apart_pct(a, b):
    far = (a - b).abs() > REL * (a.abs() + b.abs()) + ABS
    return float(100.0 * far.any(dim=-1).float().mean())


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_port_matches_the_reference(scenes_dir, tmp_path, seed):
    path = variant(scenes_dir, tmp_path, seed)
    got = port_accum(path, 1000 + seed)
    want = reference_accum(M.read_obj(path), 1000 + seed)
    assert float(want.sum()) > 0
    assert pixels_apart_pct(got, want) <= CEILING_PCT


@pytest.mark.parametrize("fault", ["bfloat16", "roughness_1pct"])
def test_a_coarser_or_altered_reference_fails(scenes_dir, tmp_path, fault):
    path = variant(scenes_dir, tmp_path, 15)
    got = port_accum(path, 1015)
    rs = M.read_obj(path)
    if fault == "bfloat16":
        want = reference_accum(rs, 1015, torch.bfloat16)
    else:
        for m in rs.materials:
            if isinstance(m.get("roughness"), float):
                m["roughness"] *= 1.01
        want = reference_accum(rs, 1015)
    assert pixels_apart_pct(got, want) > CEILING_PCT


def test_the_reference_reads_the_scene_files(scenes_dir):
    rs = M.read_obj(os.path.join(scenes_dir, "mitsuba.obj"))
    assert rs.num_tris == 2564 and rs.light_tri.size == 2
    assert [m["kind"] for m in rs.materials] == ["roughConductor", "roughDielectric", "diffuse", "emissive"]
    gold, glass, floor, _ = rs.materials
    assert gold["roughness"] == 0.25 and gold["intIOR"] == M.IORS["glass"]
    assert glass["intIOR"] == 1.51714 and glass["transmittance"] == (0.95, 0.95, 0.95)
    assert floor["reflectance"] == "checker.png" and rs.textures[0].shape == (64, 64, 3)
    # the floor's vt rows: uv (0,0)-(4,4) over its quad
    floor_uv = rs.uvs[rs.tri_mat == 2]
    assert floor_uv.min() == 0.0 and floor_uv.max() == 4.0


def test_texture_sampler_wraps_and_clamps():
    tex = torch.tensor([[[0, 0, 0], [255, 255, 255]]], dtype=torch.uint8)  # 1x2
    uv = torch.tensor([[0.25, 0.5], [1.25, 0.5], [0.75, 0.5], [0.5, 0.5]])
    got = M.sample_texture(tex, uv, torch.float32)[:, 0]
    inv = M.INV255 * 255.0
    # 0.25 -> texel 0 at 0.5 of the way to texel 1; wrapped alike at 1.25;
    # 0.75 -> texel 1, whose +1 neighbour is itself (clamped, not wrapped)
    assert torch.allclose(got, torch.tensor([0.5 * inv, 0.5 * inv, inv, inv]), atol=0, rtol=0)


# ----------------------------------------------------------------- census


def _hand_counts(S, hit, out, kw):
    """A leaf-only scene's census of one bounce, from its inputs and results."""
    root = S["tri_material"][hit.tri.long()].long()
    kind = S["mat_type"][root]
    emitter = hit.mask & (kind == B.BXDF_EMISSIVE)
    surface = hit.mask & ~emitter
    rd = surface & (kind == B.BXDF_ROUGH_DIELECTRIC)
    # the lobe a rough dielectric picks: u1 <= Schlick's F, or TIR
    tri = S["tri_normals"].reshape(-1, 9)[hit.tri.long()]
    w = 1.0 - hit.u - hit.v
    n = V.normalize3(w[:, None] * tri[:, 0:3] + hit.u[:, None] * tri[:, 3:6] + hit.v[:, None] * tri[:, 6:9])
    i_dot_n = V.dot3(-kw["ray_d"], n)
    inside = i_dot_n < 0
    eta_i = torch.where(inside, S["mat_int_ior"][root], S["mat_ext_ior"][root])
    eta_t = torch.where(inside, S["mat_ext_ior"][root], S["mat_int_ior"][root])
    eta = eta_i / eta_t
    cos_t_sq = 1.0 + eta * eta * (i_dot_n * i_dot_n - 1.0)
    reflect = (cos_t_sq <= 0.0) | (kw["U"](STREAM_BXDF_U) <= V.fresnel_dielectric(eta_i, eta_t, i_dot_n))
    rr_p = torch.clamp(torch.clamp(V.luminance(kw["throughput"]), max=0.5), min=0.01)
    ended = surface & (kw["bounce"] >= kw["min_bounces_for_rr"]) & (rr_p < kw["U"](STREAM_RR))
    count = dict(
        alive=kw["alive"], surface=surface, emitter=emitter, miss=kw["alive"] & ~hit.mask,
        diffuse=surface & (kind == B.BXDF_DIFFUSE), conductor=surface & (kind == B.BXDF_CONDUCTOR),
        dielectric=surface & (kind == B.BXDF_DIELECTRIC),
        rough_conductor=surface & (kind == B.BXDF_ROUGH_CONDUCTOR),
        rough_dielectric_reflect=rd & reflect, rough_dielectric_refract=rd & ~reflect,
        textured=hit.mask & (S["mat_reflectance_tex"][root] >= 0), rr_ended=ended,
        shadow_rays=out["occl_mask"],
    )
    return {k: int(v.sum()) for k, v in count.items()}


def _adds_up(row):
    kinds = ("diffuse", "conductor", "dielectric", "rough_conductor",
             "rough_dielectric_reflect", "rough_dielectric_refract")
    assert row["alive"] == row["surface"] + row["emitter"] + row["miss"], row
    assert row["surface"] == sum(row[k] for k in kinds), row
    assert row["rr_ended"] <= row["surface"] and row["shadow_rays"] <= row["surface"], row


def test_census_equals_the_hand_counts(scenes_dir):
    r = TorchRenderer(compile_scene(read_scene(os.path.join(scenes_dir, "mitsuba.obj"))),
                      device="cpu", mode="bvh")
    seen = []
    with torch.no_grad():
        for b, hit, kw in shade_bounces(r, 32, seed=5, per_lane=False):
            with profiling.shade_census() as census:
                _, out = shade_bounce_plain(r.S, hit, **kw)
            rows = census.read()
            assert len(rows) == b + 1 and not any(any(x.values()) for x in rows[:b])
            assert rows[b] == _hand_counts(r.S, hit, out, kw)
            _adds_up(rows[b])
            seen.append(rows[b])
    for k in ("diffuse", "rough_conductor", "rough_dielectric_reflect", "rough_dielectric_refract",
              "textured", "rr_ended", "shadow_rays", "miss"):
        assert sum(row[k] for row in seen) > 0, k


def test_census_adds_up_on_every_operator(scenes_dir):
    """The coverage scene: every material operator, BxDF and texture kind."""
    r = TorchRenderer(coverage_scene(scenes_dir), device="cpu", mode="bvh")
    opt = RenderOptions(width=24, height=24, spp=2, num_bounces=4, min_bounces_for_rr=2, seed=3)
    with torch.no_grad(), profiling.shade_census() as census:
        r.render_accum(opt)
    rows = census.read()
    assert rows[0]["alive"] == 24 * 24 * 2 and len(rows) <= 4
    for row in rows:
        _adds_up(row)
    total = {k: sum(row[k] for row in rows) for k in profiling.CENSUS_KINDS}
    for k in ("diffuse", "conductor", "dielectric", "rough_conductor", "textured", "emitter"):
        assert total[k] > 0, (k, total)


def test_census_is_the_same_under_path_regeneration(scenes_dir):
    """Regeneration shades every depth in one pass (a bounce a lane): its
    census, counted by each lane's own bounce, is the sequential loop's."""
    scene = compile_scene(read_scene(os.path.join(scenes_dir, "mitsuba.obj")))
    opt = RenderOptions(width=16, height=16, spp=2, num_bounces=5, min_bounces_for_rr=3, seed=8)
    got = {}
    for regen in (False, True):
        with torch.no_grad(), profiling.shade_census() as census:
            TorchRenderer(scene, device="cpu", mode="bvh", regen=regen).render_accum(opt)
        got[regen] = census.read()
    assert got[True] == got[False]


def test_census_is_off_by_default(scenes_dir):
    r = TorchRenderer(compile_scene(read_scene(os.path.join(scenes_dir, "mitsuba.obj"))), device="cpu")
    opt = RenderOptions(width=8, height=8, spp=1, num_bounces=3, seed=1)
    assert profiling.active_census() is None
    with profiling.shade_census() as census:
        assert profiling.active_census() is census
    assert profiling.active_census() is None
    r.render_accum(opt)
    assert census.read() == [] and int(census.rows.abs().sum()) == 0
    with pytest.raises(ValueError):
        profiling.ShadeCensus("meta").add(0, torch.ones((1, len(profiling.CENSUS_KINDS)), dtype=torch.bool))
