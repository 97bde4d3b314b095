"""The per-bounce shading megastep (PyTorch): the plain version of the
shading kernel (``ops/shade_cuda.py``, ``csrc/shade.cu``), and the
differentiable path of the loss.

Counterpart of the reference's ``shadeHits`` mega-kernel
(``CL/kernels/pt_integrator.cl:17-211``) plus the miss-shading kernels
(pt_integrator.cl:214-275):

  * fixed-shape lanes, ray i <-> pixel i for the whole bounce loop — dead
    lanes are masked instead of compacted, so the accumulator update is a
    pure lanewise add with **no scatter**
  * all random draws come from a counter-based per-site stream (ops/rng.py)
    rather than one sequential PRNG state per thread

The physics is replicated exactly (formula citations inline).
"""

from __future__ import annotations

import torch

from ..ops import vec as V
from ..ops.bxdf import (
    BXDF_CONDUCTOR,
    BXDF_DIELECTRIC,
    BXDF_DIFFUSE,
    BXDF_EMISSIVE,
    BXDF_ROUGH_CONDUCTOR,
    BXDF_ROUGH_DIELECTRIC,
    BXDF_SINGULAR_MASK,
    bxdf_eval,
    bxdf_pdf,
    bxdf_sample,
    dielectric_split,
)
from ..ops.emissive import emissive_pdf, emissive_sample, emissive_select
from ..ops.material import MAX_MATERIAL_DEPTH, select_material
from ..ops.rng import (
    STREAM_BXDF_U,
    STREAM_BXDF_V,
    STREAM_LIGHT_SELECT,
    STREAM_LIGHT_U,
    STREAM_LIGHT_V,
    STREAM_RR,
)
from ..ops.statics import TEXTURE_FIELDS
from ..ops.texture import mat_sample3
from ..utils import profiling


def power_heuristic(a, b):
    """a^2 / (a^2 + b^2) with a safe denominator (pt_integrator.cl:9)."""
    a2 = a * a
    denom = a2 + b * b
    return torch.where(denom > 0.0, a2 / torch.clamp(denom, min=1e-30), 0.0)


def surface(S, U, *, inst, tri, bary_u, bary_v, flags, material_depth=None, tex_ops=False):
    """The shading frame and material of each hit: ``(normal, uv, mat,
    tint, flags)``, with the walk's ``tex_op`` last when ``tex_ops``
    (``select_material``)."""
    # --- surface reconstruction (CL/util/surface.cl surfaceInit) ---
    w = 1.0 - bary_u - bary_v
    # per-triangle vertex attributes are stored and fetched as flat rows
    tn = S["tri_normals"].reshape(-1, 9)[tri.long()]  # (N, 9)
    n_obj = (
        w[..., None] * tn[..., 0:3]
        + bary_u[..., None] * tn[..., 3:6]
        + bary_v[..., None] * tn[..., 6:9]
    )
    # normals transform by w2o^T (inverse-transpose of object->world)
    w2o = V.take_small(S["inst_w2o"], inst)
    normal = V.normalize3(V.transform_normal(w2o, n_obj))
    tuv = S["tri_uvs"].reshape(-1, 6)[tri.long()]  # (N, 6)
    uv = (
        w[..., None] * tuv[..., 0:2]
        + bary_u[..., None] * tuv[..., 2:4]
        + bary_v[..., None] * tuv[..., 4:6]
    )

    # --- layered material selection (material_sampler.cl matSelectNode) ---
    root = S["tri_material"][tri.long()]
    if material_depth is None:
        material_depth = MAX_MATERIAL_DEPTH
    mat, normal, *rest = select_material(
        S, U, root, normal, uv, flags, max_depth=material_depth, tex_ops=tex_ops
    )
    return (normal, uv, mat, *rest)


def shade(
    S,
    U,
    *,
    bounce,
    min_bounces_for_rr,
    num_emissives,
    material_depth=None,
    ray_o,
    ray_d,
    t,
    inst,
    tri,
    bary_u,
    bary_v,
    hit_mask,
    throughput,
    flags,
):
    """Shade all hit lanes for one bounce.

    Args:
      S: merged scene-array dict; U: uniform closure ``U(stream) -> [N]``.
      bounce: python int, or a per-lane integer tensor (path regeneration).
      min_bounces_for_rr / num_emissives: python ints.
      ray/hit/path state: [N]-shaped arrays; ``hit_mask`` excludes misses and
        dead lanes.

    Returns a dict with emissive-hit accumulation, the next indirect ray,
    occlusion-ray + pending NEE sample, and updated path state.
    """
    in_dir = -ray_d  # points away from the surface (pt_integrator.cl:86-89)
    point = ray_o + t[..., None] * ray_d
    normal, uv, mat, tint, new_flags = surface(
        S, U, inst=inst, tri=tri, bary_u=bary_u, bary_v=bary_v, flags=flags,
        material_depth=material_depth,
    )
    flags = torch.where(hit_mask, new_flags, flags)

    i_dot_n = V.dot3(in_dir, normal)
    is_emissive = mat["type"] == BXDF_EMISSIVE

    # --- emissive hit: throughput * scale * radiance if front-facing,
    #     then kill the path (pt_integrator.cl:103-107) ---
    ke = mat_sample3(S, uv, mat["radiance"], mat["radiance_tex"], "radiance")
    emit_mask = hit_mask & is_emissive & (i_dot_n > 0.0)
    emit_add = torch.where(
        emit_mask[..., None],
        throughput * mat["scale"][..., None] * ke,
        torch.zeros_like(throughput),
    )

    # --- Russian roulette (pt_integrator.cl:112-124) ---
    # ``bounce`` may be a per-lane tensor, so RR is evaluated on every lane
    # and masked by ``rr_on`` (a python bool when ``bounce`` is an int).
    shade_mask = hit_mask & (~is_emissive)
    rr_on = bounce >= min_bounces_for_rr
    if not isinstance(rr_on, torch.Tensor):
        rr_on = torch.full_like(hit_mask, bool(rr_on))
    rr_p = torch.clamp(
        torch.clamp(V.luminance(throughput), max=0.5), min=0.01
    )
    rr_survive = (~rr_on) | (rr_p >= U(STREAM_RR))
    boost = shade_mask & rr_on & rr_survive
    throughput = torch.where(
        boost[..., None], throughput / rr_p[..., None], throughput
    )
    shade_mask = shade_mask & rr_survive

    # --- BxDF importance sample (pt_integrator.cl:128) ---
    u1 = U(STREAM_BXDF_U)
    u2 = U(STREAM_BXDF_V)
    b_out, b_pdf, b_val = bxdf_sample(S, mat, normal, uv, in_dir, u1, u2)

    # ray origins: displaced along +/- normal (pt_integrator.cl:130-138)
    displace = torch.sign(V.dot3(normal, b_out))
    bxdf_origin = point + (displace * V.INTERSECTION_EPSILON)[..., None] * normal
    emissive_origin = point + V.INTERSECTION_EPSILON * normal

    # --- NEE with MIS (pt_integrator.cl:140-167) ---
    if num_emissives > 0:
        l_idx, sel_pdf = emissive_select(num_emissives, U(STREAM_LIGHT_SELECT))
        e_val, e_dir, e_pdf, e_dist = emissive_sample(
            S, point, normal, l_idx, U(STREAM_LIGHT_U), U(STREAM_LIGHT_V)
        )
        bxdf_e_pdf = bxdf_pdf(S, mat, normal, uv, in_dir, e_dir)
        e_weight = power_heuristic(e_pdf, bxdf_e_pdf)
        e_bxdf_pdf = emissive_pdf(S, point, normal, l_idx, b_out)
        b_weight = power_heuristic(b_pdf, e_bxdf_pdf)

        n_dot_e = torch.clamp(V.dot3(normal, e_dir), min=0.0)
        valid_e = (V.maxcomp3(e_val) > 0.0) & (e_pdf > 0.0) & (n_dot_e > 0.0)
        b_eval_e = bxdf_eval(S, mat, normal, uv, in_dir, e_dir)
        e_sample = (
            e_val
            * b_eval_e
            * throughput
            * V.safe_div(e_weight * n_dot_e, e_pdf * sel_pdf, 1e-12)[..., None]
        )
        occl_mask = shade_mask & valid_e & (V.maxcomp3(e_sample) > 0.0)
        occl_maxt = torch.where(
            occl_mask, e_dist - V.INTERSECTION_WITH_LIGHT_EPSILON, 0.0
        )
    else:
        e_sample = torch.zeros_like(throughput)
        occl_mask = torch.zeros_like(shade_mask)
        occl_maxt = torch.zeros_like(t)
        e_dir = b_out
        b_weight = torch.ones_like(b_pdf)

    # singular bxdfs keep weight 1 (pt_integrator.cl:166-168)
    b_weight = torch.where((mat["type"] & BXDF_SINGULAR_MASK) != 0, 1.0, b_weight)

    # --- throughput update + indirect ray (pt_integrator.cl:170-177) ---
    tp_mul = b_val * tint * (b_weight * torch.abs(V.dot3(normal, b_out)))[..., None]
    # pdf floor 1e-12 kills numerically-degenerate lanes (also the worst
    # fireflies); the reference divides by any positive pdf
    # (pt_integrator.cl:174-177) which overflows f32 gradients.
    indirect_mask = shade_mask & (V.maxcomp3(tp_mul) > 0.0) & (b_pdf > 1e-12)
    inv_pdf = V.safe_div(torch.ones_like(b_pdf), b_pdf, 1e-12)
    new_throughput = torch.where(
        indirect_mask[..., None],
        throughput * tp_mul * inv_pdf[..., None],
        throughput,
    )

    return {
        "emit_add": emit_add,
        "next_o": bxdf_origin,
        "next_d": b_out,
        "next_mask": indirect_mask,
        "throughput": new_throughput,
        "flags": flags,
        "occl_o": emissive_origin,
        "occl_d": e_dir,
        "occl_maxt": occl_maxt,
        "occl_mask": occl_mask,
        "occl_value": e_sample,
    }


def shade_miss(S, ray_d, throughput, is_primary, scene_diffuse_mat: int):
    """Background shading for rays that miss all geometry.

    Primary misses add the background sample directly; indirect misses
    multiply by the path throughput (pt_integrator.cl:214-275).
    ``is_primary`` is a python bool, or a per-lane [N,1] boolean tensor
    (path regeneration mixes bounce depths in one pass).
    """
    from ..ops.statics import bg_has_tex

    # the background material index is static: fetch its row once (no
    # per-lane gather) and let broadcasting lift it to [N,3]
    row = S["mat_reflectance"][scene_diffuse_mat]
    if bg_has_tex(S):
        uv = V.ray_to_latlong_uv(ray_d)
        tex_idx = S["mat_reflectance_tex"][scene_diffuse_mat].expand(
            ray_d.shape[:-1]
        )
        kd = mat_sample3(S, uv, row, tex_idx)
    else:
        # constant background color: skip the lat-long uv + atlas lookups
        kd = row.expand(ray_d.shape[:-1] + (3,))
    if isinstance(is_primary, bool):
        return kd if is_primary else throughput * kd
    return torch.where(is_primary, kd, throughput * kd)


def shade_bounce_plain(
    S, hit, *, ray_o, ray_d, alive, throughput, flags, radiance, U, bounce, is_primary,
    min_bounces_for_rr, num_emissives, scene_diffuse_mat, material_depth,
):
    """The shading of one bounce after its closest hits ``hit``: the miss
    background (when the scene has one) and the emission of hits added to
    ``radiance``, and ``shade``'s dict. Returns ``(radiance, out)``.

    The plain version of ``ops/shade_cuda.py::shade_bounce`` (same arguments,
    same results), and the differentiable path: ``render/integrator.py::
    _trace_bounce`` runs it where the kernel does not (the CPU, and calls
    that autograd records)."""
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
    take_census(S, hit, out, ray_d=ray_d, alive=alive, throughput=throughput, flags=flags, U=U,
                bounce=bounce, min_bounces_for_rr=min_bounces_for_rr,
                material_depth=material_depth)
    return radiance, out


def census_lanes(S, hit, out, *, ray_d, alive, throughput, flags, U, bounce,
                 min_bounces_for_rr, material_depth, **_):
    """What each lane did in one bounce's shading (``shade_bounce_plain`` or
    the kernel): bool ``[N, len(CENSUS_KINDS)]`` (utils/profiling.py),
    worked out from the bounce's inputs and ``out``, its results, the
    material walk and the draws taken again as ``shade`` takes them."""
    normal, _, mat, _, _, tex_op = surface(
        S, U, inst=hit.inst, tri=hit.tri, bary_u=hit.u, bary_v=hit.v, flags=flags,
        material_depth=material_depth, tex_ops=True,
    )
    kind = mat["type"]
    emitter = hit.mask & (kind == BXDF_EMISSIVE)
    surf = hit.mask & ~emitter
    *_, pick_reflect = dielectric_split(mat, V.dot3(-ray_d, normal), U(STREAM_BXDF_U))
    rough_diel = surf & (kind == BXDF_ROUGH_DIELECTRIC)
    textured = tex_op
    for f in TEXTURE_FIELDS:
        textured = textured | (mat[f + "_tex"] >= 0)
    rr_on = bounce >= min_bounces_for_rr
    rr_p = torch.clamp(torch.clamp(V.luminance(throughput), max=0.5), min=0.01)
    rr_ended = surf & rr_on & ~(rr_p >= U(STREAM_RR))
    lanes = dict(
        alive=alive, surface=surf, emitter=emitter, miss=alive & ~hit.mask,
        diffuse=surf & (kind == BXDF_DIFFUSE), conductor=surf & (kind == BXDF_CONDUCTOR),
        dielectric=surf & (kind == BXDF_DIELECTRIC),
        rough_conductor=surf & (kind == BXDF_ROUGH_CONDUCTOR),
        rough_dielectric_reflect=rough_diel & pick_reflect,
        rough_dielectric_refract=rough_diel & ~pick_reflect,
        textured=hit.mask & textured, rr_ended=rr_ended, shadow_rays=out["occl_mask"],
    )
    return torch.stack([lanes[k] for k in profiling.CENSUS_KINDS], dim=-1)


def take_census(S, hit, out, **kw) -> None:
    """Count one bounce's lanes into the census that is on
    (``profiling.shade_census``), in a span ``shade_census``; nothing when it
    is off. ``kw``: the bounce's arguments (``census_lanes``)."""
    census = profiling.active_census()
    if census is None:
        return
    with torch.profiler.record_function("shade_census"):
        census.add(kw["bounce"], census_lanes(S, hit, out, **kw))


def nee_add_plain(radiance, occl_mask, occluded, occl_value):
    """``radiance`` plus the NEE value of every shadow ray that reached its
    light: the plain version of ``ops/shade_cuda.py::nee_add``."""
    nee = occl_mask & (~occluded)
    return radiance + torch.where(nee[..., None], occl_value, 0.0)


def tonemap_reinhard(accum, sample_weight, exposure):
    """LDR conversion (CL/kernels/hdr.cl:5-28): Reinhard + gamma 1/2.2."""
    hdr = accum * (sample_weight * exposure)
    mapped = hdr / (hdr + 1.0)
    return torch.clamp(mapped ** (1.0 / 2.2), 0.0, 1.0)
