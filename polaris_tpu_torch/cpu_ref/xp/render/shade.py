"""The per-bounce shading megastep, shared by the NumPy golden renderer and
the jitted TPU integrator.

Counterpart of the reference's ``shadeHits`` mega-kernel
(``CL/kernels/pt_integrator.cl:17-211``) plus the miss-shading kernels
(pt_integrator.cl:214-275). The TPU-first restructuring:

  * fixed-shape lanes, ray i <-> pixel i for the whole bounce scan — the
    reference's atomic queue compaction (pt_integrator.cl:49-64,186-210)
    disappears; dead lanes are masked instead of compacted, so the
    accumulator update is a pure lanewise add with **no scatter**
  * all random draws come from a counter-based per-site stream (ops/rng.py)
    rather than one sequential PRNG state per thread

The physics is replicated exactly (formula citations inline).
"""

from __future__ import annotations

from ..ops import vec as V
from ..ops.bxdf import (
    BXDF_EMISSIVE,
    BXDF_SINGULAR_MASK,
    bxdf_eval,
    bxdf_pdf,
    bxdf_sample,
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
from ..ops.texture import mat_sample3


def power_heuristic(xp, a, b):
    """a^2 / (a^2 + b^2) with a safe denominator (pt_integrator.cl:9)."""
    a2 = a * a
    denom = a2 + b * b
    return xp.where(denom > 0.0, a2 / xp.maximum(denom, 1e-30), 0.0)


def shade(
    xp,
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
      bounce / min_bounces_for_rr / num_emissives: python ints (static).
      ray/hit/path state: [N]-shaped arrays; ``hit_mask`` excludes misses and
        dead lanes.

    Returns a dict with emissive-hit accumulation, the next indirect ray,
    occlusion-ray + pending NEE sample, and updated path state.
    """
    f32 = ray_o.dtype

    # --- surface reconstruction (CL/util/surface.cl surfaceInit) ---
    in_dir = -ray_d  # points away from the surface (pt_integrator.cl:86-89)
    point = ray_o + t[..., None] * ray_d
    w = 1.0 - bary_u - bary_v
    # per-triangle vertex attributes are fetched as FLAT CONTIGUOUS rows:
    # XLA lowers a (1, 3, 2)/(1, 3, 3) multi-dim slice gather through a
    # catastrophic per-element path (~5 ms per 262k-lane pass — measured
    # e2e, ATTRIB_r03/texprobe: the whole +49% "texture tax" was ONE such
    # tri_uvs gather), while a flat (1, K)-row gather is free
    tn = S["tri_normals"].reshape(-1, 9)[tri]  # (N, 9)
    n_obj = (
        w[..., None] * tn[..., 0:3]
        + bary_u[..., None] * tn[..., 3:6]
        + bary_v[..., None] * tn[..., 6:9]
    )
    # normals transform by w2o^T (inverse-transpose of object->world)
    w2o = V.take_small(xp, S["inst_w2o"], inst)
    normal = V.normalize3(xp, V.transform_normal(xp, w2o, n_obj))
    tuv = S["tri_uvs"].reshape(-1, 6)[tri]  # (N, 6)
    uv = (
        w[..., None] * tuv[..., 0:2]
        + bary_u[..., None] * tuv[..., 2:4]
        + bary_v[..., None] * tuv[..., 4:6]
    )

    # --- layered material selection (material_sampler.cl matSelectNode) ---
    root = S["tri_material"][tri]
    if material_depth is None:
        material_depth = MAX_MATERIAL_DEPTH
    mat, normal, tint, new_flags = select_material(
        xp, S, U, root, normal, uv, flags, max_depth=material_depth
    )
    flags = xp.where(hit_mask, new_flags, flags)

    i_dot_n = V.dot3(xp, in_dir, normal)
    is_emissive = mat["type"] == BXDF_EMISSIVE

    # --- emissive hit: throughput * scale * radiance if front-facing,
    #     then kill the path (pt_integrator.cl:103-107) ---
    ke = mat_sample3(xp, S, uv, mat["radiance"], mat["radiance_tex"], "radiance")
    emit_mask = hit_mask & is_emissive & (i_dot_n > 0.0)
    emit_add = xp.where(
        emit_mask[..., None],
        throughput * mat["scale"][..., None] * ke,
        xp.zeros_like(throughput),
    )

    # --- Russian roulette (pt_integrator.cl:112-124) ---
    # ``bounce`` may be a traced scalar (lax.scan over bounces), so RR is
    # always evaluated and masked by ``rr_on``.
    shade_mask = hit_mask & (~is_emissive)
    # NOTE: ``bounce`` may be a python int, so rr_on can be a python bool —
    # use logical_* (a python ``~False`` is -2 and would silently turn the
    # masks into integer arrays).
    rr_on = bounce >= min_bounces_for_rr
    rr_p = xp.maximum(
        xp.minimum(xp.asarray(0.5, f32), V.luminance(xp, throughput)), 0.01
    )
    rr_survive = xp.logical_or(xp.logical_not(rr_on), rr_p >= U(STREAM_RR))
    boost = shade_mask & xp.logical_and(rr_on, rr_survive)
    throughput = xp.where(
        boost[..., None], throughput / rr_p[..., None], throughput
    )
    shade_mask = shade_mask & rr_survive

    # --- BxDF importance sample (pt_integrator.cl:128) ---
    u1 = U(STREAM_BXDF_U)
    u2 = U(STREAM_BXDF_V)
    b_out, b_pdf, b_val = bxdf_sample(xp, S, mat, normal, uv, in_dir, u1, u2)

    # ray origins: displaced along +/- normal (pt_integrator.cl:130-138)
    displace = xp.sign(V.dot3(xp, normal, b_out))
    bxdf_origin = point + (displace * V.INTERSECTION_EPSILON)[..., None] * normal
    emissive_origin = point + V.INTERSECTION_EPSILON * normal

    # --- NEE with MIS (pt_integrator.cl:140-167) ---
    if num_emissives > 0:
        l_idx, sel_pdf = emissive_select(xp, num_emissives, U(STREAM_LIGHT_SELECT))
        e_val, e_dir, e_pdf, e_dist = emissive_sample(
            xp, S, point, normal, l_idx, U(STREAM_LIGHT_U), U(STREAM_LIGHT_V)
        )
        bxdf_e_pdf = bxdf_pdf(xp, S, mat, normal, uv, in_dir, e_dir)
        e_weight = power_heuristic(xp, e_pdf, bxdf_e_pdf)
        e_bxdf_pdf = emissive_pdf(xp, S, point, normal, l_idx, b_out)
        b_weight = power_heuristic(xp, b_pdf, e_bxdf_pdf)

        n_dot_e = xp.maximum(0.0, V.dot3(xp, normal, e_dir))
        valid_e = (V.maxcomp3(xp, e_val) > 0.0) & (e_pdf > 0.0) & (n_dot_e > 0.0)
        b_eval_e = bxdf_eval(xp, S, mat, normal, uv, in_dir, e_dir)
        e_sample = (
            e_val
            * b_eval_e
            * throughput
            * V.safe_div(xp, e_weight * n_dot_e, e_pdf * sel_pdf, 1e-12)[..., None]
        )
        occl_mask = shade_mask & valid_e & (V.maxcomp3(xp, e_sample) > 0.0)
        occl_maxt = xp.where(
            occl_mask, e_dist - V.INTERSECTION_WITH_LIGHT_EPSILON, 0.0
        )
    else:
        e_sample = xp.zeros_like(throughput)
        occl_mask = shade_mask & False
        occl_maxt = xp.zeros_like(t)
        e_dir = b_out
        b_weight = xp.ones_like(b_pdf)

    # singular bxdfs keep weight 1 (pt_integrator.cl:166-168)
    b_weight = xp.where((mat["type"] & BXDF_SINGULAR_MASK) != 0, 1.0, b_weight)

    # --- throughput update + indirect ray (pt_integrator.cl:170-177) ---
    tp_mul = b_val * tint * (b_weight * xp.abs(V.dot3(xp, normal, b_out)))[..., None]
    # pdf floor 1e-12 kills numerically-degenerate lanes (also the worst
    # fireflies); the reference divides by any positive pdf
    # (pt_integrator.cl:174-177) which overflows f32 gradients.
    indirect_mask = shade_mask & (V.maxcomp3(xp, tp_mul) > 0.0) & (b_pdf > 1e-12)
    inv_pdf = V.safe_div(xp, xp.ones_like(b_pdf), b_pdf, 1e-12)
    new_throughput = xp.where(
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


def shade_miss(xp, S, ray_d, throughput, is_primary, scene_diffuse_mat: int):
    """Background shading for rays that miss all geometry.

    Primary misses add the background sample directly; indirect misses
    multiply by the path throughput (pt_integrator.cl:214-275).
    ``is_primary`` may be a traced boolean (scan over bounces).
    """
    from ..ops.statics import bg_has_tex

    # the background material index is static: fetch its row once (no
    # per-lane gather) and let broadcasting lift it to [N,3]
    row = S["mat_reflectance"][scene_diffuse_mat]
    if bg_has_tex(S):
        uv = V.ray_to_latlong_uv(xp, ray_d)
        tex_idx = xp.full(
            ray_d.shape[:-1],
            S["mat_reflectance_tex"][scene_diffuse_mat],
            dtype="int32",
        )
        kd = mat_sample3(xp, S, uv, row, tex_idx)
    else:
        # constant background color: skip the lat-long uv + atlas gathers
        kd = xp.broadcast_to(row, ray_d.shape[:-1] + (3,))
    if isinstance(is_primary, bool):
        return kd if is_primary else throughput * kd
    return xp.where(is_primary, kd, throughput * kd)


def tonemap_reinhard(xp, accum, sample_weight, exposure):
    """LDR conversion (CL/kernels/hdr.cl:5-28): Reinhard + gamma 1/2.2."""
    hdr = accum * (sample_weight * exposure)
    mapped = hdr / (hdr + 1.0)
    return xp.clip(mapped ** (1.0 / 2.2), 0.0, 1.0)
