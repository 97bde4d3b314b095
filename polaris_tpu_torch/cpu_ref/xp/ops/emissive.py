"""Emissive (light) sampling: area lights + lat-long environment light.

Counterpart of the reference's ``CL/samplers/emissive_sampler.cl``:
  * uniform light selection, pdf = 1/numLights (emissive_sampler.cl:227-237)
  * area lights: sqrt-warp uniform triangle point, world transform, value =
    scale*ke*cos(theta_y)/dist^2 with pdf = 1/area
    (emissive_sampler.cl:51-114)
  * pdf-of-direction via a world-space ray/triangle test, t^2/(area*|cos|)
    (emissive_sampler.cl:118-173)
  * environment light: cosine-hemisphere sample of the lat-long map, pdf =
    cos(theta)/pi (emissive_sampler.cl:16-47)

Unlike the reference — which transforms emissive normals with the full 4x4
including translation (emissive_sampler.cl:86-92) and stores the instance's
*inverse* matrix as the emissive transform (compiler.go:199-216) — we carry a
proper object->world matrix and a precomputed inverse-transpose normal
matrix, so instanced lights are sampled correctly (docs/parity.md).

All functions are vectorized over lanes; the light index is a per-lane array.
"""

from __future__ import annotations

from . import vec as V
from .statics import has_light
from .texture import mat_sample3

AREA_LIGHT = 0
ENVIRONMENT_LIGHT = 1


def emissive_select(xp, num_lights: int, u):
    """Uniform light pick: (index, pdf) (emissive_sampler.cl:227-237)."""
    idx = xp.clip((u * num_lights).astype("int32"), 0, num_lights - 1)
    pdf = xp.full_like(u, 1.0 / num_lights)
    return idx, pdf


def _light_rows(xp, S):
    """Per-LIGHT world-space triangle rows (L is tiny; computed once per
    trace, not per lane): v0/e1/e2 [L,3], vertex normals [L,3,3], uvs
    [L,3,2]. The per-lane lookup is then a where-select chain
    (vec.take_small) instead of 30+ big-table gathers per lane."""
    tri = S["emis_tri"]
    o2w = S["emis_o2w"]
    v0 = V.transform_point(xp, o2w, S["tri_v0"][tri])
    e1 = V.transform_dir(xp, o2w, S["tri_e1"][tri])
    e2 = V.transform_dir(xp, o2w, S["tri_e2"][tri])
    return v0, e1, e2


def _light_triangle_world(xp, S, l_idx):
    """World-space v0/e1/e2 of each lane's selected light triangle."""
    v0_l, e1_l, e2_l = _light_rows(xp, S)
    v0 = V.take_small(xp, v0_l, l_idx)
    e1 = V.take_small(xp, e1_l, l_idx)
    e2 = V.take_small(xp, e2_l, l_idx)
    return v0, e1, e2


def emissive_sample(xp, S, point, normal, l_idx, u1, u2):
    """Sample a direction to the selected light from ``point``.

    Returns (value [N,3], out_dir [N,3], pdf [N], dist [N]).
    """
    # per-LIGHT rows (L tiny), then per-lane where-select (vec.take_small)
    mat_l = S["emis_mat"]
    e_type = V.take_small(xp, S["emis_type"], l_idx)
    scale = V.take_small(xp, S["mat_scale"][mat_l], l_idx)
    radiance = V.take_small(xp, S["mat_radiance"][mat_l], l_idx)
    radiance_tex = V.take_small(xp, S["mat_radiance_tex"][mat_l], l_idx)
    # light kinds the host proved absent (ops/statics.py) are dropped: their
    # branch only feeds the is_env select below
    AREA = has_light(S, "area")
    ENV = has_light(S, "env")

    # ---- area light (emissive_sampler.cl:51-114)
    if AREA:
        v0, e1, e2 = _light_triangle_world(xp, S, l_idx)
        tn = V.take_small(xp, S["tri_normals"][S["emis_tri"]], l_idx)
        r1s = xp.sqrt(xp.maximum(u1, 0.0))
        ru = (1.0 - u2) * r1s
        rv = u2 * r1s
        # wuv = (1-ru-rv, ru, rv); point = v0 + ru*e1 + rv*e2
        l_point = v0 + ru[..., None] * e1 + rv[..., None] * e2
        n_obj = (
            (1.0 - ru - rv)[..., None] * tn[..., 0, :]
            + ru[..., None] * tn[..., 1, :]
            + rv[..., None] * tn[..., 2, :]
        )
        l_normal = V.dot3(
            xp, V.take_small(xp, S["emis_nmat"], l_idx), n_obj[..., None, :]
        )  # (N,3) rows
        tuv = V.take_small(xp, S["tri_uvs"][S["emis_tri"]], l_idx)
        l_uv = (
            (1.0 - ru - rv)[..., None] * tuv[..., 0, :]
            + ru[..., None] * tuv[..., 1, :]
            + rv[..., None] * tuv[..., 2, :]
        )
        to_light = l_point - point
        sq_dist_raw = V.dot3(xp, to_light, to_light)
        sq_dist = xp.maximum(sq_dist_raw, 1e-20)
        a_dist = xp.sqrt(sq_dist)
        a_dir = to_light / a_dist[..., None]
        n_dot_out = V.dot3(xp, l_normal, -a_dir)
        ke = mat_sample3(xp, S, l_uv, radiance, radiance_tex, "radiance")
        a_pdf = xp.where(
            n_dot_out > 0.0,
            1.0 / xp.maximum(V.take_small(xp, S["emis_area"], l_idx), 1e-20),
            0.0,
        )
        # inverse-square with a 1e-8 floor: shading points closer than 1e-4
        # to the light are clipped instead of overflowing f32 gradients
        inv_sq = V.safe_div(xp, xp.ones_like(sq_dist), sq_dist_raw, 1e-8)
        a_val = V.where3(
            xp,
            n_dot_out > 0.0,
            (scale * n_dot_out * inv_sq)[..., None] * ke,
            xp.zeros_like(ke),
        )

    # ---- environment light (emissive_sampler.cl:16-38)
    if ENV:
        env_dir = V.cos_weighted_hemisphere(xp, normal, u1, u2)
        env_pdf = xp.maximum(0.0, V.dot3(xp, normal, env_dir)) * V.INV_PI
        env_uv = V.ray_to_latlong_uv(xp, env_dir)
        env_ke = mat_sample3(xp, S, env_uv, radiance, radiance_tex, "radiance")
        env_val = (scale * V.INV_PI)[..., None] * env_ke

    if not ENV:
        return a_val, a_dir, a_pdf, a_dist
    if not AREA:
        return env_val, env_dir, env_pdf, xp.full_like(env_pdf, V.FLT_MAX)
    is_env = e_type == ENVIRONMENT_LIGHT
    value = V.where3(xp, is_env, env_val, a_val)
    out_dir = V.where3(xp, is_env, env_dir, a_dir)
    pdf = xp.where(is_env, env_pdf, a_pdf)
    dist = xp.where(is_env, V.FLT_MAX, a_dist)
    return value, out_dir, pdf, dist


def emissive_pdf(xp, S, point, normal, l_idx, out_dir):
    """pdf of the light sampler generating ``out_dir`` (for MIS weighting of
    the bxdf sample) (emissive_sampler.cl:118-173, 41-47)."""
    e_type = V.take_small(xp, S["emis_type"], l_idx)
    AREA = has_light(S, "area")
    ENV = has_light(S, "env")

    # ---- area light: Moller-Trumbore against the world-space triangle
    if AREA:
        v0, e1, e2 = _light_triangle_world(xp, S, l_idx)
        pvec = V.cross3(xp, out_dir, e2)
        det = V.dot3(xp, e1, pvec)
        inv_det = 1.0 / xp.where(xp.abs(det) < V.INTERSECTION_EPSILON, 1.0, det)
        tvec = point - v0
        u = V.dot3(xp, tvec, pvec) * inv_det
        qvec = V.cross3(xp, tvec, e1)
        v = V.dot3(xp, out_dir, qvec) * inv_det
        t = V.dot3(xp, e2, qvec) * inv_det
        hit = (
            (xp.abs(det) >= V.INTERSECTION_EPSILON)
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t >= V.INTERSECTION_EPSILON)
        )
        face_n = V.normalize3(xp, V.cross3(xp, e1, e2))
        denom = V.take_small(xp, S["emis_area"], l_idx) * xp.abs(
            V.dot3(xp, face_n, out_dir)
        )
        a_pdf = xp.where(hit & (denom > 0.0), t * t / xp.maximum(denom, 1e-20), 0.0)
        if not ENV:
            return a_pdf

    env_pdf = xp.maximum(0.0, V.dot3(xp, normal, out_dir) * V.INV_PI)
    if not AREA:
        return env_pdf
    return xp.where(e_type == ENVIRONMENT_LIGHT, env_pdf, a_pdf)
