"""BxDF sample / pdf / eval for all five surface models (PyTorch).

Counterparts (formulas replicated exactly; see each function):
  * diffuse          ref: CL/bxdf/diffuse.cl:12-32
  * conductor        ref: CL/bxdf/conductor.cl:12-62
  * dielectric       ref: CL/bxdf/dielectric.cl:12-60
  * roughConductor   ref: CL/bxdf/rough_conductor.cl:9-78
  * roughDielectric  ref: CL/bxdf/rough_dielectric.cl:9-166 (Walter'07)
  * GGX D/G/sampling ref: CL/samplers/distribution_sampler.cl:16-112
  * dispatch         ref: CL/bxdf/bxdf.cl:13-105

All functions are vectorized over the ray batch: every material field is a
per-lane array (gathered from the SoA scene by the material-tree walk), and
dispatch over the five bxdf types is a where-select over the branches of
the types the scene actually holds (ops/statics.py).

``in_dir`` points AWAY from the surface (the integrator negates the incoming
ray direction, pt_integrator.cl:86-89); ``out_dir`` also points away.

For the singular conductor/dielectric models eval() and pdf() return exact 0:
the reference's conductor matcher accepts a ray only when
dot(reflect(in), out) ∈ [0, 1e-3] — i.e. nearly perpendicular to the true
reflection, which never holds for an actual match — so its effective
behaviour is 0 as well (conductor.cl:37-43; dielectric.cl:50-60 returns 0
outright). MIS then forces bxdfWeight=1 for singular surfaces
(pt_integrator.cl:166-168).
"""

from __future__ import annotations

import torch

from . import vec as V
from .statics import has_bxdf
from .texture import mat_sample1, mat_sample3

# bxdf type bits (shared with asset.material.nodes)
BXDF_EMISSIVE = 1 << 1
BXDF_DIFFUSE = 1 << 2
BXDF_CONDUCTOR = 1 << 3
BXDF_ROUGH_CONDUCTOR = 1 << 4
BXDF_DIELECTRIC = 1 << 5
BXDF_ROUGH_DIELECTRIC = 1 << 6
BXDF_SINGULAR_MASK = BXDF_CONDUCTOR | BXDF_DIELECTRIC


# ---------------------------------------------------------------- GGX helpers


def ggx_g1(roughness, v, n, m):
    """Smith G1 (distribution_sampler.cl:17-31).

    Degenerate grazing configurations (cos^2 below 1e-12) take the exact
    limit G1 -> 0 through a masked branch so f32 gradients can't overflow.
    """
    n_dot_v = V.dot3(n, v)
    m_dot_v = V.dot3(m, v)
    n_dot_v_sq = n_dot_v * n_dot_v
    tan_sq = V.safe_div(1.0 - n_dot_v_sq, n_dot_v_sq, 1e-12)
    a_sq = roughness * roughness
    g = 2.0 / (1.0 + torch.sqrt(1.0 + a_sq * tan_sq))
    g = torch.where(n_dot_v_sq > 1e-12, g, 0.0)
    return torch.where(n_dot_v * m_dot_v <= 0.0, 0.0, g)


def ggx_g(roughness, in_dir, out_dir, n, m):
    return ggx_g1(roughness, in_dir, n, m) * ggx_g1(roughness, out_dir, n, m)


def ggx_d(roughness, n, m):
    """GGX normal distribution (distribution_sampler.cl:36-50)."""
    n_dot_m = V.dot3(n, m)
    n_dot_m_sq = n_dot_m * n_dot_m
    tan_sq = V.safe_div(1.0 - n_dot_m_sq, n_dot_m_sq, 1e-12)
    a_sq = roughness * roughness
    denom = V.PI * n_dot_m_sq * n_dot_m_sq * (a_sq + tan_sq) * (a_sq + tan_sq)
    d = V.safe_div(a_sq, denom, 1e-12)
    d = torch.where(n_dot_m_sq > 1e-12, d, 0.0)
    return torch.where(n_dot_m <= 0.0, 0.0, d)


def ggx_sample_h(roughness, n, u1, u2):
    """Sample a GGX half-vector (distribution_sampler.cl:53-72).

    theta = atan(a * sqrt(u1 / (1 - u1))); phi = 2*pi*u2. The reference
    computes sinPhi = sqrt(1-cosPhi^2) (always >= 0), restricting phi to the
    upper half — replicated here for parity.
    """
    tu, tv = V.tangent_basis(n)
    theta = torch.atan(roughness * torch.sqrt(u1 / torch.clamp(1.0 - u1, min=1e-9)))
    cos_t = torch.cos(theta)
    # floor keeps d(sin_t)/d(roughness) finite at theta = 0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    cos_p = torch.cos(V.TWO_PI * u2)
    sin_p = torch.sqrt(torch.clamp(1.0 - cos_p * cos_p, min=0.0))
    return V.normalize3(
        tu * (sin_t * cos_p)[..., None]
        + tv * (sin_t * sin_p)[..., None]
        + n * cos_t[..., None],
    )


def ggx_reflection_pdf(roughness, in_dir, out_dir, n, h):
    """pdf = D * |h.n| / (4 |o.h|) (distribution_sampler.cl:74-84)."""
    n_dot_h = torch.abs(V.dot3(n, h))
    o_dot_h = torch.abs(V.dot3(out_dir, h))
    return V.safe_div(
        ggx_d(roughness, n, h) * n_dot_h, 4.0 * o_dot_h, 1e-12
    )


def ggx_refraction_pdf(roughness, eta_i, eta_t, in_dir, out_dir, n, h):
    """(distribution_sampler.cl:86-97)"""
    i_dot_h = torch.abs(V.dot3(in_dir, h))
    o_dot_h = torch.abs(V.dot3(out_dir, h))
    h_dot_n = torch.abs(V.dot3(h, n))
    denom = (eta_i * i_dot_h + eta_t * o_dot_h) ** 2
    return V.safe_div(
        ggx_d(roughness, n, h) * h_dot_n * o_dot_h * eta_t * eta_t,
        denom,
        1e-12,
    )


def _rough_alpha(S, mat, uv):
    """Disney remap a = clamp(roughness, MIN_ROUGHNESS, 1)^2
    (rough_conductor.cl:11-12)."""
    r = mat_sample1(S, uv, mat["roughness"], mat["roughness_tex"], "roughness")
    r = torch.clamp(r, V.MIN_ROUGHNESS, 1.0)
    return r * r


def _eta_swapped(mat, i_dot_n):
    """Swap int/ext IOR when hitting from inside (dielectric.cl:18-24)."""
    inside = i_dot_n < 0.0
    eta_i = torch.where(inside, mat["int_ior"], mat["ext_ior"])
    eta_t = torch.where(inside, mat["ext_ior"], mat["int_ior"])
    return eta_i, eta_t


def dielectric_split(mat, i_dot_n, u1):
    """A dielectric's lobe at ``i_dot_n``: ``(eta_i, eta_t, eta, fresnel,
    cos_t_sq, tir, pick_reflect)``, the IORs swapped from inside, Snell's
    cos^2 of the refracted angle, total internal reflection, and the
    reflection that ``u1 <= fresnel`` (or TIR) picks (dielectric.cl:18-40,
    rough_dielectric.cl:20-45)."""
    eta_i, eta_t = _eta_swapped(mat, i_dot_n)
    eta = eta_i / torch.where(eta_t == 0.0, 1.0, eta_t)
    f_diel = V.fresnel_dielectric(eta_i, eta_t, i_dot_n)
    # Snell: cos^2(theta_t) = 1 - eta^2 (1 - cos^2(theta_i)). The
    # reference uses eta instead of eta^2 (dielectric.cl:31,
    # rough_dielectric.cl:36), bending refractions at the wrong angle AND
    # leaving the refracted direction unnormalized — not replicated
    # (docs/parity.md).
    cos_t_sq = 1.0 + eta * eta * (i_dot_n * i_dot_n - 1.0)
    tir = cos_t_sq <= 0.0
    pick_reflect = tir | (u1 <= f_diel)
    return eta_i, eta_t, eta, f_diel, cos_t_sq, tir, pick_reflect


# ---------------------------------------------------------------- sample


def bxdf_sample(S, mat, normal, uv, in_dir, u1, u2):
    """Importance-sample the per-lane bxdf.

    Returns (out_dir [N,3], pdf [N], value [N,3]).

    Branches for BxDF types the host proved absent from the scene
    (ops/statics.py) are skipped: their outputs could only
    feed ``where`` selects whose predicate (mat type == that bit) is false
    on every lane, so the specialized program is value-identical.
    """
    n = normal
    i_dot_n = V.dot3(in_dir, n)
    DIFF = has_bxdf(S, BXDF_DIFFUSE)
    CON = has_bxdf(S, BXDF_CONDUCTOR)
    DIEL = has_bxdf(S, BXDF_DIELECTRIC)
    RC = has_bxdf(S, BXDF_ROUGH_CONDUCTOR)
    RD = has_bxdf(S, BXDF_ROUGH_DIELECTRIC)
    branches = []

    if CON or RC or DIEL or RD:
        ks = mat_sample3(
            S, uv, mat["specularity"], mat["specularity_tex"], "specularity"
        )
    if DIEL or RD:
        tf = mat_sample3(
            S, uv, mat["transmittance"], mat["transmittance_tex"], "transmittance"
        )
    if CON or RC:
        has_ior = mat["int_ior"] != 0.0
        f_cond = torch.where(
            has_ior,
            V.fresnel_dielectric(mat["ext_ior"], mat["int_ior"], i_dot_n),
            1.0,
        )

    # --- diffuse (diffuse.cl:13-21) — also the dispatch base when present
    # (non-surface lanes, e.g. emissive hits, are masked by the caller)
    if DIFF:
        kd = mat_sample3(
            S, uv, mat["reflectance"], mat["reflectance_tex"], "reflectance"
        )
        out = V.cos_weighted_hemisphere(n, u1, u2)
        pdf = V.dot3(n, out) * V.INV_PI
        val = kd * V.INV_PI
    else:
        out = n
        pdf = torch.ones_like(i_dot_n)
        val = torch.zeros_like(n)

    # --- conductor (conductor.cl:13-30)
    if CON:
        c_out = V.reflect(in_dir, n)
        c_pdf = torch.ones_like(i_dot_n)
        c_val = V.safe_div_abs(f_cond, i_dot_n, 1e-8)[..., None] * ks
        branches.append((BXDF_CONDUCTOR, c_out, c_pdf, c_val))

    # --- dielectric (dielectric.cl:13-47)
    if DIEL or RD:
        eta_i, eta_t, eta, f_diel, cos_t_sq, tir, pick_reflect = dielectric_split(
            mat, i_dot_n, u1
        )
        sgn = torch.sign(i_dot_n)
        # sqrt floored at 1e-12: at exactly 0 (TIR boundary) the chain rule
        # yields 0*inf = NaN for IOR gradients
        refr_cos = torch.sqrt(torch.clamp(cos_t_sq, min=1e-12))
    if DIEL:
        # Mirror reflection 2(i.n)n - i (as conductor.cl:18). The reference's
        # dielectric variant carries an extra -sign(iDotN) factor
        # (dielectric.cl:36) that inverts reflections for outside hits — a
        # bug we do not replicate (docs/parity.md).
        refl_out = (2.0 * i_dot_n)[..., None] * n - in_dir
        refr_out = (eta * i_dot_n - sgn * refr_cos)[
            ..., None
        ] * n - eta[..., None] * in_dir
        g_out = V.where3(pick_reflect, refl_out, refr_out)
        g_pdf = torch.where(pick_reflect, torch.where(tir, 1.0, f_diel), 1.0 - f_diel)
        g_k = V.where3(pick_reflect, ks, (eta * eta)[..., None] * tf)
        g_val = V.safe_div(g_pdf, torch.abs(i_dot_n), 1e-8)[..., None] * g_k
        branches.append((BXDF_DIELECTRIC, g_out, g_pdf, g_val))

    # --- roughConductor (rough_conductor.cl:9-41)
    if RC or RD:
        alpha = _rough_alpha(S, mat, uv)
        h = ggx_sample_h(alpha, n, u1, u2)
    if RC:
        rc_out = 2.0 * V.dot3(in_dir, h)[..., None] * h - in_dir
        rc_pdf = ggx_reflection_pdf(alpha, in_dir, rc_out, n, h)
        rc_h = V.normalize3(in_dir + rc_out)
        rc_d = ggx_d(alpha, n, rc_h)
        rc_g = ggx_g(alpha, in_dir, rc_out, n, rc_h)
        rc_o_dot_n = V.dot3(rc_out, n)
        rc_denom = 4.0 * i_dot_n * rc_o_dot_n
        rc_val = V.safe_div(f_cond * rc_d * rc_g, rc_denom, 1e-12)[..., None] * ks
        branches.append((BXDF_ROUGH_CONDUCTOR, rc_out, rc_pdf, rc_val))

    # --- roughDielectric (rough_dielectric.cl:9-96)
    if RD:
        rd_pick_reflect = tir | (u1 <= f_diel)
        rd_refl_out = 2.0 * V.dot3(in_dir, h)[..., None] * h - in_dir
        rd_refl_h = V.normalize3(in_dir + rd_refl_out)
        rd_refl_pdf = torch.where(
            tir,
            1.0,
            ggx_reflection_pdf(alpha, in_dir, rd_refl_out, n, rd_refl_h),
        )
        rd_refl_d = ggx_d(alpha, n, rd_refl_h)
        rd_refl_g = ggx_g(alpha, in_dir, rd_refl_out, n, rd_refl_h)
        rd_refl_o_dot_n = V.dot3(rd_refl_out, n)
        rd_refl_denom = 4.0 * i_dot_n * rd_refl_o_dot_n
        rd_refl_val = (
            V.safe_div(f_diel * rd_refl_d * rd_refl_g, rd_refl_denom, 1e-12)[
                ..., None
            ]
            * ks
        )

        rd_refr_out = (eta * i_dot_n - sgn * refr_cos)[
            ..., None
        ] * h - eta[..., None] * in_dir
        rd_refr_h = V.normalize3(
            -(eta_i[..., None] * in_dir + eta_t[..., None] * rd_refr_out)
        )
        rd_refr_pdf = ggx_refraction_pdf(
            alpha, eta_i, eta_t, in_dir, rd_refr_out, n, rd_refr_h
        )
        rd_i_dot_h = torch.abs(V.dot3(in_dir, rd_refr_h))
        rd_o_dot_h = torch.abs(V.dot3(rd_refr_out, rd_refr_h))
        rd_o_dot_n = V.dot3(rd_refr_out, n)
        focus_denom = (
            i_dot_n
            * rd_o_dot_n
            * (eta_i * rd_i_dot_h + eta_t * rd_o_dot_h) ** 2
        )
        focus = torch.abs(
            V.safe_div_abs(
                eta_t * eta_t * rd_i_dot_h * rd_o_dot_h, focus_denom, 1e-12
            )
        )
        rd_refr_d = ggx_d(alpha, n, rd_refr_h)
        rd_refr_g = ggx_g(alpha, in_dir, rd_refr_out, n, rd_refr_h)
        rd_refr_val = ((1.0 - f_diel) * rd_refr_d * rd_refr_g * focus)[..., None] * tf

        rd_out = V.where3(rd_pick_reflect, rd_refl_out, rd_refr_out)
        rd_pdf = torch.where(rd_pick_reflect, rd_refl_pdf, rd_refr_pdf)
        rd_val = V.where3(rd_pick_reflect, rd_refl_val, rd_refr_val)
        branches.append((BXDF_ROUGH_DIELECTRIC, rd_out, rd_pdf, rd_val))

    # --- dispatch
    t = mat["type"]
    for bt, o, p, v in branches:
        sel = t == bt
        out = V.where3(sel, o, out)
        pdf = torch.where(sel, p, pdf)
        val = V.where3(sel, v, val)
    return out, pdf, val


# ---------------------------------------------------------------- pdf / eval


def bxdf_pdf(S, mat, normal, uv, in_dir, out_dir):
    """pdf of the bxdf generating ``out_dir`` (for MIS).

    Absent BxDF types (ops/statics.py) are skipped — see bxdf_sample."""
    n = normal
    i_dot_n = V.dot3(in_dir, n)
    t = mat["type"]
    pdf = torch.zeros_like(i_dot_n)

    if has_bxdf(S, BXDF_DIFFUSE):
        d_pdf = V.dot3(n, out_dir) * V.INV_PI
        pdf = torch.where(t == BXDF_DIFFUSE, d_pdf, pdf)

    RC = has_bxdf(S, BXDF_ROUGH_CONDUCTOR)
    RD = has_bxdf(S, BXDF_ROUGH_DIELECTRIC)
    if RC or RD:
        alpha = _rough_alpha(S, mat, uv)
        h_refl = V.normalize3(in_dir + out_dir)
        rc_pdf = ggx_reflection_pdf(alpha, in_dir, out_dir, n, h_refl)
    if RC:
        pdf = torch.where(t == BXDF_ROUGH_CONDUCTOR, rc_pdf, pdf)
    if RD:
        eta_i, eta_t = _eta_swapped(mat, i_dot_n)
        h_refr = V.normalize3(
            -(eta_i[..., None] * in_dir + eta_t[..., None] * out_dir)
        )
        rd_pdf = torch.where(
            i_dot_n > 0.0,
            rc_pdf,
            ggx_refraction_pdf(alpha, eta_i, eta_t, in_dir, out_dir, n, h_refr),
        )
        pdf = torch.where(t == BXDF_ROUGH_DIELECTRIC, rd_pdf, pdf)
    # conductor/dielectric: 0 (see module docstring)
    return pdf


def bxdf_eval(S, mat, normal, uv, in_dir, out_dir):
    """Evaluate the bxdf for a given out ray (for NEE).

    Absent BxDF types (ops/statics.py) are skipped — see bxdf_sample."""
    n = normal
    i_dot_n = V.dot3(in_dir, n)
    o_dot_n = V.dot3(out_dir, n)
    t = mat["type"]
    val = torch.zeros_like(normal)

    if has_bxdf(S, BXDF_DIFFUSE):
        kd = mat_sample3(
            S, uv, mat["reflectance"], mat["reflectance_tex"], "reflectance"
        )
        val = V.where3(t == BXDF_DIFFUSE, kd * V.INV_PI, val)

    RC = has_bxdf(S, BXDF_ROUGH_CONDUCTOR)
    RD = has_bxdf(S, BXDF_ROUGH_DIELECTRIC)
    if RC or RD:
        ks = mat_sample3(
            S, uv, mat["specularity"], mat["specularity_tex"], "specularity"
        )
        alpha = _rough_alpha(S, mat, uv)
        h_refl = V.normalize3(in_dir + out_dir)
        rc_d = ggx_d(alpha, n, h_refl)
        rc_g = ggx_g(alpha, in_dir, out_dir, n, h_refl)
        denom = 4.0 * i_dot_n * o_dot_n
    if RC:
        has_ior = mat["int_ior"] != 0.0
        f_cond = torch.where(
            has_ior,
            V.fresnel_dielectric(mat["ext_ior"], mat["int_ior"], i_dot_n),
            1.0,
        )
        rc_val = V.safe_div(f_cond * rc_d * rc_g, denom, 1e-12)[..., None] * ks
        val = V.where3(t == BXDF_ROUGH_CONDUCTOR, rc_val, val)
    if RD:
        tf = mat_sample3(
            S, uv, mat["transmittance"], mat["transmittance_tex"], "transmittance"
        )
        eta_i, eta_t = _eta_swapped(mat, i_dot_n)
        f_diel = V.fresnel_dielectric(eta_i, eta_t, i_dot_n)
        rd_refl_val = V.safe_div(f_diel * rc_d * rc_g, denom, 1e-12)[
            ..., None
        ] * ks
        h_refr = V.normalize3(
            -(eta_i[..., None] * in_dir + eta_t[..., None] * out_dir)
        )
        i_dot_h = torch.abs(V.dot3(in_dir, h_refr))
        o_dot_h = torch.abs(V.dot3(out_dir, h_refr))
        focus_denom = i_dot_n * o_dot_n * (eta_i * i_dot_h + eta_t * o_dot_h) ** 2
        focus = torch.abs(
            V.safe_div_abs(eta_t * eta_t * i_dot_h * o_dot_h, focus_denom, 1e-12)
        )
        rd_d = ggx_d(alpha, n, h_refr)
        rd_g = ggx_g(alpha, in_dir, out_dir, n, h_refr)
        rd_refr_val = ((1.0 - f_diel) * rd_d * rd_g * focus)[..., None] * tf
        rd_val = V.where3(i_dot_n > 0.0, rd_refl_val, rd_refr_val)
        val = V.where3(t == BXDF_ROUGH_DIELECTRIC, rd_val, val)
    # conductor/dielectric: 0 (see module docstring)
    return val
