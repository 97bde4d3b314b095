"""Small backend-generic (NumPy / jax.numpy) vector helpers.

Every function takes the array module ``xp`` first so the exact same code
runs inside jitted JAX integrators and the NumPy golden renderer.
"""

from __future__ import annotations

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI

# Intersection constants (ref: CL/constants.cl:22-27)
INTERSECTION_EPSILON = 1e-5
INTERSECTION_WITH_LIGHT_EPSILON = INTERSECTION_EPSILON * 1e3
MIN_ROUGHNESS = 0.1
FLT_MAX = 3.4028235e38


def safe_div(xp, num, den, thresh):
    """``num/den`` where ``den > thresh``, else 0 — with the double-where
    trick so the untaken branch contributes neither NaN nor overflowing
    gradients (1/den^2 in f32 overflows for den < ~1e-19; masking *after*
    the division is not enough because reverse-mode still differentiates the
    division)."""
    ok = den > thresh
    return xp.where(ok, num / xp.where(ok, den, 1.0), zeros_like_maybe(xp, num))


def safe_div_abs(xp, num, den, thresh):
    """Like safe_div but for signed denominators: valid where |den| > thresh."""
    ok = xp.abs(den) > thresh
    return xp.where(ok, num / xp.where(ok, den, 1.0), zeros_like_maybe(xp, num))


def zeros_like_maybe(xp, x):
    return xp.zeros_like(x)


def take_small(xp, table, idx, max_rows=32):
    """``table[idx]`` that avoids per-lane gathers for small tables.

    XLA lowers a per-lane gather to ~1 element/cycle on the TPU scalar
    units; for a table with few rows an unrolled where-select chain is pure
    fused VPU work — exact (each lane still receives precisely its row, so
    values AND gradients are identical) and ~10x cheaper at 512^2. Falls
    back to plain indexing for big tables and for the NumPy oracle.
    """
    rows = int(table.shape[0])
    if xp.__name__ != "jax.numpy" or rows > max_rows or rows == 0:
        return table[idx]
    expand = (...,) + (None,) * (table.ndim - 1)
    out = xp.broadcast_to(table[0], idx.shape + table.shape[1:])
    for m in range(1, rows):
        out = xp.where((idx == m)[expand], table[m], out)
    return out


def dot3(xp, a, b):
    return xp.sum(a * b, axis=-1)


def cross3(xp, a, b):
    return xp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def normalize3(xp, v, eps=1e-20):
    n = xp.sqrt(xp.maximum(dot3(xp, v, v), eps))
    return v / n[..., None]


def vlen3(xp, v):
    return xp.sqrt(dot3(xp, v, v))


def maxcomp3(xp, v):
    return xp.maximum(v[..., 0], xp.maximum(v[..., 1], v[..., 2]))


def luminance(xp, v):
    """Rec.709 luma (ref: pt_integrator.cl:116)."""
    return 0.2126 * v[..., 0] + 0.7152 * v[..., 1] + 0.0722 * v[..., 2]


def where3(xp, mask, a, b):
    return xp.where(mask[..., None], a, b)


def tangent_basis(xp, n):
    """Tangent/bitangent frame (ref: CL/util/surface.cl:4-6 TANGENT_VECTORS).

    u = normalize(cross(|n.z|<.999 ? (0,0,1) : (1,0,0), n)); v = cross(n, u)
    """
    use_z = xp.abs(n[..., 2]) < 0.999
    ref = xp.stack(
        [
            xp.where(use_z, 0.0, 1.0),
            xp.zeros_like(n[..., 0]),
            xp.where(use_z, 1.0, 0.0),
        ],
        axis=-1,
    )
    u = normalize3(xp, cross3(xp, ref, n))
    v = cross3(xp, n, u)
    return u, v


def transform_point(xp, m, p):
    """Apply [..., 4, 4] matrices to [..., 3] points (w=1)."""
    return dot3(xp, m[..., :3, :3], p[..., None, :]) + m[..., :3, 3]


def transform_dir(xp, m, d):
    """Apply the rotation part of [..., 4, 4] matrices to [..., 3] dirs."""
    return dot3(xp, m[..., :3, :3], d[..., None, :])


def transform_normal(xp, w2o, n):
    """Normals transform by (o2w^-1)^T = w2o^T."""
    return dot3(xp, xp.swapaxes(w2o[..., :3, :3], -1, -2), n[..., None, :])


def ray_to_latlong_uv(xp, d):
    """Direction -> lat-long uv (ref: CL/util/transform.cl rayToLatLongUV).

    Inputs to arccos/arctan2 are nudged off their singular points: exactly
    axis-aligned directions otherwise produce infinite derivatives that
    poison gradients through zero-cotangent chains (NaN = 0 * inf).
    """
    x, z = d[..., 0], d[..., 2]
    z_safe = xp.where((x == 0.0) & (z == 0.0), 1e-12, z)
    at2 = xp.arctan2(x, z_safe)
    at2 = xp.where(at2 >= 0.0, at2, at2 + TWO_PI)
    r = vlen3(xp, d)
    c = xp.clip(d[..., 1] / xp.maximum(r, 1e-20), -1.0 + 1e-7, 1.0 - 1e-7)
    v = xp.arccos(c) / PI
    return xp.stack([at2 / TWO_PI, v], axis=-1)


def reflect(xp, in_dir, n):
    """Reflect an *outward-pointing* in_dir about n (conductor.cl:18)."""
    return 2.0 * dot3(xp, in_dir, n)[..., None] * n - in_dir


def tent_filter(xp, s):
    """Map uniform [0,1) to tent-filtered [-0.5, 1.5) (camera.cl:40-43)."""
    return xp.where(
        s < 0.5,
        xp.sqrt(xp.maximum(2.0 * s, 0.0)) - 0.5,
        1.5 - xp.sqrt(xp.maximum(2.0 - 2.0 * s, 0.0)),
    )


def fresnel_dielectric(xp, eta_i, eta_t, i_dot_n):
    """Schlick approximation (ref: CL/util/fresnel.cl:8-17).

    Division guarded for lanes whose material has no IOR (conductor with
    intIOR 0) — those lanes mask the result out but must stay NaN-free so
    gradients don't poison the batch.
    """
    eta = eta_i / xp.where(eta_t == 0.0, 1.0, eta_t)
    r0 = ((1.0 - eta) ** 2) / ((1.0 + eta) ** 2)
    c = 1.0 - xp.abs(i_dot_n)
    return r0 + (1.0 - r0) * c * c * c * c * c


def fresnel_conductor_exact(xp, cos_i, eta, k):
    """Exact unpolarized conductor Fresnel with complex IOR eta - i*k
    (ref: CL/util/fresnel.cl:20-29 — defined there but unused by the
    built-in bxdfs; provided for parity and for spectral material work).
    """
    c2 = cos_i * cos_i
    s2 = 1.0 - c2
    e2, k2 = eta * eta, k * k
    t0 = e2 - k2 - s2
    a2b2 = xp.sqrt(xp.maximum(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + c2
    a = xp.sqrt(xp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * cos_i
    rs = safe_div(xp, t1 - t2, t1 + t2, 1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * safe_div(xp, t3 - t4, t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


def cos_weighted_hemisphere(xp, n, u1, u2):
    """Cosine-weighted hemisphere sample (distribution_sampler.cl:100-112)."""
    rd = xp.sqrt(xp.maximum(u1, 0.0))
    phi = TWO_PI * u2
    tu, tv = tangent_basis(xp, n)
    return normalize3(
        xp,
        tu * (rd * xp.cos(phi))[..., None]
        + tv * (rd * xp.sin(phi))[..., None]
        + n * xp.sqrt(xp.maximum(1.0 - u1, 0.0))[..., None],
    )
