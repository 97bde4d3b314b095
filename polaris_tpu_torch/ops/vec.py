"""Small PyTorch vector helpers shared by shading and traversal.

Counterpart of the JAX package's ``ops/vec.py`` without the array-module
argument: every function takes and returns tensors on the caller's device.
K=3 contractions are written as explicit multiply+add (never ``@`` or
``einsum``), so the float association is fixed and visible.
"""

from __future__ import annotations

import torch

from . import table_grad_cuda

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI

# Intersection constants (ref: CL/constants.cl:22-27)
INTERSECTION_EPSILON = 1e-5
INTERSECTION_WITH_LIGHT_EPSILON = INTERSECTION_EPSILON * 1e3
MIN_ROUGHNESS = 0.1
FLT_MAX = 3.4028234663852886e38  # float32 max (3.4028235e38 rounded to f32)


def safe_div(num, den, thresh):
    """``num/den`` where ``den > thresh``, else 0 — with the double-where
    trick so the untaken branch contributes neither NaN nor overflowing
    gradients."""
    ok = den > thresh
    return torch.where(ok, num / torch.where(ok, den, 1.0), torch.zeros_like(num))


def safe_div_abs(num, den, thresh):
    """Like safe_div but for signed denominators: valid where |den| > thresh."""
    ok = torch.abs(den) > thresh
    return torch.where(ok, num / torch.where(ok, den, 1.0), torch.zeros_like(num))


def take_small(table, idx):
    """``table[idx]`` for an index tensor of any integer dtype and shape.

    Through ``index_select``, not ``table[idx]``, whose gradient
    (``index_put_``) sorts the indices and adds each run of equal ones
    serially. ``index_select``'s own gradient, ``index_add_``, adds with
    atomics, which contend where every lane reads one of a few rows (a
    material field). So where autograd records the gather of a small float32
    table on a card, its gradient is summed by ``csrc/table_grad.cu``
    instead, in a fixed order; every other gather keeps ``index_select`` and
    its ``index_add_`` (``table_grad_cuda.route``).
    """
    rows = table_grad_cuda.take(table, idx.reshape(-1).long())
    return rows.reshape(*idx.shape, *table.shape[1:])


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def normalize3(v, eps=1e-20):
    n = torch.sqrt(torch.clamp(dot3(v, v), min=eps))
    return v / n[..., None]


def vlen3(v):
    return torch.sqrt(dot3(v, v))


def maxcomp3(v):
    return torch.maximum(v[..., 0], torch.maximum(v[..., 1], v[..., 2]))


def luminance(v):
    """Rec.709 luma (ref: pt_integrator.cl:116)."""
    return 0.2126 * v[..., 0] + 0.7152 * v[..., 1] + 0.0722 * v[..., 2]


def where3(mask, a, b):
    return torch.where(mask[..., None], a, b)


def tangent_basis(n):
    """Tangent/bitangent frame (ref: CL/util/surface.cl:4-6 TANGENT_VECTORS).

    u = normalize(cross(|n.z|<.999 ? (0,0,1) : (1,0,0), n)); v = cross(n, u)
    """
    use_z = torch.abs(n[..., 2]) < 0.999
    zero = torch.zeros_like(n[..., 0])
    one = torch.ones_like(zero)
    ref = torch.stack(
        [torch.where(use_z, zero, one), zero, torch.where(use_z, one, zero)],
        dim=-1,
    )
    u = normalize3(cross3(ref, n))
    v = cross3(n, u)
    return u, v


def transform_point(m, p):
    """Apply [..., 4, 4] matrices to [..., 3] points (w=1)."""
    return dot3(m[..., :3, :3], p[..., None, :]) + m[..., :3, 3]


def transform_dir(m, d):
    """Apply the rotation part of [..., 4, 4] matrices to [..., 3] dirs."""
    return dot3(m[..., :3, :3], d[..., None, :])


def transform_normal(w2o, n):
    """Normals transform by (o2w^-1)^T = w2o^T."""
    return dot3(w2o[..., :3, :3].transpose(-1, -2), n[..., None, :])


def ray_to_latlong_uv(d):
    """Direction -> lat-long uv (ref: CL/util/transform.cl rayToLatLongUV).

    Inputs to arccos/arctan2 are nudged off their singular points: exactly
    axis-aligned directions otherwise produce infinite derivatives.
    """
    x, z = d[..., 0], d[..., 2]
    z_safe = torch.where((x == 0.0) & (z == 0.0), 1e-12, z)
    at2 = torch.atan2(x, z_safe)
    at2 = torch.where(at2 >= 0.0, at2, at2 + TWO_PI)
    r = vlen3(d)
    c = torch.clamp(d[..., 1] / torch.clamp(r, min=1e-20), -1.0 + 1e-7, 1.0 - 1e-7)
    v = torch.acos(c) / PI
    return torch.stack([at2 / TWO_PI, v], dim=-1)


def reflect(in_dir, n):
    """Reflect an *outward-pointing* in_dir about n (conductor.cl:18)."""
    return 2.0 * dot3(in_dir, n)[..., None] * n - in_dir


def tent_filter(s):
    """Map uniform [0,1) to tent-filtered [-0.5, 1.5) (camera.cl:40-43)."""
    return torch.where(
        s < 0.5,
        torch.sqrt(torch.clamp(2.0 * s, min=0.0)) - 0.5,
        1.5 - torch.sqrt(torch.clamp(2.0 - 2.0 * s, min=0.0)),
    )


def fresnel_dielectric(eta_i, eta_t, i_dot_n):
    """Schlick approximation (ref: CL/util/fresnel.cl:8-17).

    Division guarded for lanes whose material has no IOR (conductor with
    intIOR 0) — those lanes mask the result out but must stay NaN-free.
    """
    eta = eta_i / torch.where(eta_t == 0.0, 1.0, eta_t)
    r0 = ((1.0 - eta) ** 2) / ((1.0 + eta) ** 2)
    c = 1.0 - torch.abs(i_dot_n)
    return r0 + (1.0 - r0) * c * c * c * c * c


def cos_weighted_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere sample (distribution_sampler.cl:100-112)."""
    rd = torch.sqrt(torch.clamp(u1, min=0.0))
    phi = TWO_PI * u2
    tu, tv = tangent_basis(n)
    return normalize3(
        tu * (rd * torch.cos(phi))[..., None]
        + tv * (rd * torch.sin(phi))[..., None]
        + n * torch.sqrt(torch.clamp(1.0 - u1, min=0.0))[..., None],
    )
