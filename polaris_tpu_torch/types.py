"""float32 vector/matrix/quaternion helpers shared by the host-side tooling.

TPU-native counterpart of the reference's ``types/`` package
(``types/vector.go``, ``types/matrix.go``, ``types/quaternion.go``). Host code
(scene parsing, compilation, BVH build) uses NumPy float32 throughout; the
device path uses jax.numpy with the same conventions.

Conventions (differ from the reference's column-major go structs, but are
self-consistent across the whole framework):
  * matrices are row-major ``np.ndarray`` of shape (4, 4)
  * points transform as ``(M @ [p, 1])[:3]``; directions as ``M[:3, :3] @ d``
  * instance transforms compose as ``M = T @ R @ S`` (translate last)

The reference's ``Perspective4`` (types/matrix.go:156-161) has a
commented-out degree->radian conversion and therefore treats the FOV in
degrees as radians; we implement the mathematically-correct projection
(see docs/parity.md for the list of deliberate deviations).
"""

from __future__ import annotations

import math

import numpy as np

F = np.float32


def vec3(x, y=None, z=None) -> np.ndarray:
    if y is None:
        return np.asarray(x, dtype=F).reshape(3)
    return np.array([x, y, z], dtype=F)


def normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def perspective(fov_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Right-handed perspective projection (ref: types/matrix.go:156-161)."""
    f = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    nmf = near - far
    m = np.zeros((4, 4), dtype=F)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (near + far) / nmf
    m[2, 3] = (2.0 * far * near) / nmf
    m[3, 2] = -1.0
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """World -> eye transform (ref: types/matrix.go:164-177)."""
    fwd = normalize(np.asarray(center, dtype=F) - np.asarray(eye, dtype=F))
    s = normalize(np.cross(fwd, normalize(np.asarray(up, dtype=F))))
    u = np.cross(s, fwd)
    rot = np.eye(4, dtype=F)
    rot[0, :3] = s
    rot[1, :3] = u
    rot[2, :3] = -fwd
    trans = np.eye(4, dtype=F)
    trans[:3, 3] = -np.asarray(eye, dtype=F)
    return rot @ trans


def translate(t: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[:3, 3] = np.asarray(t, dtype=F)
    return m


def scale(s: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(s, dtype=F)
    return m


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Quaternion (w, x, y, z) for rotation of ``angle`` radians about ``axis``."""
    axis = normalize(np.asarray(axis, dtype=F))
    half = angle / 2.0
    s = math.sin(half)
    return np.array([math.cos(half), axis[0] * s, axis[1] * s, axis[2] * s], dtype=F)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dtype=F,
    )


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    qv = np.array([x, y, z], dtype=F)
    t = 2.0 * np.cross(qv, np.asarray(v, dtype=F))
    return np.asarray(v, dtype=F) + w * t + np.cross(qv, t)


def quat_to_mat4(q: np.ndarray) -> np.ndarray:
    w, x, y, z = quat_normalize(q)
    m = np.eye(4, dtype=F)
    m[0, 0] = 1 - 2 * (y * y + z * z)
    m[0, 1] = 2 * (x * y - w * z)
    m[0, 2] = 2 * (x * z + w * y)
    m[1, 0] = 2 * (x * y + w * z)
    m[1, 1] = 1 - 2 * (x * x + z * z)
    m[1, 2] = 2 * (y * z - w * x)
    m[2, 0] = 2 * (x * z - w * y)
    m[2, 1] = 2 * (y * z + w * x)
    m[2, 2] = 1 - 2 * (x * x + y * y)
    return m


def transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    out = m @ np.array([p[0], p[1], p[2], 1.0], dtype=F)
    return out[:3]


def transform_dir(m: np.ndarray, d: np.ndarray) -> np.ndarray:
    return m[:3, :3] @ np.asarray(d, dtype=F)


def transform_aabb(m: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """Exact AABB of a transformed AABB (all 8 corners).

    The reference only applies the translation component when transforming
    instance bboxes (wavefront.go:511-517) which under-reports rotated/scaled
    bounds; we transform all corners (deviation documented in docs/parity.md).
    """
    pts = []
    for i in range(8):
        p = np.array(
            [
                bmin[0] if i & 1 == 0 else bmax[0],
                bmin[1] if i & 2 == 0 else bmax[1],
                bmin[2] if i & 4 == 0 else bmax[2],
            ],
            dtype=F,
        )
        pts.append(transform_point(m, p))
    pts = np.stack(pts)
    return pts.min(axis=0), pts.max(axis=0)
