"""Primary ray generation via frustum-corner interpolation.

Counterpart of the reference's ``generatePrimaryRays`` kernel
(``CL/kernels/camera.cl:5-58``): stratified tent-filter jitter in [-0.5, 1.5),
texel uv = (pixel + offset) / frame_dims, direction = normalized bilinear mix
of the 4 frustum corner rays (TL, TR, BL, BR).
"""

from __future__ import annotations

from ..ops import vec as V
from ..ops.rng import STREAM_LENS_U, STREAM_LENS_V


def gen_rays(xp, frustum, eye, width, height, pixel_x, pixel_y, U):
    """Generate per-lane primary rays.

    Args:
      frustum: (4, 3) corner ray basis [TL, TR, BL, BR] (camera.py).
      eye: (3,) camera position.
      pixel_x / pixel_y: [N] integer pixel coordinates (full-frame coords, so
        multi-device blocks pass their global rows — ≙ blockY offsetting).
      U: uniform closure.

    Returns (origin [N,3], dir [N,3]).
    """
    ox = V.tent_filter(xp, U(STREAM_LENS_U))
    oy = V.tent_filter(xp, U(STREAM_LENS_V))
    tx = (pixel_x.astype(ox.dtype) + ox) / width
    ty = (pixel_y.astype(oy.dtype) + oy) / height
    tl, tr, bl, br = frustum[0], frustum[1], frustum[2], frustum[3]
    left = tl[None, :] + (bl - tl)[None, :] * ty[..., None]
    right = tr[None, :] + (br - tr)[None, :] * ty[..., None]
    d = left + (right - left) * tx[..., None]
    d = V.normalize3(xp, d)
    o = xp.broadcast_to(eye, d.shape).astype(d.dtype)
    return o, d
