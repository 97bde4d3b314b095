"""Layered material tree traversal at shade time.

Counterpart of the reference's ``CL/samplers/material_sampler.cl:21-108``
(matSelectNode): walk the per-surface material tree from its root, resolving

  * MIX        — follow left/right child by a random draw vs mix weight
  * MIX_MAP    — weight sampled from a texture
  * BUMP_MAP / NORMAL_MAP — perturb the shading normal, continue to child
  * DISPERSE   — pick (or reuse, via path flags) an R/G/B channel: tint the
    path with that primary and force per-channel int/ext IORs

TPU-first redesign: instead of a per-thread pointer-chasing while loop, all
lanes advance one tree level per iteration of a fixed ``MAX_MATERIAL_DEPTH``
loop (vectorized gathers per level); lanes already at a leaf hold position.
Random draws use a per-level RNG stream so draw order is deterministic and
backend-independent.
"""

from __future__ import annotations

from . import vec as V
from .texture import tex_bump_sample3, tex_sample1, tex_sample3

OP_MIX = 10001
OP_MIX_MAP = 10002
OP_BUMP_MAP = 10003
OP_NORMAL_MAP = 10004
OP_DISPERSE = 10005

PATH_FLAG_DISPERSE_R = 1
PATH_FLAG_DISPERSE_G = 2
PATH_FLAG_DISPERSE_B = 4

MAX_MATERIAL_DEPTH = 8

MATERIAL_FIELDS = (
    "type",
    "reflectance",
    "specularity",
    "transmittance",
    "radiance",
    "int_ior",
    "ext_ior",
    "scale",
    "roughness",
    "reflectance_tex",
    "specularity_tex",
    "transmittance_tex",
    "radiance_tex",
    "roughness_tex",
)


def gather_material(xp, S, node_idx):
    """Gather per-lane material leaf fields from the SoA node arrays.

    Material tables are almost always tiny, so the lookup is a where-select
    chain instead of a TPU gather (vec.take_small)."""
    return {f: V.take_small(xp, S["mat_" + f], node_idx) for f in MATERIAL_FIELDS}


def apply_normal_map(xp, S, normal, uv, tex_idx):
    """(material_sampler.cl:111-121) R/G in [-1,1], B halved."""
    tu, tv = V.tangent_basis(xp, normal)
    s = tex_sample3(xp, S, uv, tex_idx) * 2.0 - 1.0
    return V.normalize3(
        xp,
        tu * s[..., 0:1] + tv * s[..., 1:2] + 0.5 * normal * s[..., 2:3],
    )


def apply_bump_map(xp, S, normal, uv, tex_idx):
    """(material_sampler.cl:124-131)"""
    tu, tv = V.tangent_basis(xp, normal)
    s = tex_bump_sample3(xp, S, uv, tex_idx) * 2.0 - 1.0
    return V.normalize3(
        xp, tu * s[..., 0:1] + tv * s[..., 1:2] + normal * s[..., 2:3]
    )


def material_tree_depth(mat_type, mat_left, mat_right) -> int:
    """Longest operator chain over all material trees (host-side, static).

    Children are emitted before parents by the compiler, so a single forward
    pass suffices. The result bounds the vectorized walk's iteration count —
    scenes with only leaf materials skip the walk entirely.
    """
    import numpy as np

    m = len(mat_type)
    depth = np.zeros(m, np.int32)
    for i in range(m):
        t = int(mat_type[i])
        if t >= OP_MIX:
            d = depth[mat_left[i]]
            if t in (OP_MIX, OP_MIX_MAP) and mat_right[i] >= 0:
                d = max(d, depth[mat_right[i]])
            depth[i] = d + 1
    return int(depth.max()) if m else 0


def select_material(xp, S, U, root_idx, normal, uv, flags, max_depth=MAX_MATERIAL_DEPTH):
    """Walk the layered material tree for every lane.

    Args:
      U: uniform-draw closure ``U(stream_offset) -> [N] float32``; material
         levels use streams ``STREAM_MAT_MIX + level``.
      root_idx: (N,) int32 root node per lane.
      normal, uv: per-lane shading frame (normal may be perturbed).
      flags: (N,) uint32 path flags (dispersion channel).

    Returns (mat_dict, normal, tint, flags) where mat_dict holds the selected
    leaf fields with dispersion IOR overrides applied
    (material_sampler.cl:91-96: selected IOR = max(node IOR, forced IOR)).
    """
    from .rng import STREAM_DISPERSE, STREAM_MAT_MIX
    from .statics import has_op

    # operator kinds the host proved absent never fire their where-selects,
    # so their (gather/texture-heavy) machinery is dropped at trace time
    MIXMAP = has_op(S, "mixmap")
    BUMP = has_op(S, "bump")
    NORMAL = has_op(S, "normal")
    DISPERSE = has_op(S, "disperse")

    node = root_idx
    tint = xp.ones(normal.shape, normal.dtype)
    force_int = xp.zeros(node.shape, normal.dtype)
    force_ext = xp.zeros(node.shape, normal.dtype)

    for level in range(max_depth):
        t = V.take_small(xp, S["mat_type"], node)
        left = V.take_small(xp, S["mat_left"], node)
        right = V.take_small(xp, S["mat_right"], node)
        is_op = t >= OP_MIX
        u = U(STREAM_MAT_MIX + level)

        # MIX / MIX_MAP: binary choice
        mix_w = V.take_small(xp, S["mat_mix_weight"], node)
        if MIXMAP:
            mix_w = xp.where(
                t == OP_MIX_MAP,
                tex_sample1(xp, S, uv, V.take_small(xp, S["mat_bump_tex"], node)),
                mix_w,
            )
        choose_left = u < mix_w
        mix_next = xp.where(choose_left, left, right)

        # BUMP/NORMAL map: perturb normal, continue left
        if BUMP or NORMAL:
            bump_tex = V.take_small(xp, S["mat_bump_tex"], node)
        if BUMP:
            bumped = apply_bump_map(xp, S, normal, uv, bump_tex)
            normal = V.where3(xp, is_op & (t == OP_BUMP_MAP), bumped, normal)
        if NORMAL:
            normal_mapped = apply_normal_map(xp, S, normal, uv, bump_tex)
            normal = V.where3(
                xp, is_op & (t == OP_NORMAL_MAP), normal_mapped, normal
            )

        # DISPERSE: channel via flags or fresh draw
        # (material_sampler.cl:46-82)
        if DISPERSE:
            du = U(STREAM_DISPERSE + level)
            has_r = (flags & PATH_FLAG_DISPERSE_R) != 0
            has_g = (flags & PATH_FLAG_DISPERSE_G) != 0
            has_b = (flags & PATH_FLAG_DISPERSE_B) != 0
            has_any = has_r | has_g | has_b
            new_r = (~has_any) & (du < 0.333)
            new_g = (~has_any) & (~new_r) & (du < 0.666)
            new_b = (~has_any) & (~new_r) & (~new_g)
            sel_r = has_r | new_r
            sel_g = has_g | new_g
            sel_b = (~sel_r) & (~sel_g) & (has_b | new_b)
            is_disp = is_op & (t == OP_DISPERSE)
            disp_tint = xp.stack(
                [
                    xp.where(sel_r, 1.0, 0.0),
                    xp.where(sel_g, 1.0, 0.0),
                    xp.where(sel_b, 1.0, 0.0),
                ],
                axis=-1,
            ).astype(normal.dtype)
            tint = V.where3(xp, is_disp, disp_tint, tint)
            int_all = V.take_small(xp, S["mat_int_disp_ior"], node)
            ext_all = V.take_small(xp, S["mat_ext_disp_ior"], node)
            # channel select as a 3-way where (no per-lane gather)
            int_d = xp.where(
                sel_r, int_all[..., 0], xp.where(sel_g, int_all[..., 1], int_all[..., 2])
            )
            ext_d = xp.where(
                sel_r, ext_all[..., 0], xp.where(sel_g, ext_all[..., 1], ext_all[..., 2])
            )
            force_int = xp.where(is_disp, int_d, force_int)
            force_ext = xp.where(is_disp, ext_d, force_ext)
            new_flag_bits = xp.where(
                new_r,
                PATH_FLAG_DISPERSE_R,
                xp.where(new_g, PATH_FLAG_DISPERSE_G, PATH_FLAG_DISPERSE_B),
            ).astype(flags.dtype)
            flags = xp.where(is_disp & (~has_any), flags | new_flag_bits, flags)

        # advance
        next_node = xp.where(
            t == OP_MIX,
            mix_next,
            xp.where(t == OP_MIX_MAP, mix_next, left),
        )
        node = xp.where(is_op, next_node, node)

    mat = gather_material(xp, S, node)
    mat = dict(mat)
    if DISPERSE:
        mat["int_ior"] = xp.maximum(mat["int_ior"], force_int)
        mat["ext_ior"] = xp.maximum(mat["ext_ior"], force_ext)
    return mat, normal, tint, flags
