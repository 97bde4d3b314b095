"""Layered material tree traversal at shade time.

Counterpart of the reference's ``CL/samplers/material_sampler.cl:21-108``
(matSelectNode): walk the per-surface material tree from its root, resolving

  * MIX        — follow left/right child by a random draw vs mix weight
  * MIX_MAP    — weight sampled from a texture
  * BUMP_MAP / NORMAL_MAP — perturb the shading normal, continue to child
  * DISPERSE   — pick (or reuse, via path flags) an R/G/B channel: tint the
    path with that primary and force per-channel int/ext IORs

All lanes advance one tree level per iteration of a fixed-depth loop
(vectorized gathers per level); lanes already at a leaf hold position.
Random draws use a per-level RNG stream so draw order is deterministic.

MIX_MAP, BUMP_MAP and NORMAL_MAP read the texture atlas through
``ops/texture.py`` (``tex_sample1`` for the mix weight, ``tex_bump_sample3``
and ``tex_sample3`` for the perturbed normal); a scene without such a node
skips their branches (ops/statics.py).
"""

from __future__ import annotations

import numpy as np
import torch

from . import vec as V
from .statics import has_op
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


def gather_material(S, node_idx):
    """Gather per-lane material leaf fields from the SoA node arrays."""
    return {f: V.take_small(S["mat_" + f], node_idx) for f in MATERIAL_FIELDS}


def apply_normal_map(S, normal, uv, tex_idx):
    """(material_sampler.cl:111-121) R/G in [-1,1], B halved."""
    tu, tv = V.tangent_basis(normal)
    s = tex_sample3(S, uv, tex_idx) * 2.0 - 1.0
    return V.normalize3(
        tu * s[..., 0:1] + tv * s[..., 1:2] + 0.5 * normal * s[..., 2:3],
    )


def apply_bump_map(S, normal, uv, tex_idx):
    """(material_sampler.cl:124-131)"""
    tu, tv = V.tangent_basis(normal)
    s = tex_bump_sample3(S, uv, tex_idx) * 2.0 - 1.0
    return V.normalize3(tu * s[..., 0:1] + tv * s[..., 1:2] + normal * s[..., 2:3])


def material_tree_depth(mat_type, mat_left, mat_right) -> int:
    """Longest operator chain over all material trees (host-side, static).

    Children are emitted before parents by the compiler, so a single forward
    pass suffices. The result bounds the vectorized walk's iteration count —
    scenes with only leaf materials skip the walk entirely.
    """
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


def select_material(S, U, root_idx, normal, uv, flags, max_depth=MAX_MATERIAL_DEPTH,
                    tex_ops=False):
    """Walk the layered material tree for every lane.

    Args:
      U: uniform-draw closure ``U(stream_offset) -> [N] float32``; material
         levels use streams ``STREAM_MAT_MIX + level``.
      root_idx: (N,) integer root node per lane.
      normal, uv: per-lane shading frame (normal may be perturbed).
      flags: (N,) int32 path flags (dispersion channel).

    Returns (mat_dict, normal, tint, flags) where mat_dict holds the selected
    leaf fields with dispersion IOR overrides applied
    (material_sampler.cl:91-96: selected IOR = max(node IOR, forced IOR)).
    ``tex_ops``: also return, last, whether each lane's walk passed a node
    that samples a texture (mixMap, bumpMap, normalMap), for the shading
    census (utils/profiling.py).
    """
    from .rng import STREAM_DISPERSE, STREAM_MAT_MIX

    # operator kinds the host proved absent never fire their selects, so
    # their machinery is skipped
    MIXMAP = has_op(S, "mixmap")
    BUMP = has_op(S, "bump")
    NORMAL = has_op(S, "normal")
    DISPERSE = has_op(S, "disperse")

    node = root_idx.long()
    tint = torch.ones_like(normal)
    force_int = torch.zeros(node.shape, dtype=normal.dtype, device=normal.device)
    force_ext = torch.zeros_like(force_int)
    tex_op = torch.zeros(node.shape, dtype=torch.bool, device=node.device) if tex_ops else None

    for level in range(max_depth):
        t = S["mat_type"][node]
        left = S["mat_left"][node].long()
        right = S["mat_right"][node].long()
        is_op = t >= OP_MIX
        if tex_ops:
            tex_op = tex_op | (
                is_op & ((t == OP_MIX_MAP) | (t == OP_BUMP_MAP) | (t == OP_NORMAL_MAP))
            )
        u = U(STREAM_MAT_MIX + level)

        # MIX / MIX_MAP: binary choice
        mix_w = V.take_small(S["mat_mix_weight"], node)
        if MIXMAP:
            mix_w = torch.where(
                t == OP_MIX_MAP,
                tex_sample1(S, uv, S["mat_bump_tex"][node]),
                mix_w,
            )
        choose_left = u < mix_w
        mix_next = torch.where(choose_left, left, right)

        # BUMP/NORMAL map: perturb normal, continue left
        if BUMP or NORMAL:
            bump_tex = S["mat_bump_tex"][node]
        if BUMP:
            bumped = apply_bump_map(S, normal, uv, bump_tex)
            normal = V.where3(is_op & (t == OP_BUMP_MAP), bumped, normal)
        if NORMAL:
            normal_mapped = apply_normal_map(S, normal, uv, bump_tex)
            normal = V.where3(is_op & (t == OP_NORMAL_MAP), normal_mapped, normal)

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
            disp_tint = torch.stack([sel_r, sel_g, sel_b], dim=-1).to(normal.dtype)
            tint = V.where3(is_disp, disp_tint, tint)
            int_all = V.take_small(S["mat_int_disp_ior"], node)
            ext_all = V.take_small(S["mat_ext_disp_ior"], node)
            int_d = torch.where(
                sel_r,
                int_all[..., 0],
                torch.where(sel_g, int_all[..., 1], int_all[..., 2]),
            )
            ext_d = torch.where(
                sel_r,
                ext_all[..., 0],
                torch.where(sel_g, ext_all[..., 1], ext_all[..., 2]),
            )
            force_int = torch.where(is_disp, int_d, force_int)
            force_ext = torch.where(is_disp, ext_d, force_ext)
            new_flag_bits = torch.where(
                new_r,
                PATH_FLAG_DISPERSE_R,
                torch.where(new_g, PATH_FLAG_DISPERSE_G, PATH_FLAG_DISPERSE_B),
            ).to(flags.dtype)
            flags = torch.where(is_disp & (~has_any), flags | new_flag_bits, flags)

        # advance
        next_node = torch.where(
            (t == OP_MIX) | (t == OP_MIX_MAP), mix_next, left
        )
        node = torch.where(is_op, next_node, node)

    mat = gather_material(S, node)
    if DISPERSE:
        mat["int_ior"] = torch.maximum(mat["int_ior"], force_int)
        mat["ext_ior"] = torch.maximum(mat["ext_ior"], force_ext)
    if tex_ops:
        return mat, normal, tint, flags, tex_op
    return mat, normal, tint, flags
