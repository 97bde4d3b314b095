"""Compiled, device-ready scene: flat SoA arrays + npz save/load + stats.

Counterpart of the reference's ``asset/scene/optimized_scene.go:167-242``
(the GPU-ready struct uploaded verbatim) and the gob-in-zip scene artifact
(``asset/scene/writer/zip.go:31-56`` / ``reader/zip.go:32-71``).

TPU-first redesign: instead of byte-union AoS structs that must match OpenCL
struct layouts byte-for-byte (CL/types.cl:4-188), the scene is a pytree of
flat SoA NumPy/jnp arrays:

  * BVH as (bmin[N,3], bmax[N,3], ldata[N], rdata[N]) with the reference's
    index encoding (leaf <=> ldata<=0; TLAS leaf stores -instance, BLAS leaf
    stores -first_tri with rdata=count) (optimized_scene.go:14-75)
  * triangles as v0/e1/e2 (precomputed Moller-Trumbore operands) plus
    per-vertex normal/uv arrays in BVH-leaf order
  * materials as explicit named fields instead of unions
    (optimized_scene.go:82-110) so colors/IORs/roughness are differentiable
    leaves
  * one flat float32 RGBA texture atlas + (offset,width,height) metadata
  * mesh instances carry world->object (traversal) and object->world
    (shading) matrices; emissives carry object->world
    (optimized_scene.go:113-152)

``split_params()`` partitions the pytree into non-differentiable geometry and
differentiable parameters for the gradient path.
"""

from __future__ import annotations

import io
import zipfile
from dataclasses import dataclass, field, fields
from typing import Dict, Tuple

import numpy as np

from ..utils.log import get_logger

_log = get_logger("scene")

AREA_LIGHT = 0
ENVIRONMENT_LIGHT = 1

# Differentiable material/texture/camera leaves.
PARAM_FIELDS = (
    "mat_reflectance",
    "mat_specularity",
    "mat_transmittance",
    "mat_radiance",
    "mat_int_ior",
    "mat_ext_ior",
    "mat_scale",
    "mat_roughness",
    "mat_mix_weight",
    "mat_int_disp_ior",
    "mat_ext_disp_ior",
    "tex_data",
)


@dataclass
class SceneData:
    # --- BVH (two-level; TLAS first, per-mesh BLAS appended with offsets) ---
    bvh_min: np.ndarray  # (N, 3) f32
    bvh_max: np.ndarray  # (N, 3) f32
    bvh_ldata: np.ndarray  # (N,) i32
    bvh_rdata: np.ndarray  # (N,) i32

    # --- triangles, in BVH leaf order (T = total triangles) ---
    tri_v0: np.ndarray  # (T, 3) f32
    tri_e1: np.ndarray  # (T, 3) f32  v1 - v0
    tri_e2: np.ndarray  # (T, 3) f32  v2 - v0
    tri_normals: np.ndarray  # (T, 3, 3) f32 per-vertex normals
    tri_uvs: np.ndarray  # (T, 3, 2) f32 per-vertex uvs
    tri_material: np.ndarray  # (T,) i32 root material-node index

    # --- mesh instances ---
    inst_mesh_index: np.ndarray  # (I,) i32
    inst_bvh_root: np.ndarray  # (I,) i32
    inst_w2o: np.ndarray  # (I, 4, 4) f32 world -> object
    inst_o2w: np.ndarray  # (I, 4, 4) f32 object -> world

    # --- emissive primitives ---
    emis_o2w: np.ndarray  # (E, 4, 4) f32
    emis_nmat: np.ndarray  # (E, 3, 3) f32 inverse-transpose for normals
    emis_area: np.ndarray  # (E,) f32
    emis_tri: np.ndarray  # (E,) i32
    emis_mat: np.ndarray  # (E,) i32
    emis_type: np.ndarray  # (E,) i32 AREA_LIGHT | ENVIRONMENT_LIGHT

    # --- material nodes (SoA; type ids shared with the reference) ---
    mat_type: np.ndarray  # (M,) i32 bxdf bit or op id
    mat_left: np.ndarray  # (M,) i32
    mat_right: np.ndarray  # (M,) i32
    mat_reflectance: np.ndarray  # (M, 3) f32
    mat_specularity: np.ndarray  # (M, 3) f32
    mat_transmittance: np.ndarray  # (M, 3) f32
    mat_radiance: np.ndarray  # (M, 3) f32
    mat_int_ior: np.ndarray  # (M,) f32
    mat_ext_ior: np.ndarray  # (M,) f32
    mat_scale: np.ndarray  # (M,) f32
    mat_roughness: np.ndarray  # (M,) f32
    mat_mix_weight: np.ndarray  # (M,) f32
    mat_int_disp_ior: np.ndarray  # (M, 3) f32
    mat_ext_disp_ior: np.ndarray  # (M, 3) f32
    mat_reflectance_tex: np.ndarray  # (M,) i32 (-1 = none)
    mat_specularity_tex: np.ndarray
    mat_transmittance_tex: np.ndarray
    mat_radiance_tex: np.ndarray
    mat_roughness_tex: np.ndarray
    mat_bump_tex: np.ndarray  # bump/normal/mix-weight texture slot
    # --- texture atlas ---
    tex_data: np.ndarray  # (K,) f32 flat RGBA rows
    tex_offset: np.ndarray  # (Tx,) i32 float offsets into tex_data
    tex_width: np.ndarray  # (Tx,) i32
    tex_height: np.ndarray  # (Tx,) i32
    tex_format: np.ndarray  # (Tx,) i32 provenance tag

    # --- scene-global material hookups (-1 = none) ---
    scene_diffuse_mat: int = -1
    scene_emissive_mat: int = -1

    # --- camera ---
    camera_fov: float = 45.0
    camera_eye: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    camera_look: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, -1], np.float32)
    )
    camera_up: np.ndarray = field(
        default_factory=lambda: np.array([0, 1, 0], np.float32)
    )

    # --- byte texture storage (ref: texture_fmt.go:5-10) ---
    # LDR sources keep their byte storage (Rgba8 interleaved / Luminance8
    # single channel) and dequantize on sample — 4-16x less HBM than the
    # float atlas for the same texels. Float sources (EXR/HDR/F-mode) and
    # scenes compiled with float_textures=True (differentiable-texture
    # training) stay in ``tex_data``. tex_store: 0 = f32, 1 = rgba8,
    # 2 = luminance8 (offsets index the matching array).
    tex_store: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    tex_data_u8: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint8)
    )

    # ----- stats (ref: optimized_scene.go:193-242) -----

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.bvh_ldata.shape[0])

    def stats(self) -> Dict[str, Tuple[int, int]]:
        """(count, bytes) per component, for the `scene info` table."""

        def nb(*arrs):
            return sum(int(a.nbytes) for a in arrs)

        return {
            "BVH nodes": (self.num_nodes, nb(self.bvh_min, self.bvh_max, self.bvh_ldata, self.bvh_rdata)),
            "Triangles": (self.num_triangles, nb(self.tri_v0, self.tri_e1, self.tri_e2)),
            "Vertex attributes": (self.num_triangles * 3, nb(self.tri_normals, self.tri_uvs)),
            "Material indices": (self.num_triangles, nb(self.tri_material)),
            "Mesh instances": (int(self.inst_bvh_root.shape[0]), nb(self.inst_w2o, self.inst_o2w, self.inst_bvh_root, self.inst_mesh_index)),
            "Emissive primitives": (int(self.emis_area.shape[0]), nb(self.emis_o2w, self.emis_area, self.emis_tri, self.emis_mat, self.emis_type)),
            "Material nodes": (int(self.mat_type.shape[0]), nb(self.mat_type, self.mat_left, self.mat_right, self.mat_reflectance, self.mat_specularity, self.mat_transmittance, self.mat_radiance)),
            "Textures": (
                int(self.tex_offset.shape[0]),
                nb(self.tex_data, self.tex_data_u8),
            ),
        }

    # ----- persistence (≙ compiled-scene zip artifact) -----

    def save(self, path: str) -> None:
        """Serialize to a compressed npz-in-zip artifact (`scene compile`)."""
        arrays = {}
        scalars = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                arrays[f.name] = v
            else:
                scalars[f.name] = v
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
            zf.writestr("scene.npz", buf.getvalue())
            zf.writestr("scene.json", _json_dumps(scalars))
        _log.info("wrote compiled scene to %s", path)

    @classmethod
    def load(cls, path: str) -> "SceneData":
        with zipfile.ZipFile(path, "r") as zf:
            npz = np.load(io.BytesIO(zf.read("scene.npz")))
            scalars = _json_loads(zf.read("scene.json").decode())
        kwargs = {k: npz[k] for k in npz.files}
        for k, v in scalars.items():
            if k in ("camera_eye", "camera_look", "camera_up"):
                v = np.asarray(v, np.float32)
            kwargs[k] = v
        return cls(**kwargs)

    # ----- device pytree split -----

    def split_params(self):
        """Return (geometry_dict, params_dict) of NumPy arrays.

        ``params`` holds every differentiable leaf (material fields + texture
        atlas); ``geometry`` holds everything else the integrator needs.
        """
        geom = {}
        params = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, np.ndarray):
                continue
            (params if f.name in PARAM_FIELDS else geom)[f.name] = v
        # jit-static specialization sidecar (zero-leaf pytree node): lets the
        # shading code drop texture/BxDF/operator branches the scene cannot
        # reach (ops/statics.py). Consumers converting values to device
        # arrays must skip keys starting with "_".
        from ..ops.statics import Static, scene_statics

        geom["_stx"] = scene_statics(self)
        # host-static texture table (offset, width, height per texture):
        # lets the texture sampler resolve per-lane table lookups as cheap
        # where-selects and build its single-lookup neighborhood atlas with
        # static shapes (ops/texture.py) — zero-leaf pytree node, jit-static
        n_tex = int(self.tex_offset.shape[0])
        store = (
            self.tex_store
            if self.tex_store.shape[0] == n_tex
            else np.zeros(n_tex, np.int32)  # pre-round-4 artifacts: all f32
        )
        geom["_tex_meta"] = Static(
            tex=tuple(
                (int(o), int(w), int(h), int(s))
                for o, w, h, s in zip(
                    self.tex_offset, self.tex_width, self.tex_height, store
                )
            )
        )
        return geom, params


def _json_dumps(scalars: dict) -> str:
    import json

    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        raise TypeError(type(o))

    return json.dumps(scalars, default=default)


def _json_loads(s: str) -> dict:
    import json

    return json.loads(s)
