"""Scene compiler: RawScene -> SceneData flat arrays.

Counterpart of the reference's ``asset/compiler/compiler.go`` (563 LoC):

  1. material expressions -> material-node list with texture baking, circular
     reference detection, per-material emissive-node DFS, reserved
     ``scene_diffuse_material`` / ``scene_emissive_material`` hookups
     (compiler.go:244-459)
  2. geometry partitioning: TLAS over mesh instances (1 instance/leaf),
     per-mesh BLAS (<=10 tris/leaf) with child-index offsetting into a single
     global node list, flat vertex/normal/uv/material arrays populated inside
     BVH leaf callbacks (compiler.go:81-179); inverse instance transforms
     stored for ray-to-object-space (compiler.go:184-192); per-instance
     emissive-primitive cloning + env-light emissive (compiler.go:194-226)
  3. camera setup (compiler.go:234-241)

Deviations from the reference (documented in docs/parity.md): instances keep
both world->object and object->world matrices so instanced shading and
emissive sampling are correct under non-identity transforms.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ... import types as T
from ...utils.log import Timer, get_logger
from .. import material as M
from ..input_scene import RawScene
from ..resource import Resource
from ..scene_data import AREA_LIGHT, ENVIRONMENT_LIGHT, SceneData
from ..texture import load_texture
from . import bvh

# BLAS leaf size: end-to-end sweep on sphere 512^2@16spp (docs/perf.md):
# 12 -> 46.1, 16 -> 46.7, 24 -> 48.0, 32 -> 48.5, 48 -> 49.1, 64 -> 49.0
# Mrays/s — bigger leaves trade inner-node reduction syncs (the structural
# tax, ~110 ns each) for tier-gated MT vector work the VPU does at ~60% of
# light. Env-tunable for sweeps; the Pallas kernels import this as their
# unroll bound, so kernel and compiler stay consistent within a process.
# NOTE: streamed-leaf DMA windows require MIN_PRIMITIVES_PER_LEAF*12 <=
# STREAM_ALIGN (1024) so a leaf always fits the 2-window staging buffer.
import os as _os  # noqa: E402

MIN_PRIMITIVES_PER_LEAF = int(_os.environ.get("POLARIS_LEAF_SIZE", "48"))
if MIN_PRIMITIVES_PER_LEAF * 12 > 1024:  # holds under `python -O` too
    raise ValueError(
        f"POLARIS_LEAF_SIZE={MIN_PRIMITIVES_PER_LEAF} exceeds the streamed-"
        f"leaf DMA window (need leaf*12 <= 1024)"
    )
SCENE_DIFFUSE_MATERIAL = "scene_diffuse_material"
SCENE_EMISSIVE_MATERIAL = "scene_emissive_material"

_log = get_logger("scene compiler")


class CompileError(ValueError):
    pass


class _MaterialNodes:
    """Growable SoA material-node storage."""

    def __init__(self) -> None:
        self.type: List[int] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.reflectance: List = []
        self.specularity: List = []
        self.transmittance: List = []
        self.radiance: List = []
        self.int_ior: List[float] = []
        self.ext_ior: List[float] = []
        self.scale: List[float] = []
        self.roughness: List[float] = []
        self.mix_weight: List[float] = []
        self.int_disp_ior: List = []
        self.ext_disp_ior: List = []
        self.reflectance_tex: List[int] = []
        self.specularity_tex: List[int] = []
        self.transmittance_tex: List[int] = []
        self.radiance_tex: List[int] = []
        self.roughness_tex: List[int] = []
        self.bump_tex: List[int] = []

    def append(self, **kw) -> int:
        self.type.append(kw.get("type", 0))
        self.left.append(kw.get("left", -1))
        self.right.append(kw.get("right", -1))
        self.reflectance.append(kw.get("reflectance", (0.0, 0.0, 0.0)))
        self.specularity.append(kw.get("specularity", (0.0, 0.0, 0.0)))
        self.transmittance.append(kw.get("transmittance", (0.0, 0.0, 0.0)))
        self.radiance.append(kw.get("radiance", (0.0, 0.0, 0.0)))
        self.int_ior.append(kw.get("int_ior", M.DEFAULT_INT_IOR))
        self.ext_ior.append(kw.get("ext_ior", M.DEFAULT_EXT_IOR))
        self.scale.append(kw.get("scale", 0.0))
        self.roughness.append(kw.get("roughness", 0.0))
        self.mix_weight.append(kw.get("mix_weight", 0.0))
        self.int_disp_ior.append(kw.get("int_disp_ior", (0.0, 0.0, 0.0)))
        self.ext_disp_ior.append(kw.get("ext_disp_ior", (0.0, 0.0, 0.0)))
        self.reflectance_tex.append(kw.get("reflectance_tex", -1))
        self.specularity_tex.append(kw.get("specularity_tex", -1))
        self.transmittance_tex.append(kw.get("transmittance_tex", -1))
        self.radiance_tex.append(kw.get("radiance_tex", -1))
        self.roughness_tex.append(kw.get("roughness_tex", -1))
        self.bump_tex.append(kw.get("bump_tex", -1))
        return len(self.type) - 1


class SceneCompiler:
    def __init__(self, raw: RawScene, float_textures: bool = False) -> None:
        self.raw = raw
        self.float_textures = float_textures
        self.nodes = _MaterialNodes()
        self.mat_index_to_root: Dict[int, int] = {}
        self.tex_cache: Dict[str, int] = {}
        self.emissive_cache: Dict[int, int] = {}
        self.mat_ref_list: List[str] = []
        self.tex_blobs: List[np.ndarray] = []
        self.tex_blobs_u8: List[np.ndarray] = []
        self.tex_meta: List = []  # (offset, width, height, format, store)
        self.tex_cursor = 0
        self.tex_cursor_u8 = 0
        self.scene_diffuse_mat = -1
        self.scene_emissive_mat = -1

    # ----- materials -----

    def _bake_texture(self, mat, tex_path: str) -> int:
        """Load + dedupe a texture into the flat atlas (compiler.go:507-563).

        LDR sources keep BYTE storage (texture_fmt.go:5-10 Luminance8 /
        Rgba8; 4-16x less HBM) unless the scene was compiled with
        ``float_textures=True`` (differentiable-texture training needs the
        atlas as an f32 leaf). ``v*255`` round-trips the loader's ``v/255``
        exactly, so images are bit-identical either way."""
        try:
            res = Resource(tex_path, rel_to=mat.asset_dir)
        except Exception:
            _log.warning("%r: skipping missing texture %r", mat.name, tex_path)
            return -1
        if res.path in self.tex_cache:
            return self.tex_cache[res.path]
        tex = load_texture(res)
        from ..texture import LUMINANCE8, RGBA8

        if not self.float_textures and tex.format in (LUMINANCE8, RGBA8):
            if tex.format == LUMINANCE8:
                src, store = tex.data[..., 0], 2
            else:
                src, store = tex.data, 1
            by = np.clip(np.rint(src * 255.0), 0, 255).astype(np.uint8)
            offset = self.tex_cursor_u8
            self.tex_blobs_u8.append(by.reshape(-1))
            self.tex_cursor_u8 += by.size
        else:
            flat = tex.data.reshape(-1).astype(np.float32)
            offset = self.tex_cursor
            self.tex_blobs.append(flat)
            self.tex_cursor += flat.size
            store = 0
        self.tex_meta.append((offset, tex.width, tex.height, tex.format, store))
        idx = len(self.tex_meta) - 1
        self.tex_cache[res.path] = idx
        return idx

    def _generate_material(self, mat) -> int:
        try:
            expr = M.parse_expression(mat.expression)
            expr.validate()
        except M.MaterialError as exc:
            raise CompileError(f"material {mat.name!r}: {exc}") from None
        self.mat_ref_list.append(mat.name)
        root = self._generate_tree(mat, expr)
        self.mat_ref_list.pop()
        return root

    def _generate_tree(self, mat, node) -> int:
        """Recursive tree flattening (compiler.go:314-459). Children are
        emitted before parents so the root has the highest index."""
        kw: Dict = {}
        if isinstance(node, M.MaterialRefNode):
            if node.name in self.mat_ref_list:
                chain = " -> ".join(self.mat_ref_list + [node.name])
                raise CompileError(
                    f"detected circular dependency loop while processing "
                    f"{self.mat_ref_list[0]!r}; {chain}"
                )
            for other in self.raw.materials:
                if other.name == node.name:
                    return self._generate_material(other)
            raise CompileError(
                f"material {mat.name!r} references undefined material {node.name!r}"
            )
        if isinstance(node, M.BxdfNode):
            kw["type"] = node.bxdf_type
            # bxdf defaults (compiler.go:330-357)
            if node.bxdf_type == M.BXDF_DIFFUSE:
                kw["reflectance"] = M.DEFAULT_REFLECTANCE
            elif node.bxdf_type == M.BXDF_CONDUCTOR:
                kw["specularity"] = M.DEFAULT_SPECULARITY
            elif node.bxdf_type == M.BXDF_DIELECTRIC:
                kw["specularity"] = M.DEFAULT_SPECULARITY
                kw["transmittance"] = M.DEFAULT_TRANSMITTANCE
            elif node.bxdf_type == M.BXDF_ROUGH_CONDUCTOR:
                kw["specularity"] = M.DEFAULT_SPECULARITY
                kw["roughness"] = M.DEFAULT_ROUGHNESS
            elif node.bxdf_type == M.BXDF_ROUGH_DIELECTRIC:
                kw["specularity"] = M.DEFAULT_SPECULARITY
                kw["transmittance"] = M.DEFAULT_TRANSMITTANCE
                kw["roughness"] = M.DEFAULT_ROUGHNESS
            elif node.bxdf_type == M.BXDF_EMISSIVE:
                kw["radiance"] = M.DEFAULT_RADIANCE
                kw["scale"] = M.DEFAULT_RADIANCE_SCALER
            for p in node.params:
                self._apply_param(mat, kw, p)
            return self.nodes.append(**kw)
        if isinstance(node, M.MixNode):
            left = self._generate_tree(mat, node.expressions[0])
            right = self._generate_tree(mat, node.expressions[1])
            return self.nodes.append(
                type=M.OP_MIX, left=left, right=right, mix_weight=node.weight
            )
        if isinstance(node, M.MixMapNode):
            left = self._generate_tree(mat, node.expressions[0])
            right = self._generate_tree(mat, node.expressions[1])
            tex = self._bake_texture(mat, node.texture.path)
            return self.nodes.append(
                type=M.OP_MIX_MAP, left=left, right=right, bump_tex=tex
            )
        if isinstance(node, (M.BumpMapNode, M.NormalMapNode)):
            left = self._generate_tree(mat, node.expression)
            tex = self._bake_texture(mat, node.texture.path)
            op = M.OP_BUMP_MAP if isinstance(node, M.BumpMapNode) else M.OP_NORMAL_MAP
            return self.nodes.append(type=op, left=left, bump_tex=tex)
        if isinstance(node, M.DisperseNode):
            left = self._generate_tree(mat, node.expression)
            return self.nodes.append(
                type=M.OP_DISPERSE,
                left=left,
                int_disp_ior=node.int_ior.value,
                ext_disp_ior=node.ext_ior.value,
            )
        raise CompileError(f"{mat.name!r}: unsupported node {node!r}")

    def _apply_param(self, mat, kw: Dict, p: M.BxdfParamNode) -> None:
        """Apply a bxdf parameter (compiler.go:462-503)."""
        v = p.value
        if p.name in (M.nodes.PARAM_REFLECTANCE, M.nodes.PARAM_SPECULARITY,
                      M.nodes.PARAM_RADIANCE, M.nodes.PARAM_TRANSMITTANCE):
            key = {
                "reflectance": "reflectance",
                "specularity": "specularity",
                "radiance": "radiance",
                "transmittance": "transmittance",
            }[p.name]
            if isinstance(v, M.Vec3Node):
                kw[key] = v.value
            elif isinstance(v, M.TextureNode):
                kw[key + "_tex"] = self._bake_texture(mat, v.path)
        elif p.name in (M.nodes.PARAM_INT_IOR, M.nodes.PARAM_EXT_IOR):
            key = "int_ior" if p.name == M.nodes.PARAM_INT_IOR else "ext_ior"
            if isinstance(v, M.FloatNode):
                kw[key] = v.value
            elif isinstance(v, M.MaterialNameNode):
                kw[key] = M.lookup_ior(v.name)
        elif p.name == M.nodes.PARAM_SCALE:
            kw["scale"] = v.value
        elif p.name == M.nodes.PARAM_ROUGHNESS:
            if isinstance(v, M.FloatNode):
                kw["roughness"] = v.value
            elif isinstance(v, M.TextureNode):
                kw["roughness_tex"] = self._bake_texture(mat, v.path)

    def _find_node_by_bxdf(self, node_index: int, bxdf: int) -> int:
        """DFS for a bxdf node in a layered tree (compiler.go:244-268)."""
        t = self.nodes.type[node_index]
        if M.is_bxdf_type(t):
            return node_index if t == bxdf else -1
        out = self._find_node_by_bxdf(self.nodes.left[node_index], bxdf)
        if out != -1:
            return out
        if t in (M.OP_MIX, M.OP_MIX_MAP) and self.nodes.right[node_index] >= 0:
            return self._find_node_by_bxdf(self.nodes.right[node_index], bxdf)
        return -1

    def compile_materials(self) -> None:
        with Timer() as t:
            for mat_index, mat in enumerate(self.raw.materials):
                if not mat.used:
                    continue
                _log.info("processing material %r", mat.name)
                self.mat_ref_list = []
                root = self._generate_material(mat)
                self.mat_index_to_root[mat_index] = root
                self.emissive_cache[mat_index] = self._find_node_by_bxdf(
                    root, M.BXDF_EMISSIVE
                )
                if mat.name == SCENE_DIFFUSE_MATERIAL:
                    self.scene_diffuse_mat = root
                elif mat.name == SCENE_EMISSIVE_MATERIAL:
                    self.scene_emissive_mat = root
        _log.info(
            "processed %d materials in %.0f ms", len(self.raw.materials), t.ms
        )

    # ----- geometry -----

    def compile(self) -> SceneData:
        self.compile_materials()

        raw = self.raw
        meshes = raw.meshes
        instances = raw.mesh_instances
        if not instances:
            raise CompileError("scene contains no mesh instances")

        with Timer() as timer:
            # --- TLAS over instances: 1 instance per leaf (compiler.go:85-103)
            inst_bounds = [inst.bbox(meshes) for inst in instances]
            tlas_min = np.stack([b[0] for b in inst_bounds])
            tlas_max = np.stack([b[1] for b in inst_bounds])
            tlas_ctr = (tlas_min + tlas_max) * 0.5

            def tlas_leaf(items: np.ndarray):
                # top-level leaf: ldata = -instance_index, rdata = 0
                return -int(items[0]), 0

            tlas = bvh.build(tlas_min, tlas_max, tlas_ctr, 1, tlas_leaf)

            # --- per-mesh BLAS; triangles re-ordered into leaf order ---
            all_min = [tlas.bmin]
            all_max = [tlas.bmax]
            all_ld = [tlas.ldata]
            all_rd = [tlas.rdata]
            node_cursor = len(tlas)

            tri_v0, tri_e1, tri_e2 = [], [], []
            tri_normals, tri_uvs, tri_material = [], [], []
            prim_cursor = 0
            mesh_bvh_roots = []
            # unique emissive primitives per mesh (compiler.go:118-170)
            mesh_emissives: List[dict] = []

            for m_index, mesh in enumerate(meshes):
                t_min, t_max = mesh.tri_bboxes()
                t_ctr = mesh.tri_centers()
                state = {"cursor": prim_cursor}

                def blas_leaf(items: np.ndarray, mesh=mesh, m_index=m_index, state=state):
                    first = state["cursor"]
                    v = mesh.vertices[items]
                    tri_v0.append(v[:, 0])
                    tri_e1.append(v[:, 1] - v[:, 0])
                    tri_e2.append(v[:, 2] - v[:, 0])
                    tri_normals.append(mesh.normals[items])
                    tri_uvs.append(mesh.uvs[items])
                    roots = [
                        self.mat_index_to_root[int(mi)] for mi in mesh.material_index[items]
                    ]
                    tri_material.extend(roots)
                    # emissive primitive detection (compiler.go:152-166)
                    for k, mi in enumerate(mesh.material_index[items]):
                        e_node = self.emissive_cache.get(int(mi), -1)
                        if e_node != -1:
                            vv = v[k]
                            area = 0.5 * float(
                                np.linalg.norm(
                                    np.cross(vv[2] - vv[0], vv[2] - vv[1])
                                )
                            )
                            mesh_emissives.append(
                                {
                                    "mesh": m_index,
                                    "tri": first + k,
                                    "mat": e_node,
                                    "area": area,
                                }
                            )
                    state["cursor"] += int(items.shape[0])
                    # bottom-level leaf: ldata = -first_tri, rdata = count
                    return -first, int(items.shape[0])

                blas = bvh.build(t_min, t_max, t_ctr, MIN_PRIMITIVES_PER_LEAF, blas_leaf)
                prim_cursor = state["cursor"]
                blas.offset_children(node_cursor)
                mesh_bvh_roots.append(node_cursor)
                node_cursor += len(blas)
                all_min.append(blas.bmin)
                all_max.append(blas.bmax)
                all_ld.append(blas.ldata)
                all_rd.append(blas.rdata)

            # --- instances (compiler.go:184-192) ---
            inst_mesh_index = np.array([i.mesh_index for i in instances], np.int32)
            inst_bvh_root = np.array(
                [mesh_bvh_roots[i.mesh_index] for i in instances], np.int32
            )
            inst_o2w = np.stack([i.object_to_world for i in instances]).astype(
                np.float32
            )
            inst_w2o = np.stack(
                [np.linalg.inv(i.object_to_world) for i in instances]
            ).astype(np.float32)

            # --- emissive clones per instance (compiler.go:199-216) ---
            emis = []
            for ii, inst in enumerate(instances):
                for e in mesh_emissives:
                    if e["mesh"] != inst.mesh_index:
                        continue
                    emis.append(
                        {
                            "o2w": inst_o2w[ii],
                            "area": e["area"],
                            "tri": e["tri"],
                            "mat": e["mat"],
                            "type": AREA_LIGHT,
                        }
                    )
            # environment light from scene_emissive_material (compiler.go:219-226)
            if self.scene_emissive_mat != -1:
                # find the material index bound to the scene emissive root
                for mat_index, root in self.mat_index_to_root.items():
                    if root == self.scene_emissive_mat:
                        e_node = self.emissive_cache.get(mat_index, -1)
                        if e_node != -1:
                            emis.append(
                                {
                                    "o2w": np.eye(4, dtype=np.float32),
                                    "area": 0.0,
                                    "tri": 0,
                                    "mat": e_node,
                                    "type": ENVIRONMENT_LIGHT,
                                }
                            )
                        break

            if not emis:
                _log.warning(
                    "the scene contains no emissive primitives or a global "
                    "environment light; output will appear black!"
                )

            n = self.nodes
            # byte-only scene -> the dummy slot joins the byte family so the
            # f32 family stays empty (single-gather fast path)
            _byte_dummy = bool(self.tex_meta) and all(
                m[4] != 0 for m in self.tex_meta
            )
            scene = SceneData(
                bvh_min=np.concatenate(all_min),
                bvh_max=np.concatenate(all_max),
                bvh_ldata=np.concatenate(all_ld),
                bvh_rdata=np.concatenate(all_rd),
                tri_v0=np.concatenate(tri_v0).astype(np.float32),
                tri_e1=np.concatenate(tri_e1).astype(np.float32),
                tri_e2=np.concatenate(tri_e2).astype(np.float32),
                tri_normals=np.concatenate(tri_normals).astype(np.float32),
                tri_uvs=np.concatenate(tri_uvs).astype(np.float32),
                tri_material=np.asarray(tri_material, np.int32),
                inst_mesh_index=inst_mesh_index,
                inst_bvh_root=inst_bvh_root,
                inst_w2o=inst_w2o,
                inst_o2w=inst_o2w,
                emis_o2w=(
                    np.stack([e["o2w"] for e in emis]).astype(np.float32)
                    if emis
                    else np.zeros((0, 4, 4), np.float32)
                ),
                emis_nmat=(
                    np.stack(
                        [np.linalg.inv(e["o2w"][:3, :3]).T for e in emis]
                    ).astype(np.float32)
                    if emis
                    else np.zeros((0, 3, 3), np.float32)
                ),
                emis_area=np.array([e["area"] for e in emis], np.float32),
                emis_tri=np.array([e["tri"] for e in emis], np.int32),
                emis_mat=np.array([e["mat"] for e in emis], np.int32),
                emis_type=np.array([e["type"] for e in emis], np.int32),
                mat_type=np.asarray(n.type, np.int32),
                mat_left=np.asarray(n.left, np.int32),
                mat_right=np.asarray(n.right, np.int32),
                mat_reflectance=np.asarray(n.reflectance, np.float32).reshape(-1, 3),
                mat_specularity=np.asarray(n.specularity, np.float32).reshape(-1, 3),
                mat_transmittance=np.asarray(n.transmittance, np.float32).reshape(-1, 3),
                mat_radiance=np.asarray(n.radiance, np.float32).reshape(-1, 3),
                mat_int_ior=np.asarray(n.int_ior, np.float32),
                mat_ext_ior=np.asarray(n.ext_ior, np.float32),
                mat_scale=np.asarray(n.scale, np.float32),
                mat_roughness=np.asarray(n.roughness, np.float32),
                mat_mix_weight=np.asarray(n.mix_weight, np.float32),
                mat_int_disp_ior=np.asarray(n.int_disp_ior, np.float32).reshape(-1, 3),
                mat_ext_disp_ior=np.asarray(n.ext_disp_ior, np.float32).reshape(-1, 3),
                mat_reflectance_tex=np.asarray(n.reflectance_tex, np.int32),
                mat_specularity_tex=np.asarray(n.specularity_tex, np.int32),
                mat_transmittance_tex=np.asarray(n.transmittance_tex, np.int32),
                mat_radiance_tex=np.asarray(n.radiance_tex, np.int32),
                mat_roughness_tex=np.asarray(n.roughness_tex, np.int32),
                mat_bump_tex=np.asarray(n.bump_tex, np.int32),
                # Always include a 1x1 dummy slot so per-lane gathers with
                # tex_idx = -1 (masked afterwards) stay in bounds. It joins
                # the storage family the scene already uses (ADVICE r4 #3):
                # an all-byte scene would otherwise grow a one-slot f32
                # family and lose the sampler's single-gather fast path
                # (ops/texture.py _nb_fetch).
                tex_data=(
                    np.concatenate(self.tex_blobs + [np.zeros(4, np.float32)])
                    if self.tex_blobs
                    else np.zeros((4,), np.float32)
                ),
                tex_offset=np.array(
                    [m[0] for m in self.tex_meta]
                    + [self.tex_cursor_u8 if _byte_dummy else self.tex_cursor],
                    np.int32,
                ),
                tex_width=np.array([m[1] for m in self.tex_meta] + [1], np.int32),
                tex_height=np.array([m[2] for m in self.tex_meta] + [1], np.int32),
                tex_format=np.array([m[3] for m in self.tex_meta] + [0], np.int32),
                tex_store=np.array(
                    [m[4] for m in self.tex_meta] + [1 if _byte_dummy else 0],
                    np.int32,
                ),
                tex_data_u8=(
                    np.concatenate(
                        self.tex_blobs_u8
                        + ([np.zeros(4, np.uint8)] if _byte_dummy else [])
                    )
                    if self.tex_blobs_u8
                    else np.zeros(0, np.uint8)
                ),
                scene_diffuse_mat=self.scene_diffuse_mat,
                scene_emissive_mat=self.scene_emissive_mat,
                camera_fov=float(raw.camera.fov),
                camera_eye=np.asarray(raw.camera.eye, np.float32),
                camera_look=np.asarray(raw.camera.look, np.float32),
                camera_up=np.asarray(raw.camera.up, np.float32),
            )
        _log.info("compiled scene in %.0f ms", timer.ms)
        return scene


def compile_scene(raw: RawScene, float_textures: bool = False) -> SceneData:
    """Compile a parsed scene into flat device arrays (ref: Compile).

    ``float_textures=True`` stores LDR textures in the float32 atlas
    (differentiable leaf) instead of their native byte storage — required
    when training texture parameters (render/trainer.py)."""
    return SceneCompiler(raw, float_textures=float_textures).compile()
