"""Wavefront .obj / .mtl scene reader with the polaris extensions.

Counterpart of the reference's ``asset/scene/reader/wavefront.go`` (830 LoC):
  * v/vn/vt/f (tri + quad, negative & 1-based relative indices)
    (wavefront.go:542-648,766-782)
  * g/o object groups, usemtl, mtllib/call recursive includes with an
    error-context stack (wavefront.go:328-351,260-288)
  * camera extensions camera_fov/eye/look/up (wavefront.go:406-425)
  * ``instance name tX tY tZ yaw pitch roll sX sY sZ`` -> M = T*R*S
    (wavefront.go:454-526; we apply the full matrix to the instance AABB,
    see docs/parity.md)
  * .mtl attributes: newmtl, Kd/Ks/Ke/Tf/Ni, map_Kd/Ks/Ke/Tf/bump/normal,
    include, KeScaler, mat_expr (wavefront.go:651-761)
  * auto-generated material expressions from classic mtl attributes
    (Ks&Ni -> dielectric, Ks -> conductor, Ke -> emissive, else diffuse;
    normal/bump wrap) (wavefront.go:58-125)
  * default gray material (Kd 0.7), default identity instances, unused
    material pruning with lazily-referenced expressions appended at the end
    (wavefront.go:192-304)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import types as T
from ..utils.log import Timer, get_logger
from .input_scene import Material, Mesh, MeshInstance, RawScene
from .resource import Resource

SCENE_DIFFUSE_MATERIAL = "scene_diffuse_material"
SCENE_EMISSIVE_MATERIAL = "scene_emissive_material"


class WavefrontError(ValueError):
    pass


@dataclass
class _WfMaterial:
    """Classic .mtl attributes + polaris extensions (wavefront.go:20-54)."""

    name: str = ""
    kd: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ks: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ke: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ke_scaler: float = 0.0
    tf: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ni: float = 0.0
    kd_tex: str = ""
    ks_tex: str = ""
    ke_tex: str = ""
    tf_tex: str = ""
    bump_tex: str = ""
    normal_tex: str = ""
    expression: str = ""
    asset_dir: Optional[Resource] = None
    used: bool = False

    def get_expression(self) -> str:
        """Best-effort material expression from mtl attrs (wavefront.go:57-125)."""
        if self.expression:
            return self.expression

        def fmt3(v):
            return "{%g, %g, %g}" % v

        is_specular = max(self.ks) > 0.0 or self.ks_tex != ""
        is_emissive = max(self.ke) > 0.0 or self.ke_tex != ""
        args: List[str] = []
        if is_specular and self.ni == 0.0:
            bxdf = "conductor"
            if self.ks_tex:
                args.append(f'specularity: "{self.ks_tex}"')
            elif max(self.ks) > 0.0:
                args.append(f"specularity: {fmt3(self.ks)}")
        elif is_specular:
            bxdf = "dielectric"
            if self.ks_tex:
                args.append(f'specularity: "{self.ks_tex}"')
            elif max(self.ks) > 0.0:
                args.append(f"specularity: {fmt3(self.ks)}")
            if self.tf_tex:
                args.append(f'transmittance: "{self.tf_tex}"')
            elif max(self.tf) > 0.0:
                args.append(f"transmittance: {fmt3(self.tf)}")
            args.append(f"intIOR: {self.ni:g}")
        elif is_emissive:
            bxdf = "emissive"
            if self.ke_tex:
                args.append(f'radiance: "{self.ke_tex}"')
            elif max(self.ke) > 0.0:
                args.append(f"radiance: {fmt3(self.ke)}")
            if self.ke_scaler != 0.0:
                args.append(f"scale: {self.ke_scaler:g}")
        else:
            bxdf = "diffuse"
            if self.kd_tex:
                args.append(f'reflectance: "{self.kd_tex}"')
            elif max(self.kd) > 0.0:
                args.append(f"reflectance: {fmt3(self.kd)}")

        expr = f"{bxdf}({', '.join(args)})"
        # Prefer normal maps to bump maps (wavefront.go:116-121)
        if self.normal_tex:
            expr = f'normalMap({expr}, "{self.normal_tex}")'
        elif self.bump_tex:
            expr = f'bumpMap({expr}, "{self.bump_tex}")'
        return expr


@dataclass
class _PendingMesh:
    name: str
    vertices: list = field(default_factory=list)  # (3,3) per tri
    normals: list = field(default_factory=list)
    uvs: list = field(default_factory=list)
    material_index: list = field(default_factory=list)

    def to_mesh(self) -> Mesh:
        n = len(self.vertices)
        return Mesh(
            name=self.name,
            vertices=np.asarray(self.vertices, np.float32).reshape(n, 3, 3),
            normals=np.asarray(self.normals, np.float32).reshape(n, 3, 3),
            uvs=np.asarray(self.uvs, np.float32).reshape(n, 3, 2),
            material_index=np.asarray(self.material_index, np.int32).reshape(n),
        )


class WavefrontReader:
    def __init__(self) -> None:
        self.log = get_logger("wavefront scene reader")
        self.scene = RawScene()
        self.vertex_list: List[np.ndarray] = []
        self.normal_list: List[np.ndarray] = []
        self.uv_list: List[np.ndarray] = []
        self.materials: List[_WfMaterial] = []
        self.mat_name_to_index: Dict[str, int] = {}
        self.cur_material: Optional[_WfMaterial] = None
        self.meshes: List[_PendingMesh] = []
        self.err_stack: List[str] = []

    # ----- public API -----

    def read(self, res: Resource) -> RawScene:
        """Parse an .obj scene into a RawScene (wavefront.go:166-188)."""
        self.log.info("parsing scene from %r", res.path)
        with Timer() as t:
            self._parse(res)
            self._finish_meshes()
            if not self.scene.mesh_instances:
                self._create_default_instances()
            self._process_materials()
        self.log.info("parsed scene in %.0f ms", t.ms)
        return self.scene

    # ----- internals -----

    def _err(self, path: str, line: int, msg: str) -> WavefrontError:
        frames = "\n".join(self.err_stack)
        return WavefrontError(
            f"[{path}: {line}] error: {msg}" + (f"\n{frames}" if frames else "")
        )

    def _parse(self, res: Resource) -> None:
        rel_v = len(self.vertex_list)
        rel_uv = len(self.uv_list)
        rel_n = len(self.normal_list)
        for line_num, raw in enumerate(res.read_text().splitlines(), start=1):
            tok = raw.split()
            if not tok or tok[0].startswith("#"):
                continue
            cmd = tok[0]
            try:
                if cmd in ("call", "mtllib"):
                    if len(tok) != 2:
                        raise WavefrontError(
                            f'"{cmd}" needs exactly one argument'
                        )
                    self.err_stack.insert(
                        0, f"referenced from {res.path}:{line_num} [{cmd}]"
                    )
                    inc = Resource(tok[1], rel_to=res)
                    if cmd == "call":
                        self._parse(inc)
                    else:
                        self._parse_materials(inc)
                    self.err_stack.pop(0)
                elif cmd == "usemtl":
                    if len(tok) != 2:
                        raise WavefrontError(
                            '"usemtl" needs exactly one argument (the material name)'
                        )
                    if tok[1] not in self.mat_name_to_index:
                        raise WavefrontError(
                            f'undefined material with name "{tok[1]}"'
                        )
                    self.cur_material = self.materials[self.mat_name_to_index[tok[1]]]
                elif cmd == "v":
                    self.vertex_list.append(_vec3(tok))
                elif cmd == "vn":
                    self.normal_list.append(_vec3(tok))
                elif cmd == "vt":
                    self.uv_list.append(_vec2(tok))
                elif cmd in ("g", "o"):
                    if len(tok) < 2:
                        raise WavefrontError(
                            f'"{cmd}" needs an object/group name'
                        )
                    self._verify_last_mesh()
                    self.meshes.append(_PendingMesh(tok[1]))
                elif cmd == "f":
                    self._parse_face(tok, rel_v, rel_uv, rel_n)
                elif cmd == "camera_fov":
                    self.scene.camera.fov = _float(tok)
                elif cmd == "camera_eye":
                    self.scene.camera.eye = _vec3(tok)
                elif cmd == "camera_look":
                    self.scene.camera.look = _vec3(tok)
                elif cmd == "camera_up":
                    self.scene.camera.up = _vec3(tok)
                elif cmd == "instance":
                    self._parse_instance(tok)
            except WavefrontError as exc:
                if str(exc).startswith("["):
                    raise
                raise self._err(res.path, line_num, str(exc)) from None
        self._verify_last_mesh()

    def _verify_last_mesh(self) -> None:
        if self.meshes and not self.meshes[-1].vertices:
            self.log.warning(
                'dropping mesh "%s" as it contains no polygons', self.meshes[-1].name
            )
            self.meshes.pop()

    def _default_material(self) -> _WfMaterial:
        """Default gray Kd 0.7 material (wavefront.go:291-304)."""
        if "" not in self.mat_name_to_index:
            self.materials.append(_WfMaterial(name="", kd=(0.7, 0.7, 0.7)))
            self.mat_name_to_index[""] = len(self.materials) - 1
        self.cur_material = self.materials[self.mat_name_to_index[""]]
        return self.cur_material

    def _parse_face(self, tok, rel_v, rel_uv, rel_n) -> None:
        if len(tok) < 4 or len(tok) > 5:
            raise WavefrontError(
                f'"f" takes 3 vertices (triangle) or 4 (quad); got {len(tok) - 1} — '
                "triangulate the mesh on export or fix the face line"
            )
        nverts = len(tok) - 1
        verts = np.zeros((4, 3), np.float32)
        norms = np.zeros((4, 3), np.float32)
        uvs = np.zeros((4, 2), np.float32)
        exp_indices = 0
        has_normals = False
        for arg in range(nverts):
            parts = tok[arg + 1].split("/")
            if arg == 0:
                exp_indices = len(parts)
            elif len(parts) != exp_indices:
                raise WavefrontError(
                    f"face vertex {arg} has {len(parts)} index fields but the first "
                    f"vertex on this face has {exp_indices}; mixed v/vt/vn forms "
                    "on one face are not allowed"
                )
            if parts[0] == "":
                raise WavefrontError(
                    f"face argument {arg} does not include a vertex index"
                )
            verts[arg] = self.vertex_list[
                _coord_index(parts[0], len(self.vertex_list), rel_v)
            ]
            if exp_indices > 1 and parts[1] != "":
                uvs[arg] = self.uv_list[
                    _coord_index(parts[1], len(self.uv_list), rel_uv)
                ]
            if exp_indices > 2 and parts[2] != "":
                norms[arg] = self.normal_list[
                    _coord_index(parts[2], len(self.normal_list), rel_n)
                ]
                has_normals = True

        if self.cur_material is None:
            self._default_material()
        self.cur_material.used = True
        mat_index = self.mat_name_to_index[self.cur_material.name]

        if not has_normals:
            face_n = np.cross(verts[1] - verts[0], verts[2] - verts[0])
            face_n = T.normalize(face_n)
            norms[:] = face_n

        if not self.meshes:
            self.meshes.append(_PendingMesh("default"))
        mesh = self.meshes[-1]
        tris = [(0, 1, 2)] if nverts == 3 else [(0, 1, 2), (0, 2, 3)]
        for idx in tris:
            sel = list(idx)
            mesh.vertices.append(verts[sel])
            mesh.normals.append(norms[sel])
            mesh.uvs.append(uvs[sel])
            mesh.material_index.append(mat_index)

    def _parse_instance(self, tok) -> None:
        """instance name tX tY tZ yaw pitch roll sX sY sZ (wavefront.go:448-526)."""
        if len(tok) != 11:
            raise WavefrontError(
                '"instance" takes 10 arguments: '
                "mesh_name tX tY tZ yaw pitch roll sX sY sZ; "
                f"got {len(tok) - 1}"
            )
        mesh_name = tok[1]
        mesh_index = next(
            (i for i, m in enumerate(self.meshes) if m.name == mesh_name), -1
        )
        if mesh_index == -1:
            raise WavefrontError(f'unknown mesh with name "{mesh_name}"')
        vals = [float(v) for v in tok[2:]]
        trans = np.array(vals[0:3], np.float32)
        rot = np.radians(np.array(vals[3:6], np.float32))
        scl = np.array(vals[6:9], np.float32)

        # Compose rotations roll*pitch*yaw about z/y/x (wavefront.go:503-507),
        # then the full object->world matrix as T @ R @ S (translate last).
        qx = T.quat_from_axis_angle(np.array([1, 0, 0]), rot[0])
        qy = T.quat_from_axis_angle(np.array([0, 1, 0]), rot[1])
        qz = T.quat_from_axis_angle(np.array([0, 0, 1]), rot[2])
        rmat = T.quat_to_mat4(T.quat_normalize(T.quat_mul(qz, T.quat_mul(qy, qx))))
        o2w = T.translate(trans) @ rmat @ T.scale(scl)
        self.scene.mesh_instances.append(
            MeshInstance(mesh_index=mesh_index, object_to_world=o2w)
        )

    def _parse_materials(self, res: Resource) -> None:
        self.log.info("parsing material library %r", res.path)
        cur: Optional[_WfMaterial] = None
        mat_name = ""
        for line_num, raw in enumerate(res.read_text().splitlines(), start=1):
            tok = raw.split()
            if not tok or tok[0].startswith("#"):
                continue
            cmd = tok[0]
            try:
                if cmd == "newmtl":
                    if len(tok) != 2:
                        raise WavefrontError(
                            '"newmtl" needs exactly one argument (the material name)'
                        )
                    mat_name = tok[1]
                    if mat_name in self.mat_name_to_index:
                        raise WavefrontError(
                            f'material "{mat_name}" already defined'
                        )
                    cur = _WfMaterial(name=mat_name, asset_dir=res)
                    self.materials.append(cur)
                    self.mat_name_to_index[mat_name] = len(self.materials) - 1
                    continue
                if cur is None:
                    raise WavefrontError(f'got "{cmd}" without a "newmtl"')
                if cmd == "include":
                    if len(tok) < 2:
                        raise WavefrontError(
                            '"include" needs exactly one argument (a path)'
                        )
                    base_idx = self.mat_name_to_index.get(tok[1])
                    if base_idx is None:
                        raise WavefrontError(
                            f'could not include unknown material "{tok[1]}"'
                        )
                    base = self.materials[base_idx]
                    keep_name = cur.name
                    for f_name in base.__dataclass_fields__:
                        setattr(cur, f_name, getattr(base, f_name))
                    cur.name = keep_name
                elif cmd == "Kd":
                    cur.kd = tuple(_vec3(tok))
                elif cmd == "Ks":
                    cur.ks = tuple(_vec3(tok))
                elif cmd == "Ke":
                    cur.ke = tuple(_vec3(tok))
                elif cmd == "Tf":
                    cur.tf = tuple(_vec3(tok))
                elif cmd == "Ni":
                    cur.ni = _float(tok)
                elif cmd in (
                    "map_Kd",
                    "map_Ks",
                    "map_Ke",
                    "map_Tf",
                    "map_bump",
                    "map_normal",
                ):
                    attr = {
                        "map_Kd": "kd_tex",
                        "map_Ks": "ks_tex",
                        "map_Ke": "ke_tex",
                        "map_Tf": "tf_tex",
                        "map_bump": "bump_tex",
                        "map_normal": "normal_tex",
                    }[cmd]
                    setattr(cur, attr, tok[1].strip('"'))
                elif cmd == "mat_expr":
                    if len(tok) < 2:
                        raise WavefrontError(
                            '"mat_expr" needs exactly one argument (quote the expression)'
                        )
                    cur.expression = " ".join(tok[1:])
                elif cmd == "KeScaler":
                    cur.ke_scaler = _float(tok)
            except WavefrontError as exc:
                if str(exc).startswith("["):
                    raise
                raise self._err(res.path, line_num, str(exc)) from None

    def _finish_meshes(self) -> None:
        for pm in self.meshes:
            self.scene.meshes.append(pm.to_mesh())

    def _create_default_instances(self) -> None:
        """Identity instance per mesh when none declared (wavefront.go:246-258)."""
        for i in range(len(self.scene.meshes)):
            self.scene.mesh_instances.append(
                MeshInstance(mesh_index=i, object_to_world=np.eye(4, dtype=np.float32))
            )

    def _process_materials(self) -> None:
        """Prune unused materials; remap primitive indices (wavefront.go:192-244)."""
        wf_to_scene: Dict[int, int] = {}
        pruned: List[Material] = []
        for wf_index, wf in enumerate(self.materials):
            if wf.name in (SCENE_DIFFUSE_MATERIAL, SCENE_EMISSIVE_MATERIAL):
                wf.used = True
            mat = Material(
                name=wf.name,
                expression=wf.get_expression(),
                asset_dir=wf.asset_dir,
                used=wf.used,
            )
            if not wf.used:
                self.log.info("skipping unused material %r", wf.name)
                pruned.append(mat)
                continue
            self.scene.materials.append(mat)
            wf_to_scene[wf_index] = len(self.scene.materials) - 1
        for mesh in self.scene.meshes:
            mesh.material_index = np.asarray(
                [wf_to_scene[int(i)] for i in mesh.material_index], np.int32
            )
        # Pruned materials stay addressable by expression references.
        self.scene.materials.extend(pruned)


def _coord_index(token: str, list_len: int, rel_offset: int) -> int:
    """1-based / negative index resolution (wavefront.go:766-782)."""
    index = int(token)
    off = list_len + index if index < 0 else rel_offset + index - 1
    if off < 0 or off >= list_len:
        raise WavefrontError("index out of bounds")
    return off


def _float(tok) -> float:
    if len(tok) < 2:
        raise WavefrontError(
            f'"{tok[0]}" needs 1 value'
        )
    return float(tok[1])


def _vec3(tok) -> np.ndarray:
    if len(tok) < 4:
        raise WavefrontError(
            f'"{tok[0]}" needs 3 values'
        )
    return np.array([float(tok[1]), float(tok[2]), float(tok[3])], np.float32)


def _vec2(tok) -> np.ndarray:
    if len(tok) < 3:
        raise WavefrontError(
            f'"{tok[0]}" needs 2 values'
        )
    return np.array([float(tok[1]), float(tok[2])], np.float32)


def read_scene(path_or_res) -> RawScene:
    """Read a .obj scene from a path or Resource."""
    res = path_or_res if isinstance(path_or_res, Resource) else Resource(path_or_res)
    return WavefrontReader().read(res)
