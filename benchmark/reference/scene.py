"""The benchmark's own view of a scene: triangles, materials, lights and the
camera, worked out from the `.obj` / `.mtl` text or from the generated
terrain, with no code of the renderer under test.

Only what the benchmark's configurations use is read: triangles and quads
(a quad is split 0-1-2, 0-2-3), vertex normals (else the face normal),
`usemtl`, the `camera_*` lines, and materials written as
`mat_expr diffuse(reflectance: {r, g, b})` or
`mat_expr emissive(radiance: {r, g, b}, scale: s)`. Anything else raises,
so a scene the reference cannot render is refused, not rendered wrong.

Lights are the emissive triangles in file order. The camera's four
frustum corner rays follow upstream polaris's camera (camera.go:114-141)
with the field of view in degrees.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

DIFFUSE = "diffuse"
EMISSIVE = "emissive"


@dataclass
class RefScene:
    v0: np.ndarray  # (T, 3) float32, first vertex
    e1: np.ndarray  # (T, 3) float32, v1 - v0
    e2: np.ndarray  # (T, 3) float32, v2 - v0
    normals: np.ndarray  # (T, 3, 3) float32, one per vertex
    tri_mat: np.ndarray  # (T,) int64 into the material rows
    mat_kind: List[str]  # per material row: DIFFUSE or EMISSIVE
    reflectance: np.ndarray  # (M, 3) float32
    radiance: np.ndarray  # (M, 3) float32
    scale: np.ndarray  # (M,) float32
    light_tri: np.ndarray  # (L,) int64, emissive triangles in file order
    light_area: np.ndarray  # (L,) float32
    eye: np.ndarray  # (3,) float32
    look: np.ndarray
    up: np.ndarray
    fov: float

    @property
    def num_tris(self) -> int:
        return int(self.v0.shape[0])

    def frustum(self, width: int, height: int) -> np.ndarray:
        """The corner rays TL, TR, BL, BR minus the eye, float32 (4, 3)."""
        return frustum(self.eye, self.look, self.up, self.fov, width / height)


_VEC = r"\{\s*([-+0-9.eE]+)\s*,\s*([-+0-9.eE]+)\s*,\s*([-+0-9.eE]+)\s*\}"
_DIFFUSE = re.compile(r"^diffuse\(\s*reflectance:\s*" + _VEC + r"\s*\)$")
_EMISSIVE = re.compile(
    r"^emissive\(\s*radiance:\s*" + _VEC + r"\s*,\s*scale:\s*([-+0-9.eE]+)\s*\)$"
)


def parse_material(expr: str):
    """(kind, reflectance, radiance, scale) of one material expression."""
    expr = expr.strip().strip('"')
    m = _DIFFUSE.match(expr)
    if m:
        return DIFFUSE, [float(x) for x in m.groups()], [0.0, 0.0, 0.0], 0.0
    m = _EMISSIVE.match(expr)
    if m:
        g = [float(x) for x in m.groups()]
        return EMISSIVE, [0.0, 0.0, 0.0], g[:3], g[3]
    raise ValueError(f"the reference renders no material {expr!r}")


def _read_mtl(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    name = None
    with open(path) as f:
        for line in f:
            tok = line.strip()
            if not tok or tok.startswith("#"):
                continue
            cmd, _, rest = tok.partition(" ")
            if cmd == "newmtl":
                name = rest.strip()
            elif cmd == "mat_expr":
                out[name] = rest.strip()
            else:
                raise ValueError(f"the reference reads no .mtl line {tok!r}")
    return out


def read_obj(path: str) -> RefScene:
    """The scene of a Wavefront `.obj` and its `.mtl`."""
    verts: List[List[float]] = []
    norms: List[List[float]] = []
    tris: List[np.ndarray] = []
    tri_norms: List[np.ndarray] = []
    tri_mat_names: List[str] = []
    mtl: Dict[str, str] = {}
    cam = dict(fov=45.0, eye=[0, 0, 0], look=[0, 0, -1], up=[0, 1, 0])
    cur = None
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            cmd = tok[0]
            if cmd == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif cmd == "vn":
                norms.append([float(x) for x in tok[1:4]])
            elif cmd == "f":
                idx = [t.split("/") for t in tok[1:]]
                if len(idx) not in (3, 4):
                    raise ValueError(f"face of {len(idx)} vertices")
                p = np.asarray([verts[int(i[0]) - 1] for i in idx], np.float32)
                if len(idx[0]) > 2 and idx[0][2]:
                    n = np.asarray([norms[int(i[2]) - 1] for i in idx], np.float32)
                else:
                    fn = np.cross(p[1] - p[0], p[2] - p[0])
                    fn = fn / np.linalg.norm(fn)
                    n = np.repeat(fn[None, :], len(idx), axis=0).astype(np.float32)
                for sel in ([0, 1, 2],) if len(idx) == 3 else ([0, 1, 2], [0, 2, 3]):
                    tris.append(p[sel])
                    tri_norms.append(n[sel])
                    tri_mat_names.append(cur)
            elif cmd == "usemtl":
                cur = tok[1]
            elif cmd == "mtllib":
                mtl.update(_read_mtl(os.path.join(base, tok[1])))
            elif cmd == "camera_fov":
                cam["fov"] = float(tok[1])
            elif cmd in ("camera_eye", "camera_look", "camera_up"):
                cam[cmd[7:]] = [float(x) for x in tok[1:4]]
            elif cmd in ("o", "g", "s", "vt"):
                continue
            else:
                raise ValueError(f"the reference reads no .obj line {line!r}")
    names = list(dict.fromkeys(tri_mat_names))
    mats = [parse_material(mtl[n]) for n in names]
    return _assemble(
        np.stack(tris), np.stack(tri_norms),
        np.asarray([names.index(n) for n in tri_mat_names], np.int64), mats, cam,
    )


def terrain(grid: int) -> dict:
    """The sine-ridge heightfield of `2 * grid**2` triangles under one quad
    light: arrays for both sides. A frozen copy of the generator
    `make_terrain_scene` (polaris_tpu_torch/asset/procedural.py, commit
    70823ee). No randomness."""
    g = grid
    xs = np.linspace(-10, 10, g + 1, dtype=np.float32)
    zs = np.linspace(-10, 10, g + 1, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    H = (
        0.6 * np.sin(0.9 * X) * np.cos(0.7 * Z)
        + 0.35 * np.sin(2.3 * X + 1.1) * np.sin(1.9 * Z + 0.4)
        + 0.15 * np.sin(5.1 * X + 2.0) * np.cos(4.7 * Z + 1.3)
    ).astype(np.float32)
    P = np.stack([X, H, Z], axis=-1)
    v00 = P[:-1, :-1].reshape(-1, 3)
    v10 = P[1:, :-1].reshape(-1, 3)
    v01 = P[:-1, 1:].reshape(-1, 3)
    v11 = P[1:, 1:].reshape(-1, 3)
    tris = np.concatenate(
        [np.stack([v00, v10, v11], axis=1), np.stack([v00, v11, v01], axis=1)], axis=0
    ).astype(np.float32)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    normals = np.repeat(n[:, None, :], 3, axis=1).astype(np.float32)
    ly = 6.0
    light = np.array(
        [[[-2, ly, -2], [2, ly, -2], [2, ly, 2]], [[-2, ly, -2], [2, ly, 2], [-2, ly, 2]]],
        np.float32,
    )
    light_n = np.tile(np.array([0, -1, 0], np.float32), (2, 3, 1))
    return dict(
        terrain=(tris, normals), light=(light, light_n),
        materials=(
            ("ground", "diffuse(reflectance: {0.55, 0.5, 0.45})"),
            ("sky", "emissive(radiance: {1, 0.95, 0.9}, scale: 8)"),
        ),
        camera=dict(fov=55.0, eye=[0.0, 4.5, 12.0], look=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0]),
    )


def terrain_scene(grid: int) -> RefScene:
    t = terrain(grid)
    tris = np.concatenate([t["terrain"][0], t["light"][0]])
    norms = np.concatenate([t["terrain"][1], t["light"][1]])
    mat = np.concatenate(
        [np.zeros(len(t["terrain"][0]), np.int64), np.ones(len(t["light"][0]), np.int64)]
    )
    mats = [parse_material(e) for _, e in t["materials"]]
    return _assemble(tris, norms, mat, mats, t["camera"])


def _assemble(tris, normals, tri_mat, mats, cam) -> RefScene:
    kinds = [m[0] for m in mats]
    light = np.asarray(
        [i for i in range(len(tri_mat)) if kinds[tri_mat[i]] == EMISSIVE], np.int64
    )
    if light.size == 0:
        raise ValueError("a scene with no light")
    lt = tris[light].astype(np.float64)
    area = 0.5 * np.linalg.norm(np.cross(lt[:, 2] - lt[:, 0], lt[:, 2] - lt[:, 1]), axis=1)
    return RefScene(
        v0=np.ascontiguousarray(tris[:, 0]),
        e1=(tris[:, 1] - tris[:, 0]).astype(np.float32),
        e2=(tris[:, 2] - tris[:, 0]).astype(np.float32),
        normals=normals.astype(np.float32), tri_mat=tri_mat, mat_kind=kinds,
        reflectance=np.asarray([m[1] for m in mats], np.float32),
        radiance=np.asarray([m[2] for m in mats], np.float32),
        scale=np.asarray([m[3] for m in mats], np.float32),
        light_tri=light, light_area=area.astype(np.float32),
        eye=np.asarray(cam["eye"], np.float32), look=np.asarray(cam["look"], np.float32),
        up=np.asarray(cam["up"], np.float32), fov=float(cam["fov"]),
    )


def _unit(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def frustum(eye, look, up, fov_deg: float, aspect: float) -> np.ndarray:
    """Corner rays of the right-handed perspective camera (near 1, far 1000),
    each the perspective-divided clip corner through the inverse
    view-projection minus the eye; order TL, TR, BL, BR."""
    f32 = np.float32
    f = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    near, far = 1.0, 1000.0
    proj = np.zeros((4, 4), f32)
    proj[0, 0], proj[1, 1] = f / aspect, f
    proj[2, 2], proj[2, 3], proj[3, 2] = (near + far) / (near - far), 2 * far * near / (near - far), -1
    fwd = _unit(np.asarray(look, f32) - np.asarray(eye, f32))
    s = _unit(np.cross(fwd, _unit(np.asarray(up, f32))))
    u = np.cross(s, fwd)
    rot = np.eye(4, dtype=f32)
    rot[0, :3], rot[1, :3], rot[2, :3] = s, u, -fwd
    trans = np.eye(4, dtype=f32)
    trans[:3, 3] = -np.asarray(eye, f32)
    inv = np.linalg.inv(proj @ (rot @ trans)).astype(f32)
    out = np.zeros((4, 3), f32)
    for i, (cx, cy) in enumerate(((-1, 1), (1, 1), (-1, -1), (1, -1))):
        v = inv @ np.array([cx, cy, -1.0, 1.0], f32)
        out[i] = v[:3] / v[3] - np.asarray(eye, f32)
    return out
