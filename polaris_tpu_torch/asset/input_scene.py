"""Raw (parsed) scene model produced by scene readers.

Counterpart of the reference's ``asset/compiler/input/raw_scene.go:10-161``:
``Scene{Meshes, MeshInstances, Materials, Camera}`` with per-primitive
bbox/center so everything can feed the generic BVH builder.

Primitives are stored mesh-local as NumPy arrays-of-triangles rather than
one Python object per triangle — the scene compiler and BVH builder operate
on vectorized arrays (TPU-first data layout from the very start).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import types as T


@dataclass
class Material:
    name: str
    expression: str
    asset_dir: Optional[object] = None  # parent Resource for relative paths
    used: bool = False


@dataclass
class Mesh:
    """A named mesh: triangle soup with per-vertex attributes.

    vertices/normals: (T, 3, 3) float32, uvs: (T, 3, 2) float32,
    material_index: (T,) int32 into the raw material list.
    """

    name: str
    vertices: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    material_index: np.ndarray

    @property
    def num_triangles(self) -> int:
        return int(self.vertices.shape[0])

    def bbox(self):
        flat = self.vertices.reshape(-1, 3)
        return flat.min(axis=0), flat.max(axis=0)

    def tri_bboxes(self):
        return self.vertices.min(axis=1), self.vertices.max(axis=1)

    def tri_centers(self):
        return self.vertices.mean(axis=1).astype(np.float32)


@dataclass
class MeshInstance:
    mesh_index: int
    object_to_world: np.ndarray  # (4,4) float32

    def bbox(self, meshes: List[Mesh]):
        bmin, bmax = meshes[self.mesh_index].bbox()
        return T.transform_aabb(self.object_to_world, bmin, bmax)


@dataclass
class Camera:
    fov: float = 45.0
    eye: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    look: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, -1], np.float32)
    )
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))


@dataclass
class RawScene:
    meshes: List[Mesh] = field(default_factory=list)
    mesh_instances: List[MeshInstance] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    camera: Camera = field(default_factory=Camera)
