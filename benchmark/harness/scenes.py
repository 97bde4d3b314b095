"""A configuration's scene, for the renderer under test and for the reference.

A configuration names its scene one of two ways: `{"obj": "<file under
benchmark/>"}`, a Wavefront file the benchmark keeps its own copy of, or
`{"terrain_grid": g}`, the heightfield of `reference/scene.py::terrain`.
The renderer under test gets the scene through its public asset pipeline
(`read_scene`, or the raw-scene types of `asset/input_scene.py`, then
`compile_scene`). A generated scene is compiled once per checkout, as users
compile a scene and render from the artifact: the compiled scene is kept
under `benchmark/.cache/scenes/`, keyed by the generator's parameters and
source and by every source file of the renderer's package (its compiler and
the native BVH builder among them), and later runs load it
(`SceneData.load`).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from . import cells

CACHE = os.path.join(cells.BENCH_DIR, ".cache")


def reference_scene(config: dict):
    from reference.scene import read_obj, terrain_scene

    spec = config["scene"]
    if "obj" in spec:
        return read_obj(os.path.join(cells.BENCH_DIR, spec["obj"]))
    return terrain_scene(int(spec["terrain_grid"]))


def _raw_terrain(grid: int):
    from polaris_tpu_torch.asset.input_scene import Camera, Material, Mesh, MeshInstance, RawScene
    from reference.scene import terrain

    t = terrain(grid)
    meshes = []
    for i, key in enumerate(("terrain", "light")):
        tris, normals = t[key]
        meshes.append(Mesh(
            name=key, vertices=tris, normals=normals,
            uvs=np.zeros((tris.shape[0], 3, 2), np.float32),
            material_index=np.full(tris.shape[0], i, np.int32),
        ))
    cam = t["camera"]
    return RawScene(
        meshes=meshes,
        mesh_instances=[MeshInstance(i, np.eye(4, dtype=np.float32)) for i in range(2)],
        materials=[Material(name, expr, used=True) for name, expr in t["materials"]],
        camera=Camera(
            fov=cam["fov"], eye=np.asarray(cam["eye"], np.float32),
            look=np.asarray(cam["look"], np.float32),
        ),
    )


# the sources the compiled scene is made from: the whole package, whose
# native BVH builder (`native/*.cpp`) is built from them at run time
SOURCES = (".py", ".c", ".cc", ".cpp", ".h", ".hpp", ".cu", ".cuh")


def _program_digest() -> str:
    import polaris_tpu_torch

    h = hashlib.sha256()
    root = os.path.dirname(polaris_tpu_torch.__file__)
    for dirpath, dirnames, files in os.walk(root):
        dirnames.sort()
        for name in sorted(files):
            if name.endswith(SOURCES):
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    h.update(os.path.relpath(path, root).encode() + f.read())
    with open(os.path.join(cells.BENCH_DIR, "reference", "scene.py"), "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:20]


def program_scene(config: dict):
    """The compiled scene (`SceneData`) that the renderer under test renders."""
    import polaris_tpu_torch as P

    spec = config["scene"]
    if "obj" in spec:
        return P.compile_scene(P.read_scene(os.path.join(cells.BENCH_DIR, spec["obj"])))
    key = hashlib.sha256(
        (json.dumps(spec, sort_keys=True) + _program_digest()).encode()
    ).hexdigest()[:24]
    path = os.path.join(CACHE, "scenes", f"terrain_{key}.scene")
    if os.path.exists(path):
        return P.SceneData.load(path)
    scene = P.compile_scene(_raw_terrain(int(spec["terrain_grid"])))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".partial"
    scene.save(tmp)
    os.replace(tmp, path)
    return scene
