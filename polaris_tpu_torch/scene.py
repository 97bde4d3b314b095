"""Scene upload: a compiled ``SceneData`` becomes a dict of device tensors.

``upload_scene`` is where scene state crosses from the host (NumPy arrays
out of the scene compiler, or out of the JAX package's compiler: the tests
hand its fields over as a plain dict) onto the device the renderer runs on.
Counterpart of ``SceneData.split_params`` plus the upload in the JAX
renderer's constructor; geometry and material parameters share one merged
dict ``S`` because eager PyTorch needs no static/traced split.

Besides one tensor per array field (the float atlas ``tex_data`` stays
float32, the byte atlas ``tex_data_u8`` stays uint8), ``S`` carries two
host-side sidecars, ``_stx`` (which features the scene can reach,
ops/statics.py) and ``_tex_meta`` (offset, width, height, storage per
texture), and ``_tex_table``, the same rows as a device tensor for the
sampler's per-lane lookup (ops/texture.py).
"""

from __future__ import annotations

from dataclasses import fields
from typing import Dict, Union

import numpy as np
import torch

from .asset.scene_data import SceneData
from .ops.statics import Static, scene_statics
from .ops.texture import texture_table


def as_scene_data(scene: Union[SceneData, Dict]) -> SceneData:
    """Accept a port ``SceneData`` or a dict of its fields (NumPy arrays and
    scalars, e.g. the fields of the JAX package's ``SceneData``)."""
    if isinstance(scene, SceneData):
        return scene
    if isinstance(scene, dict):
        names = {f.name for f in fields(SceneData)}
        unknown = sorted(set(scene) - names)
        if unknown:
            raise KeyError(f"not SceneData fields: {unknown}")
        return SceneData(**scene)
    raise TypeError(
        f"expected SceneData or a dict of its fields, got {type(scene).__name__}"
    )


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA device and raises when there is none; the CPU
    is used only when the caller asks for it by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to "
                "run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def upload_scene(scene: Union[SceneData, Dict], device) -> Dict:
    """Upload every array field to ``device`` and attach the host sidecars.

    float32 / int32 / uint8 fields keep their dtype; ``tri_normals`` and
    ``tri_uvs`` are stored as flat ``(T, 9)`` / ``(T, 6)`` rows so the
    per-hit attribute fetch is one row gather.
    """
    scene = as_scene_data(scene)
    device = resolve_device(device)
    stx = scene_statics(scene)
    S: Dict = {}
    for f in fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, np.ndarray):
            S[f.name] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    num_tris = S["tri_v0"].shape[0]
    S["tri_normals"] = S["tri_normals"].reshape(num_tris, 9)
    S["tri_uvs"] = S["tri_uvs"].reshape(num_tris, 6)
    S["_stx"] = stx
    n_tex = int(scene.tex_offset.shape[0])
    store = (
        scene.tex_store
        if scene.tex_store.shape[0] == n_tex
        else np.zeros(n_tex, np.int32)
    )
    S["_tex_meta"] = Static(
        tex=tuple(
            (int(o), int(w), int(h), int(s))
            for o, w, h, s in zip(
                scene.tex_offset, scene.tex_width, scene.tex_height, store
            )
        )
    )
    S["_tex_table"] = texture_table(S["_tex_meta"].tex, device)
    return S
