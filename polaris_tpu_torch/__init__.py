"""polaris_tpu_torch: the PyTorch/CUDA port of the polaris path tracer.

Same sub-package layout as the JAX package it is held against (``asset/``,
``ops/``, ``render/``, ``parallel/``, ``cpu_ref/``, ``native/``,
``utils/``); the traversal kernels are hand-written CUDA under ``csrc/``.
Imports ``torch`` and NumPy only.

    from polaris_tpu_torch import (
        read_scene, compile_scene, SceneData,   # asset pipeline
        RenderOptions, TorchRenderer,           # rendering
        TpuRenderer,                            # the JAX package's name of it
        CpuRenderer,                            # the NumPy oracle
        upload_scene,                           # host -> device scene dict
        DifferentiableRenderer, Trainer,        # inverse rendering
        TrainConfig, denoise_accum,
        ProgressiveRenderer,                    # live viewer
        Pipeline, default_pipeline,             # post-process chain
        DistributedRenderer, make_mesh,         # tile x sample mesh
    )

Every public name of the JAX package is here. ``CpuRenderer`` is the JAX
package's NumPy oracle, kept a NumPy program on the host (``cpu_ref/``):
brute-force Möller-Trumbore over each instance's triangles, independent of
every BVH traversal, and shading through copies of the xp-generic formula
modules (``cpu_ref/xp/``) run with ``xp=np``; it imports no torch. It gives
the JAX oracle's bits on the same ``SceneData``.

``TorchRenderer`` replays each step of its loops from a CUDA graph on a
card. The plain traversals 'bvh' and 'packet' read their loop test back to
the host, so with them the same steps run uncaptured, op by op, on the
card. The command line is ``polaris_tpu_torch/cli.py`` (``python -m
polaris_tpu_torch.cli``).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy imports keep `import polaris_tpu_torch` light
    if name == "read_scene":
        from .asset.wavefront import read_scene

        return read_scene
    if name == "compile_scene":
        from .asset.compiler.compiler import compile_scene

        return compile_scene
    if name == "SceneData":
        from .asset.scene_data import SceneData

        return SceneData
    if name == "Camera":
        from .asset.camera import Camera

        return Camera
    if name == "RenderOptions":
        from .render.options import RenderOptions

        return RenderOptions
    if name in ("TorchRenderer", "TpuRenderer"):
        from .render.integrator import TorchRenderer

        return TorchRenderer
    if name == "CpuRenderer":
        from .cpu_ref.renderer import CpuRenderer

        return CpuRenderer
    if name == "DifferentiableRenderer":
        from .render.grad import DifferentiableRenderer

        return DifferentiableRenderer
    if name in ("Trainer", "TrainConfig"):
        from .render import trainer

        return getattr(trainer, name)
    if name == "denoise_accum":
        from .render.denoise import denoise_accum

        return denoise_accum
    if name == "ProgressiveRenderer":
        from .render.progressive import ProgressiveRenderer

        return ProgressiveRenderer
    if name in ("Pipeline", "default_pipeline"):
        from .render import pipeline

        return getattr(pipeline, name)
    if name in ("DistributedRenderer", "make_mesh"):
        from .parallel import mesh

        return getattr(mesh, name)
    if name == "upload_scene":
        from .scene import upload_scene

        return upload_scene
    raise AttributeError(name)
