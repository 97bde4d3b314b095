"""polaris_tpu_torch: the PyTorch/CUDA port of the polaris path tracer.

Same sub-package layout as the JAX package it is held against (``asset/``,
``ops/``, ``render/``, ``native/``, ``utils/``); the hot kernel is
hand-written CUDA under ``csrc/``. Imports ``torch`` only.

    from polaris_tpu_torch import (
        read_scene, compile_scene, SceneData,   # asset pipeline
        RenderOptions, TorchRenderer,           # rendering
        TpuRenderer,                            # the JAX package's name of it
        upload_scene,                           # host -> device scene dict
        DifferentiableRenderer, Trainer,        # inverse rendering
        TrainConfig, denoise_accum,
        ProgressiveRenderer,                    # live viewer
        Pipeline, default_pipeline,             # post-process chain
        DistributedRenderer, make_mesh,         # tile x sample mesh
    )

Every public name of the JAX package is here but ``CpuRenderer``, its NumPy
oracle (``cpu_ref/``), which waits for a slice of its own. The command line
is ``polaris_tpu_torch/cli.py`` (``python -m polaris_tpu_torch.cli``).
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
