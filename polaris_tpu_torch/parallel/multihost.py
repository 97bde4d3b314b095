"""Multi-process distribution over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/multihost.py``. The reference
declared but never implemented a network backend (`tracer.Remote` flag,
tracer/tracer.go:52-58). Here every process is one shard of a (tile,
sample) mesh (``mesh.py`` is the same split inside one process): it renders
its row band for its share of the samples on its own device; an all-reduce
over the ranks of its tile sums the sample shards (the ``psum`` over
'sample'), and an all-gather over the tiles gives every rank the frame.

The backend is the caller's to name: ``"gloo"`` for CPU tensors, or CUDA
tensors of ranks that share a card (NCCL puts no two ranks on one card);
``"nccl"`` where each rank has a card of its own.

Testable without a cluster via ``spawn_local_processes`` (N processes on one
machine, each taking a free port from the OS to meet at).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..asset.camera import Camera
from ..asset.scene_data import PARAM_FIELDS
from ..utils.log import get_logger
from .mesh import split

_log = get_logger("multihost")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def initialize(
    backend: str,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``torch.distributed.init_process_group`` with ``backend``: at
    ``coordinator_address`` ("host:port") as rank ``process_id`` of
    ``num_processes``, or, without an address, from the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as
    ``jax.distributed.initialize()`` reads its cluster's."""
    if coordinator_address is not None:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
        )
    else:
        dist.init_process_group(backend, init_method="env://")
    _log.info("distributed: process %d/%d, backend %s",
              dist.get_rank(), dist.get_world_size(), backend)


@dataclass
class GlobalMesh:
    """The (tile, sample) grid over the ranks of the process group, tile
    axis outermost (rank ``t * sample + s`` is shard (t, s)), one device a
    rank: this rank's ``device`` and coordinates, and ``sample_group``, the
    ranks of its tile."""

    shape: dict
    tile_index: int
    sample_index: int
    device: torch.device
    sample_group: object


def make_global_mesh(tile: int, sample: int, device) -> GlobalMesh:
    """The mesh over every rank, this rank's shard on ``device``. Every rank
    calls it: each makes the group of every tile, in the same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != tile * sample:
        raise ValueError(f"a {tile}x{sample} mesh needs {tile * sample} processes, have {world}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    groups = [dist.new_group([t * sample + s for s in range(sample)]) for t in range(tile)]
    return GlobalMesh({"tile": tile, "sample": sample}, rank // sample, rank % sample,
                      device, groups[rank // sample])


def _gather_tiles(band: torch.Tensor, mesh: GlobalMesh) -> torch.Tensor:
    """Every rank's band, all-gathered; the frame stacks the first sample
    shard's band of each tile."""
    parts = [torch.empty_like(band) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, band.contiguous())
    samples = mesh.shape["sample"]
    return torch.cat(parts[::samples], dim=0)


def render_multihost(renderer, opt, mesh: GlobalMesh, camera: Optional[Camera] = None):
    """This rank's shard through ``renderer`` (a ``TorchRenderer`` on
    ``mesh.device``), summed over its tile's ranks, and the frame
    all-gathered: every rank returns the [H, W, 3] accumulator on its
    device."""
    rows, spp_local = split(opt, mesh.shape)
    band = renderer.render_band_accum(
        replace(opt, spp=spp_local), mesh.tile_index * rows, rows, camera=camera,
        sample_offset=mesh.sample_index * spp_local,
    )
    dist.all_reduce(band, group=mesh.sample_group)  # ≙ the psum over 'sample'
    return _gather_tiles(band, mesh)


def train_step_multihost(renderer, opt, mesh: GlobalMesh, target, lr: float = 0.1,
                         camera: Optional[Camera] = None):
    """One distributed optimization step (``mesh.DistributedRenderer.
    train_step`` across processes): this rank's band op by op with
    autograd; the tile's sample shards summed by an all-reduce that
    autograd goes through (``torch.distributed.nn.functional.all_reduce``);
    the JAX ``local_loss`` on the tile; the gradient all-reduced over every
    rank; SGD. Every rank's tile loss is counted once per sample shard, so
    each backpropagates ``1/sample`` of it: the all-reduce's backward sums
    the tile's ranks, and each shard's gradient is the tile loss's, as under
    the JAX ``psum``. Returns ``(loss, new parameters)``; the renderer's
    scene tensors are left as they were."""
    from torch.distributed.nn.functional import all_reduce

    from ..render.integrator import render_band_eager
    from ..render.shade import tonemap_reinhard

    rows, spp_local = split(opt, mesh.shape)
    samples = mesh.shape["sample"]
    dev = mesh.device
    frustum, eye = renderer._camera_tensors(opt, camera)
    y0 = mesh.tile_index * rows
    want = torch.as_tensor(np.asarray(target, np.float32)[y0:y0 + rows]).to(dev)
    params = {k: renderer.S[k].detach().clone().requires_grad_(True) for k in PARAM_FIELDS}
    with torch.enable_grad():
        local = replace(opt, spp=spp_local)
        band = render_band_eager(
            renderer, local, frustum=frustum, eye=eye, y0=y0, band_h=rows,
            sample_offset=mesh.sample_index * spp_local, S=dict(renderer.S, **params),
        )
        band = renderer.finalize(band, replace(local, height=rows))
        acc = all_reduce(band, group=mesh.sample_group)
        img = tonemap_reinhard(acc + 1e-6, 1.0 / opt.spp, opt.exposure)
        loss = torch.sum((img - want) ** 2) / (opt.width * opt.height * 3) / samples
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    new = {}
    for (k, p), g in zip(params.items(), grads):
        g = torch.zeros_like(p) if g is None else g.contiguous()
        dist.all_reduce(g)  # ≙ the gradient psum over ('tile', 'sample')
        new[k] = (p - lr * g).detach()
    loss = loss.detach().clone()
    dist.all_reduce(loss)  # ≙ the loss psum over 'tile'
    return float(loss), new


# ----- single-machine multi-process harness -----

_WORKER_SNIPPET = """
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from polaris_tpu_torch.asset.scene_data import SceneData
from polaris_tpu_torch.parallel import multihost
from polaris_tpu_torch.render.integrator import TorchRenderer
from polaris_tpu_torch.render.options import RenderOptions
from polaris_tpu_torch.utils.log import Timer

multihost.initialize(
    {backend!r}, coordinator_address="127.0.0.1:{port}", num_processes={nproc},
    process_id={pid},
)
try:
    opt = RenderOptions(**{opt_kwargs!r})
    mesh = multihost.make_global_mesh({tile}, {sample}, {device!r})
    r = TorchRenderer(SceneData.load({scene_path!r}), device=mesh.device, mode={mode!r})
    ms = []
    for _ in range({frames}):
        dist.barrier()
        with Timer() as t:
            if {job!r} == "train":
                target = np.zeros((opt.height, opt.width, 3), np.float32)
                loss, params = multihost.train_step_multihost(r, opt, mesh, target, lr=0.1)
            else:
                full = multihost.render_multihost(r, opt, mesh).cpu().numpy()
        ms.append(t.ms)
    if dist.get_rank() == 0:
        if {job!r} == "train":
            np.savez({out_path!r}, loss=np.float32(loss), ms=np.array(ms),
                     refl=params["mat_reflectance"].cpu().numpy())
        else:
            np.savez({out_path!r}, accum=full, ms=np.array(ms))
finally:
    dist.destroy_process_group()
"""


def free_port() -> int:
    """A TCP port on this machine that the OS reports free."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local_processes(
    scene_path: str,
    opt_kwargs: dict,
    num_processes: int,
    tile: int,
    sample: int,
    out_path: str,
    *,
    backend: str,
    devices: Optional[Sequence[str]] = None,
    mode: str = "auto",
    job: str = "render",
    frames: int = 1,
    port: Optional[int] = None,
    timeout: float = 600.0,
):
    """Run a real multi-process job on this machine: ``num_processes``
    ranks of ``backend`` meeting at ``port`` (a free one by default), rank
    i on ``devices[i]``: by default on CUDA device i, and without a card
    the call raises; the CPU only on request (``devices=["cpu"] * n``).
    ``job`` is ``"render"`` (rank 0 writes the frame's accumulator, ``accum``) or
    ``"train"`` (one distributed train step against a zero target, lr 0.1:
    ``loss`` and the updated ``refl`` = ``mat_reflectance``), each run
    ``frames`` times, with every run's milliseconds as ``ms``. Returns the
    npz rank 0 wrote at ``out_path``. Every process is killed if one fails
    or ``timeout`` seconds pass."""
    if job not in ("render", "train"):
        raise ValueError(f"job must be 'render' or 'train', not {job!r}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices=['cpu', ...] explicitly "
                "to run the processes on the CPU"
            )
        devices = [f"cuda:{i}" for i in range(num_processes)]
    devices = list(devices)
    if len(devices) != num_processes:
        raise ValueError(f"{len(devices)} devices for {num_processes} processes")
    if not out_path.endswith(".npz"):
        out_path += ".npz"  # np.savez appends the suffix
    port = port or free_port()
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    try:
        for pid in range(num_processes):
            code = _WORKER_SNIPPET.format(
                port=port, nproc=num_processes, pid=pid, scene_path=scene_path,
                opt_kwargs=opt_kwargs, tile=tile, sample=sample, out_path=out_path,
                job=job, backend=backend, device=str(devices[pid]), mode=mode,
                frames=frames,
            )
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, env=env,
            ))
        errs = []
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                _, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"worker did not finish within {timeout} s") from None
            if p.returncode != 0:
                errs.append(err.decode()[-2000:])
        if errs:
            raise RuntimeError("worker failed:\n" + "\n---\n".join(errs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return np.load(out_path)
