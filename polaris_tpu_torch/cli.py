"""polaris-tpu-torch command line interface: the JAX package's CLI on the
PyTorch port.

Counterpart of ``polaris_tpu/cli.py`` (itself after the reference's CLI,
``main.go:41-179``), with the same commands, flags, defaults, argument
checks and exit codes:

  polaris-tpu-torch render frame <scene>        single-frame render -> PNG
  polaris-tpu-torch render progressive <scene>  progressive accumulation,
                                                writing snapshots
  polaris-tpu-torch scene compile <obj>         .obj -> compiled .zip artifact
  polaris-tpu-torch scene info <scene>          size-breakdown table
  polaris-tpu-torch devices                     list the CUDA devices

Where the JAX CLI picks its platform through ``JAX_PLATFORMS``, the render
commands take ``--device {cuda,cpu}`` (default ``cuda``): without a card
they refuse to run unless ``--device cpu`` is given, and with it the CPU is
the one device, repeated as often as ``--pool`` or ``--tiles`` x
``--sample-shards`` ask. ``--mode`` also offers 'pallas8_nodes', the
big-scene kernel the JAX CLI leaves out. ``--denoise ITERS`` is checked:
the filter's pad radius 2 * 2**(ITERS - 1) must stay below the frame's
larger side (the JAX CLI takes any value). Nothing here touches CUDA or
builds a kernel before a command runs.

Defaults mirror the reference (main.go:76-120): 1024x1024, 16 spp, 5
bounces, RR after 3, exposure 1.2.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .utils.log import get_logger, set_level

_log = get_logger("cli")

MODES = ["auto", "pallas", "pallas_stream", "pallas_nodes", "pallas8", "pallas8_nodes",
         "pallas_dense", "hybrid", "packet", "bvh", "brute"]


def _load_scene(path: str):
    from .asset.scene_data import SceneData

    if path.endswith(".zip"):
        return SceneData.load(path)
    from .asset.compiler.compiler import compile_scene
    from .asset.wavefront import read_scene

    return compile_scene(read_scene(path))


def quantize(img01: np.ndarray) -> np.ndarray:
    """A [0, 1] float image as the u8 image the CLI writes (truncated)."""
    return (np.clip(img01, 0, 1) * 255).astype(np.uint8)


def _save_png(path: str, img01: np.ndarray) -> None:
    from .utils.png import write_png

    write_png(path, quantize(img01))
    _log.info("wrote %s", path)


def _add_render_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--num-bounces", type=int, default=5)
    p.add_argument("--rr-bounces", type=int, default=3,
                   help="min bounces before Russian roulette")
    p.add_argument("--exposure", type=float, default=1.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", default="auto", choices=MODES, help="traversal backend")
    p.add_argument("--tiles", type=int, default=0,
                   help="shard image rows over this many devices (0 = single)")
    p.add_argument("--sample-shards", type=int, default=1,
                   help="shard spp over this many devices (summed in sample order)")
    p.add_argument("--pool", type=int, default=0,
                   help="worker-pool mode: one feedback-scheduled worker "
                        "thread per device over this many devices "
                        "(≙ reference default renderer + PerfectScheduler)")
    p.add_argument("--out", default="frame.png")
    p.add_argument("--debug", default=None,
                   help="render a debug channel: depth|normals|uv|hitmask|"
                        "instance|emissive_vis|throughput|accumulator")
    p.add_argument("--adaptive", type=float, default=0.0, metavar="TOL",
                   help="adaptive per-block sampling: --spp becomes the "
                        "budget cap; 32x32 blocks stop once the mean 95%% "
                        "CI of per-pixel luminance falls below TOL "
                        "(try 0.02; 0 = off)")
    p.add_argument("--denoise", type=int, default=0, metavar="ITERS",
                   help="edge-avoiding à-trous wavelet denoise of the HDR "
                        "frame before tonemapping, guided by a one-pass "
                        "normal+depth prepass (try 4; 0 = off; the pad "
                        "radius 2*2^(ITERS-1) must stay below the frame's "
                        "larger side)")
    p.add_argument("--regen", action="store_true",
                   help="wavefront path regeneration: a dead lane restarts "
                        "at its own pixel with its next sample index inside "
                        "the render loop (estimator-exact; forward renders "
                        "only)")
    p.add_argument("--rr-tile-coherent", action="store_true",
                   help="draw the Russian-roulette uniform per 32x32 block "
                        "instead of per lane: unbiased, and blocks die "
                        "atomically so late-bounce traversal skips whole "
                        "blocks")
    p.add_argument("--blacklist", "-b", default=None,
                   help="skip devices whose names contain this value "
                        "(≙ reference --blacklist, default.go:243-252)")
    p.add_argument("--force-primary", default=None,
                   help="device-name substring to use as the primary "
                        "(first) device (≙ reference --force-primary, "
                        "default.go:255-266)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="render on the CUDA devices, or on the CPU (the "
                        "plain PyTorch versions of the kernels)")


def _devices(args):
    """``(device, "device name")`` of every device the render may use: each
    CUDA device, or the CPU as often as ``--pool`` or the mesh asks."""
    import torch

    if args.device == "cpu":
        mesh = (args.tiles or 1) * args.sample_shards
        return [(torch.device("cpu"), "cpu")] * max(1, args.pool, mesh)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device available; pass --device cpu to render on the CPU")
    return [
        (torch.device("cuda", i), f"cuda:{i} {torch.cuda.get_device_name(i)}")
        for i in range(torch.cuda.device_count())
    ]


def _select_devices(args):
    """Device selection with blacklist + primary election (the reference's
    initTracers policy, default.go:199-292), matching substrings of
    ``"cuda:0 NVIDIA H100 80GB HBM3"``-style names, case-insensitively.
    Returns an ordered list of torch devices; the first is the primary."""
    devices = _devices(args)
    bl = getattr(args, "blacklist", None)
    if bl:
        kept = [d for d in devices if bl.lower() not in d[1].lower()]
        for d in devices:
            if d not in kept:
                _log.warning("blacklisting device %s", d[1])
        devices = kept
    if not devices:
        # ≙ ErrNoTracers (renderer/errors.go:6-9)
        raise SystemExit("no usable devices after blacklist")
    fp = getattr(args, "force_primary", None)
    if fp:
        match = [i for i, d in enumerate(devices) if fp.lower() in d[1].lower()]
        if not match:
            raise SystemExit(f"no device matches --force-primary {fp!r}")
        devices = [devices[match[0]]] + devices[:match[0]] + devices[match[0] + 1:]
        _log.info("primary device forced to %s", devices[0][1])
    return [d for d, _ in devices]


def _options(args, spp: int):
    from .render.options import RenderOptions

    return RenderOptions(
        width=args.width, height=args.height, spp=spp,
        num_bounces=args.num_bounces, min_bounces_for_rr=args.rr_bounces,
        exposure=args.exposure, seed=args.seed,
        rr_tile_coherent=args.rr_tile_coherent,
    )


def cmd_render_frame(args) -> int:
    from .render.stats import FrameStats, WorkerFrameStats

    opt = _options(args, args.spp)
    if args.regen and (
        args.pool or args.tiles or args.sample_shards > 1 or args.adaptive > 0 or args.debug
    ):
        _log.error(
            "--regen applies to the plain single-device frame path; drop "
            "--pool/--tiles/--sample-shards/--adaptive/--debug"
        )
        return 2
    if args.adaptive > 0 and (args.pool or args.tiles or args.sample_shards > 1):
        _log.error(
            "--adaptive is single-device (per-block variance state lives "
            "with one renderer); drop --pool/--tiles/--sample-shards"
        )
        return 2
    if args.denoise > 0 and (
        args.pool or args.tiles or args.sample_shards > 1 or args.adaptive > 0 or args.debug
    ):
        _log.error(
            "--denoise applies to the plain single-device frame path; drop "
            "--pool/--tiles/--sample-shards/--adaptive/--debug"
        )
        return 2
    if args.denoise > 0 and 2 * 2 ** (args.denoise - 1) >= max(args.width, args.height):
        _log.error(
            "--denoise %d pads by %d pixels, not below the frame's larger side %d",
            args.denoise, 2 * 2 ** (args.denoise - 1), max(args.width, args.height),
        )
        return 2
    devices = _select_devices(args)
    scene = _load_scene(args.scene)

    from .render.integrator import TorchRenderer

    pool = None
    mesh = None
    if args.debug:
        # debug channels are single-device diagnostics; render on the
        # elected primary regardless of pool/mesh flags
        from .render.debug import render_debug

        r = TorchRenderer(scene, device=devices[0], mode=args.mode)
        _save_png(args.out, render_debug(r, opt, args.debug).cpu().numpy())
        return 0
    if args.pool:
        from .parallel.workers import make_device_pool

        pool = make_device_pool(scene, mode=args.mode, devices=devices[: args.pool])
        renderer = pool
        _log.info("worker pool over %d devices", len(pool.workers))
    elif args.tiles or args.sample_shards > 1:
        from .parallel.mesh import DistributedRenderer, make_mesh

        mesh = make_mesh(args.tiles or 1, args.sample_shards, devices=devices)
        renderer = DistributedRenderer(scene, mesh, mode=args.mode)
        _log.info("rendering on mesh %s", dict(mesh.shape))
    else:
        renderer = TorchRenderer(scene, device=devices[0], mode=args.mode, regen=args.regen)

    t0 = time.perf_counter()
    if args.adaptive > 0:
        img_u8, spp_map = renderer.render_adaptive_u8(opt, tol=args.adaptive)
        img = img_u8.astype(np.float32) / 255.0
        _log.info(
            "adaptive: spp min/mean/max %d/%.1f/%d (budget %d)",
            int(spp_map.min()), float(spp_map.mean()), int(spp_map.max()), opt.spp,
        )
    elif args.denoise > 0:
        from .render.denoise import denoise_accum
        from .render.shade import tonemap_reinhard

        accum = denoise_accum(
            renderer, opt, renderer.render_accum(opt), opt.spp, iterations=args.denoise
        )
        img = tonemap_reinhard(accum, 1.0 / opt.spp, opt.exposure).cpu().numpy()
    else:
        img = renderer.render(opt)
    total_ms = (time.perf_counter() - t0) * 1e3
    _save_png(args.out, img)

    if pool is not None:
        # measured per-worker telemetry from the feedback scheduler path
        stats = pool.frame_stats
        stats.total_ms = total_ms
    else:
        stats = FrameStats(total_ms=total_ms)
        if mesh is not None:
            # shards are queued together: report the static row split per
            # tile, no per-device time (cf. reference per-device table,
            # cmd/render.go:82-101)
            rows = args.height // mesh.shape["tile"]
            for row in mesh.devices:
                devs = ", ".join(str(d) for d in row)
                stats.workers.append(
                    WorkerFrameStats(device_id=devs[:28], block_w=args.width, block_h=rows)
                )
        else:
            stats.workers.append(
                WorkerFrameStats(
                    device_id=str(devices[0]),
                    block_w=args.width,
                    block_h=args.height,
                    render_time_ms=renderer.last_render_ms,
                )
            )
        stats.finalize()
    print(stats.table())
    return 0


def cmd_render_progressive(args) -> int:
    """Progressive accumulation: +spp samples per pass, periodic snapshots
    (≙ renderer/opengl.go:136-171 accumulation without the GL window)."""
    from .render.progressive import ProgressiveRenderer

    opt = _options(args, max(1, args.spp))
    if args.adaptive > 0:
        _log.error(
            "--adaptive applies to 'render frame' only; progressive passes "
            "accumulate until --target-spp"
        )
        return 2
    if args.denoise > 0:
        _log.error(
            "--denoise applies to 'render frame' only; progressive "
            "snapshots stay unfiltered"
        )
        return 2
    if args.regen and args.pool:
        _log.error("--regen is single-renderer; drop --pool")
        return 2
    devices = _select_devices(args)
    scene = _load_scene(args.scene)
    pool = None
    if args.pool:
        from .parallel.workers import make_device_pool

        pool = make_device_pool(scene, mode=args.mode, devices=devices[: args.pool])
    prog = ProgressiveRenderer(
        scene, opt, mode=args.mode, pool=pool, regen=args.regen, device=devices[0]
    )
    prog.run(
        target_samples=args.target_spp,
        snapshot_every=args.snapshot_every,
        out=args.out,
        serve_port=args.serve,
    )
    return 0


def cmd_scene_compile(args) -> int:
    from .asset.compiler.compiler import compile_scene
    from .asset.wavefront import read_scene

    t0 = time.perf_counter()
    scene = compile_scene(read_scene(args.scene))
    _log.info("compiled in %.0f ms", (time.perf_counter() - t0) * 1e3)
    out = args.out or os.path.splitext(args.scene)[0] + ".zip"
    t0 = time.perf_counter()
    scene.save(out)
    _log.info("serialized to %s in %.0f ms", out, (time.perf_counter() - t0) * 1e3)
    _print_scene_stats(scene)
    return 0


def _print_scene_stats(scene) -> None:
    print(f"{'Component':<24} {'Count':>10} {'Bytes':>12}")
    print("-" * 48)
    total = 0
    for name, (count, nbytes) in scene.stats().items():
        print(f"{name:<24} {count:>10} {nbytes:>12}")
        total += nbytes
    print("-" * 48)
    print(f"{'TOTAL':<24} {'':>10} {total:>12}")


def cmd_scene_info(args) -> int:
    scene = _load_scene(args.scene)
    _print_scene_stats(scene)
    print(
        f"\ncamera: fov={scene.camera_fov} eye={scene.camera_eye.tolist()} "
        f"look={scene.camera_look.tolist()}"
    )
    return 0


def cmd_devices(args) -> int:
    """List devices (≙ cmd/list_devices.go:13-38). The speed column, the
    first-frame prior of the reference's scheduler, reads n/a: the pool
    starts every worker at the same speed and balances from the second
    frame."""
    import torch

    print(f"{'Device':<8} {'Name':<28} {'CC':>5} {'Memory':>10} {'SMs':>5} {'Speed':>6}")
    print("-" * 67)
    if not torch.cuda.is_available():
        print(f"{'cpu':<8} {'cpu':<28} {'-':>5} {'-':>10} {'-':>5} {'n/a':>6}")
        return 0
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        mem = f"{p.total_memory / 2**30:.1f} GiB"
        print(f"{f'cuda:{i}':<8} {p.name:<28} {f'{p.major}.{p.minor}':>5} {mem:>10} "
              f"{p.multi_processor_count:>5} {'n/a':>6}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    parser = argparse.ArgumentParser(prog="polaris-tpu-torch")
    # -v / -vv verbosity levels (≙ main.go:33-38), --version (main.go:23-24)
    parser.add_argument("-v", action="count", default=0, dest="verbosity")
    parser.add_argument(
        "--version", action="version", version=f"polaris-tpu-torch {__version__}"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_render = sub.add_parser("render", help="render commands")
    rsub = p_render.add_subparsers(dest="rcmd", required=True)

    pf = rsub.add_parser("frame", help="render a single frame")
    pf.add_argument("scene")
    _add_render_opts(pf)
    pf.set_defaults(fn=cmd_render_frame)

    pp = rsub.add_parser("progressive", help="progressive render")
    pp.add_argument("scene")
    _add_render_opts(pp)
    pp.add_argument("--target-spp", type=int, default=256)
    pp.add_argument("--snapshot-every", type=int, default=16)
    pp.add_argument("--serve", type=int, default=0,
                    help="serve live preview on this HTTP port")
    pp.set_defaults(fn=cmd_render_progressive)

    p_scene = sub.add_parser("scene", help="scene commands")
    ssub = p_scene.add_subparsers(dest="scmd", required=True)
    pc = ssub.add_parser("compile", help="compile .obj to a scene artifact")
    pc.add_argument("scene")
    pc.add_argument("--out", default=None)
    pc.set_defaults(fn=cmd_scene_compile)
    pi = ssub.add_parser("info", help="show compiled scene info")
    pi.add_argument("scene")
    pi.set_defaults(fn=cmd_scene_info)

    pd = sub.add_parser("devices", help="list devices")
    pd.set_defaults(fn=cmd_devices)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_level(args.verbosity)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
