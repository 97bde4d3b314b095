"""The port's command line (``polaris_tpu_torch/cli.py``) against the JAX
package's (``polaris_tpu/cli.py``), on the CPU.

* The parsers: the same commands, flags, ``--mode`` choices and defaults,
  read from both ``--help`` outputs and from the parsed arguments. The port
  adds one flag, ``--device {cuda,cpu}`` (the JAX CLI picks its platform
  through ``JAX_PLATFORMS``), and one ``--mode`` choice, 'pallas8_nodes',
  the big-scene kernel that the JAX CLI leaves out.
* The cases of ``tests/test_scheduler_cli.py``, run in-process through
  ``main([...])`` with ``--device cpu``: ``devices``, compile / info /
  render, adaptive, a debug channel, the pool's and the mesh's rows, device
  selection and the rejection of multi-device flags.
* A deliberate divergence: ``--denoise ITERS`` is range-checked (exit 2 when
  the pad radius 2 * 2**(ITERS - 1) reaches the frame's larger side), where
  the JAX CLI takes any value (ROADMAP, "Known reference faults").
* Without a card and without ``--device cpu`` the CLI refuses to run and
  names the flag; importing the CLI imports no ``torch`` (so no CUDA state)
  and no ``jax``.
* One run of ``python -m polaris_tpu_torch.cli`` in a subprocess, its PNG
  equal to the in-process render quantized as the CLI quantizes.
"""

import argparse
import logging
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import polaris_tpu.cli as jcli  # noqa: E402
import polaris_tpu_torch.cli as tcli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMANDS = [["render", "frame"], ["render", "progressive"], ["scene", "compile"],
            ["scene", "info"], ["devices"]]
SMALL = ["--width", "32", "--height", "32", "--spp", "1", "--num-bounces", "2"]


def _help(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv + ["--help"])
    assert e.value.code == 0
    return capsys.readouterr().out


def _flags(text):
    """The option strings of a ``--help`` output's options section."""
    options = text.split("options:", 1)[1]
    return set(re.findall(r"(?<![\w-])(--?[a-z][\w-]*)", options))


def _parsed(cli, argv, monkeypatch):
    """The namespace ``cli.main(argv)`` hands its command, the command
    itself stubbed out."""
    seen = {}
    for name in ("cmd_render_frame", "cmd_render_progressive", "cmd_scene_compile",
                 "cmd_scene_info", "cmd_devices"):
        monkeypatch.setattr(cli, name, lambda args: seen.update(vars(args)) or 0)
    assert cli.main(argv) == 0
    seen.pop("fn")
    return seen


@pytest.mark.parametrize("command", COMMANDS, ids=[" ".join(c) for c in COMMANDS])
def test_parser_matches_jax(command, capsys, monkeypatch):
    jax_help = _help(jcli.main, command, capsys)
    port_help = _help(tcli.main, command, capsys)
    extra = {"--device"} if command[0] == "render" else set()
    assert _flags(port_help) == _flags(jax_help) | extra
    if command[0] == "render":
        jax_modes = re.search(r"--mode \{([^}]*)\}", jax_help).group(1).split(",")
        port_modes = re.search(r"--mode \{([^}]*)\}", port_help).group(1).split(",")
        assert sorted(port_modes) == sorted(jax_modes + ["pallas8_nodes"])
        assert "--device {cuda,cpu}" in port_help
    argv = command + (["s.obj"] if command[0] != "devices" else [])
    want = _parsed(jcli, argv, monkeypatch)
    got = _parsed(tcli, argv, monkeypatch)
    if command[0] == "render":
        assert got.pop("device") == "cuda"
    assert got == want


def test_top_level_matches_jax(capsys):
    jax_help = _help(jcli.main, [], capsys)
    port_help = _help(tcli.main, [], capsys)
    assert "{render,scene,devices}" in jax_help and "{render,scene,devices}" in port_help
    assert _flags(port_help) == _flags(jax_help)
    with pytest.raises(SystemExit):
        tcli.main(["--version"])
    assert capsys.readouterr().out.strip() == "polaris-tpu-torch 0.1.0"


def test_cli_imports_no_torch_and_the_jax_cli_no_jax():
    code = (
        "import sys, polaris_tpu.cli, polaris_tpu_torch.cli; "
        "assert 'jax' not in sys.modules and 'torch' not in sys.modules, "
        "sorted(m for m in sys.modules if m in ('jax', 'torch'))"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.fixture
def log_lines():
    """The messages of the ``polaris`` loggers during a test."""
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    root = logging.getLogger("polaris")
    root.addHandler(handler)
    yield lines
    root.removeHandler(handler)


def test_cli_devices(capsys):
    assert tcli.main(["devices"]) == 0
    out = capsys.readouterr().out
    assert ("cuda:0" in out) if torch.cuda.is_available() else ("cpu" in out)
    assert "n/a" in out


def test_cli_scene_compile_info_and_render(tmp_path, scenes_dir, capsys):
    obj = os.path.join(scenes_dir, "cornell.obj")
    assert tcli.main(["scene", "compile", obj, "--out", str(tmp_path / "c.zip")]) == 0
    assert (tmp_path / "c.zip").exists()
    assert "BVH nodes" in capsys.readouterr().out
    assert tcli.main(["scene", "info", str(tmp_path / "c.zip")]) == 0
    assert "Triangles" in capsys.readouterr().out
    out = tmp_path / "f.png"
    assert tcli.main(["render", "frame", str(tmp_path / "c.zip"), *SMALL, "--mode", "bvh",
                      "--device", "cpu", "--out", str(out)]) == 0
    assert out.exists()
    assert "TOTAL" in capsys.readouterr().out


def test_cli_adaptive_render(tmp_path, scenes_dir, log_lines):
    obj = os.path.join(scenes_dir, "cornell.obj")
    assert tcli.main([
        "-v", "render", "frame", obj, "--width", "64", "--height", "64", "--spp", "8",
        "--num-bounces", "2", "--mode", "bvh", "--adaptive", "0.3", "--device", "cpu",
        "--out", str(tmp_path / "a.png"),
    ]) == 0
    assert (tmp_path / "a.png").exists()
    assert any("adaptive: spp min/mean/max" in line for line in log_lines)


def test_cli_debug_channel(tmp_path, scenes_dir):
    obj = os.path.join(scenes_dir, "cornell.obj")
    assert tcli.main(["render", "frame", obj, "--width", "32", "--height", "32", "--mode",
                      "bvh", "--debug", "normals", "--device", "cpu",
                      "--out", str(tmp_path / "n.png")]) == 0
    assert (tmp_path / "n.png").exists()


def test_cli_render_pool_reports_measured_times(tmp_path, scenes_dir, capsys):
    obj = os.path.join(scenes_dir, "cornell.obj")
    assert tcli.main(["render", "frame", obj, *SMALL, "--mode", "bvh", "--pool", "2",
                      "--device", "cpu", "--out", str(tmp_path / "p.png")]) == 0
    # two worker rows, each with its own measured time (not one shared value)
    out = capsys.readouterr().out
    rows = [line for line in out.splitlines() if " ms" in line and "TOTAL" not in line]
    assert len(rows) == 2, out


def test_cli_render_mesh_no_fabricated_times(tmp_path, scenes_dir, capsys):
    obj = os.path.join(scenes_dir, "cornell.obj")
    assert tcli.main(["render", "frame", obj, *SMALL, "--mode", "bvh", "--tiles", "2",
                      "--device", "cpu", "--out", str(tmp_path / "m.png")]) == 0
    out = capsys.readouterr().out
    assert out.count("(spmd)") == 2, out


def test_device_selection_blacklist_and_primary(monkeypatch):
    """Blacklist + primary election (≙ initTracers policy,
    default.go:199-292) over ``"cuda:i <name>"``, here on two stand-in
    cards, and over the repeated CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: ["NVIDIA H100", "NVIDIA L4"][i])

    def ns(**kw):
        return argparse.Namespace(**{**dict(blacklist=None, force_primary=None, device="cuda",
                                            pool=0, tiles=0, sample_shards=1), **kw})

    assert tcli._select_devices(ns()) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert tcli._select_devices(ns(force_primary="nvidia l4")) == [
        torch.device("cuda", 1), torch.device("cuda", 0)]
    assert tcli._select_devices(ns(blacklist="H100")) == [torch.device("cuda", 1)]
    with pytest.raises(SystemExit):
        tcli._select_devices(ns(blacklist="nvidia"))
    with pytest.raises(SystemExit):
        tcli._select_devices(ns(force_primary="gpu999"))
    assert tcli._select_devices(ns(device="cpu", tiles=2, sample_shards=2)) == (
        [torch.device("cpu")] * 4)
    with pytest.raises(SystemExit):
        tcli._select_devices(ns(device="cpu", blacklist="cpu"))


def test_cli_adaptive_rejects_multi_device_flags(tmp_path, scenes_dir, log_lines):
    obj = os.path.join(scenes_dir, "cornell.obj")
    assert tcli.main(["render", "frame", obj, "--width", "32", "--height", "32", "--spp", "2",
                      "--mode", "bvh", "--adaptive", "0.1", "--pool", "2", "--device", "cpu",
                      "--out", str(tmp_path / "x.png")]) == 2
    assert any("adaptive" in line for line in log_lines)


@pytest.mark.parametrize("iters,rc", [(4, 0), (5, 2)])
def test_cli_denoise_is_range_checked(tmp_path, scenes_dir, iters, rc, log_lines):
    """At 32x32, 4 levels pad by 16 pixels and render; 5 pad by 32, which
    the JAX CLI would take, and the port refuses with exit 2."""
    obj = os.path.join(scenes_dir, "cornell.obj")
    out = tmp_path / "d.png"
    assert tcli.main(["render", "frame", obj, *SMALL, "--denoise", str(iters),
                      "--device", "cpu", "--out", str(out)]) == rc
    assert out.exists() == (rc == 0)
    assert any("--denoise 5 pads by 32" in line for line in log_lines) == (rc == 2)


def test_cli_refuses_without_a_card_unless_told_cpu(tmp_path, scenes_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obj = os.path.join(scenes_dir, "cornell.obj")
    with pytest.raises(SystemExit) as e:
        tcli.main(["render", "frame", obj, *SMALL, "--out", str(tmp_path / "x.png")])
    assert "--device cpu" in str(e.value.code)
    assert not (tmp_path / "x.png").exists()


def test_cli_progressive_writes_its_snapshot(tmp_path, scenes_dir):
    obj = os.path.join(scenes_dir, "cornell.obj")
    out = tmp_path / "pr.png"
    assert tcli.main(["render", "progressive", obj, *SMALL, "--target-spp", "2",
                      "--snapshot-every", "1", "--device", "cpu", "--out", str(out)]) == 0
    assert out.exists()


def test_module_run_writes_the_in_process_image(tmp_path, scenes_dir):
    from PIL import Image

    from polaris_tpu_torch.asset.compiler.compiler import compile_scene
    from polaris_tpu_torch.asset.wavefront import read_scene
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    obj = os.path.join(scenes_dir, "sphere.obj")
    out = tmp_path / "s.png"
    r = subprocess.run(
        [sys.executable, "-m", "polaris_tpu_torch.cli", "render", "frame", obj, *SMALL,
         "--regen", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")),
    )
    assert r.returncode == 0, r.stderr
    assert "TOTAL" in r.stdout
    opt = RenderOptions(width=32, height=32, spp=1, num_bounces=2)
    scene = compile_scene(read_scene(obj))
    want = tcli.quantize(TorchRenderer(scene, device="cpu", regen=True).render(opt))
    np.testing.assert_array_equal(np.asarray(Image.open(out).convert("RGB")), want)
