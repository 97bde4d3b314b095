"""The `mitsuba` configuration and its cell `mitsuba-frame`, on the CPU at
the small sizes of `small_bench`: the cell is correct against its own
reference (`reference/microfacet.py`), the control and the faults fail
its limits, the scene files are the repository's, the reference refuses
what it does not render, and the shading roofline's bytes and reader."""

import json
import os

import pytest
import torch

import control
from conftest import BENCH, REPO
from harness import cells, runner, trace
from reference import microfacet
from roofline import shade

SEED = 2**31 + 1818
CELL = "mitsuba-frame"


def over(readings, lim):
    return [k for k, v in readings.items() if not v <= lim[k]]


def test_the_cell_is_correct(small_bench):
    torch.set_num_threads(2)
    out = runner.run(CELL, SEED, 0.5, False, device="cpu", bench_dir=small_bench)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}


def test_control_and_faults_fail(small_bench):
    torch.set_num_threads(2)
    cell = cells.cell(CELL, bench_dir=small_bench)
    ctx = runner.Context(cell=cell, seed=SEED, device=torch.device("cpu"))
    frame = cells.module("drivers", "frame", small_bench)
    out = control.frame_readings(frame, frame.Driver(ctx), SEED, True, True, fault=True)
    lim = cell.spec["check"]["limits"]
    assert over(out["program"], lim) == []
    for kind in ("control", "half_batch", "state_unchanged"):
        assert over(out[kind], lim), (kind, out[kind])


@pytest.mark.parametrize("name", ["mitsuba.obj", "mitsuba.mtl", "checker.png"])
def test_scene_files_are_the_repositorys(name):
    with open(os.path.join(REPO, "scenes", name), "rb") as a, \
            open(os.path.join(BENCH, "scenes", name), "rb") as b:
        assert a.read() == b.read()


def test_the_configuration_names_its_reference():
    cfg = cells.cell(CELL).config
    assert cfg["reference"] == "microfacet" and cfg["triangles"] == 2564
    rs = microfacet.load_scene(cfg, cells.BENCH_DIR)
    assert rs.num_tris == cfg["triangles"]


@pytest.mark.parametrize("expr, named", [
    ('conductor(specularity: {0.9, 0.9, 0.9})', "conductor"),
    ('dielectric(intIOR: "Glass")', "dielectric"),
    ('mix(diffuse(reflectance: {0.5, 0.5, 0.5}), emissive(radiance: {1, 1, 1}, scale: 2), 0.5)', "mix"),
    ('roughConductor(specularity: {0.9, 0.7, 0.3}, roughness: 0.25, radiance: {1, 1, 1})', "radiance"),
    ('roughDielectric(intIOR: "Unobtainium")', "Unobtainium"),
    ('emissive(radiance: "sky.png", scale: 3)', "radiance"),
])
def test_the_reference_refuses_what_it_does_not_render(tmp_path, expr, named):
    with open(tmp_path / "s.mtl", "w") as f:
        f.write(f"newmtl m\nmat_expr {expr}\n")
    with open(tmp_path / "s.obj", "w") as f:
        f.write("mtllib s.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl m\nf 1 2 3\n")
    with pytest.raises(ValueError, match=named):
        microfacet.load_scene({"scene": {"obj": "s.obj"}}, str(tmp_path))


def test_the_byte_bound_of_a_hand_worked_census():
    # reads: the hit (t, u, v, triangle, instance: 5 x 4, mask 1), the ray
    # (2 x 12), the path (alive 1, throughput 12, flags 4, radiance 12);
    # writes: the next ray (2 x 12 + mask 1), the shadow ray (2 x 12 +
    # length 4), the NEE value and mask (12 + 1), the path (12 + 4 + 12)
    assert shade.LANE_BYTES == (21 + 24 + 29) + (25 + 28 + 13 + 28) == 168
    census = [{"alive": 1000, "surface": 900}, {"alive": 600}, {"alive": 0}, {"alive": 25}]
    b = shade.bound(census)
    assert b["bytes"] == 1625 * 168
    assert b["bound_s"] == pytest.approx(1625 * 168 / 3.35e12)
    assert shade.roofline_pct(census, 2 * b["bound_s"]) == pytest.approx(50.0)


def _reading(bd, kernels):
    cell = cells.cell(CELL, bench_dir=bd)
    ctx = runner.Context(cell=cell, seed=SEED, device=torch.device("cpu"))
    drv = cells.module("drivers", "frame", bd).Driver(ctx)
    summary = trace.Summary(span_s=1.0, busy_s=0.5, units=2, kernels=kernels, copies={})
    return runner.Reading(ctx=ctx, driver=drv, trace=summary)


def test_the_roofline_reader(small_bench, monkeypatch, capsys):
    """The share from a census frame of the cell's own renderer over the
    kernel's time in the trace; nothing where the trace lacks the kernel or
    the program lacks the census (the parent's tree)."""
    torch.set_num_threads(2)
    reader = cells.module("metrics", "shade_bounce_roofline_pct.frame", small_bench)
    kernel = "polaris_shade::shade_bounce_kernel(polaris_shade::ShadeArgs)"
    r = _reading(small_bench, {kernel: (10, 0.004)})  # 2 ms a frame
    pct = reader.read(r)
    line = [x for x in capsys.readouterr().err.splitlines() if x.startswith("shade census ")][-1]
    got = json.loads(line[len("shade census "):])
    rows = got["bounces"]
    n = 32 * 32 * 4
    assert rows[0]["alive"] == n and all(x["alive"] == x["surface"] + x["emitter"] + x["miss"] for x in rows)
    assert pct == pytest.approx(100.0 * shade.bound(rows)["bound_s"] / 2e-3)
    assert got["total"]["textured"] > 0 and got["total"]["rough_dielectric_refract"] > 0

    assert reader.read(_reading(small_bench, {"void at::native::add<...>": (10, 0.004)})) is None
    from polaris_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "shade_census")
    assert reader.read(r) is None
