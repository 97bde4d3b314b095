"""A configuration names its plain reference (`harness/cells.py`): a
configuration with a module of its own is added by new files and entries
alone, the default is `reference/pathtracer.py` on `reference/scene.py`'s
scene, and a module that is not there is named in the error."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO
from harness import cells, runner, scenes
from roofline.bvh import build

SEED = 2**31 + 1717

MIRROR = '''"""`pathtracer` under another name; it notes each scene it loads."""

import os

from .pathtracer import Integrator, RefRenderer, primary_rays, to_u8
from .pathtracer import load_scene as _load_scene


def load_scene(config, bench_dir):
    with open(os.path.join(os.path.dirname(__file__), "mirror.used"), "a") as f:
        f.write(config["name"] + " " + bench_dir + "\\n")
    return _load_scene(config, bench_dir)
'''

RUN = '''
import json, sys
sys.path[:0] = [{bd!r}, {repo!r}]
import torch
torch.set_num_threads(2)
from harness import cells, runner, scenes
from roofline.probe import probe_rays
assert cells.BENCH_DIR == {bd!r}, cells.BENCH_DIR
out = runner.run("sphere_mirror-frame", {seed}, 0.5, False, device="cpu")
ref, rs = scenes.reference(cells.cell("sphere_mirror-frame").config)
rays = probe_rays(ref, rs, 8, 8, {seed}, "cpu")
out["probe"] = [[name, list(o.shape)] for name, (o, d) in rays]
print(json.dumps(out))
'''


def test_a_configuration_brings_its_own_reference(small_bench):
    bd = small_bench
    with open(os.path.join(bd, "reference", "mirror.py"), "w") as f:
        f.write(MIRROR)
    with open(os.path.join(bd, "configs", "sphere.json")) as f:
        cfg = json.load(f)
    cfg.update(name="sphere_mirror", reference="mirror")
    with open(os.path.join(bd, "configs", "sphere_mirror.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bd, "workloads", "sphere-frame.json")) as f:
        spec = f.read()
    with open(os.path.join(bd, "workloads", "sphere_mirror-frame.json"), "w") as f:
        f.write(spec)
    man_path = os.path.join(os.path.dirname(bd), "BENCHMARK.json")
    with open(man_path) as f:
        man = json.load(f)
    man["configs"].append(dict(man["configs"][0], name="sphere_mirror", file="benchmark/configs/sphere_mirror.json"))
    man["workloads"].append({"name": "sphere_mirror-frame", "config": "sphere_mirror",
                             "traffic": "frames_1024sq_16spp", "chips": 1, "why": "sphere, checked by its own reference"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "sphere-frame" in m.get("workloads", []):
            m["workloads"].append("sphere_mirror-frame")
    with open(man_path, "w") as f:
        json.dump(man, f)

    # the copy's own harness, as a checkout runs it: nothing of it is edited
    code = RUN.format(bd=bd, repo=REPO, seed=SEED)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(bd))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] >= 1, out["checks"]
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}
    assert out["probe"] == [["primary", [64, 3]], ["bounce", [64, 3]]]
    with open(os.path.join(bd, "reference", "mirror.used")) as f:
        # the check, then the probe; both read the copy's scene, as the program does
        assert f.read().splitlines() == [f"sphere_mirror {bd}"] * 2


def direct_u8(cell, opt, frame_seeds, pixels):
    """The sphere frame check's reference as `reference.pathtracer` and
    `reference.scene.read_obj` give it, called directly."""
    from reference.pathtracer import Integrator, RefRenderer, to_u8
    from reference.scene import read_obj

    cfg = cell.config
    rs = read_obj(os.path.join(BENCH, cfg["scene"]["obj"]))
    ref = RefRenderer(rs, build(rs.v0, rs.e1, rs.e2), "cpu", torch.float32)
    integ = Integrator(cfg["num_bounces"], cfg["min_bounces_for_rr"], cfg["exposure"])
    acc = ref.render_frames(frame_seeds, torch.from_numpy(pixels), opt.width, opt.height, opt.spp, integ)
    return to_u8(acc.float(), opt.spp, opt.exposure).numpy().astype(np.int64)


def test_the_default_frame_check_is_pathtracers(small_bench):
    torch.set_num_threads(2)
    cell = cells.cell("sphere-frame", bench_dir=small_bench)
    assert "reference" not in cell.config
    frame = cells.module("drivers", "frame", small_bench)
    drv = frame.Driver(runner.Context(cell=cell, seed=SEED, device=torch.device("cpu")))
    for i in range(3):
        drv.run(i)
    drv.close()
    numbers, compared = drv.check()
    picked = drv.picked()
    want = direct_u8(cell, drv.opt, [drv.frame_seed(int(f)) for f in picked], drv.pixels)
    got = np.stack([drv.kept[f] for f in picked]).astype(np.int64)
    assert numbers == frame.compare(got, want, cell.spec["check"]["limits"])
    assert compared == len(picked) == 2


def test_the_default_step_check_is_pathtracers(small_bench, monkeypatch):
    import reference.pathtracer
    from reference.scene import read_obj

    torch.set_num_threads(2)
    cell = cells.cell("sphere-grad", bench_dir=small_bench)
    assert "reference" not in cell.config
    step = cells.module("drivers", "step", small_bench)
    drv = step.Driver(runner.Context(cell=cell, seed=SEED, device=torch.device("cpu")))
    drv.run(0)
    drv.close()
    numbers = drv.check()
    direct = read_obj(os.path.join(BENCH, cell.config["scene"]["obj"]))
    monkeypatch.setattr(scenes, "reference", lambda config: (reference.pathtracer, direct))
    assert drv.check() == numbers


@pytest.mark.parametrize("name, error", [("no_such_reference", ModuleNotFoundError), ("../pathtracer", ValueError)])
def test_a_reference_that_is_not_there_is_named(small_bench, name, error):
    cfg = dict(cells.cell("sphere-frame", bench_dir=small_bench).config, reference=name)
    with pytest.raises(error, match=f"'sphere'.*{name}"):
        scenes.reference(cfg)


def test_a_run_of_a_missing_reference_fails_naming_it(small_bench):
    path = os.path.join(small_bench, "configs", "sphere.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(cfg, reference="no_such_reference"), f)
    torch.set_num_threads(2)
    with pytest.raises(ModuleNotFoundError, match="no_such_reference"):
        runner.run("sphere-frame", SEED, 0.2, False, device="cpu", bench_dir=small_bench)
