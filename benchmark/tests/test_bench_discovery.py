"""A cell, its traffic, a driver and a per-layer metric are found by name:
adding them adds files and entries, and edits no file of the harness."""

import json
import os

import torch

from harness import cells, runner


def add(bd, kind, name, text):
    path = os.path.join(bd, kind, name)
    with open(path, "w") as f:
        f.write(text)


def test_a_new_cell_runs_from_its_files_alone(small_bench):
    bd = small_bench
    man_path = os.path.join(os.path.dirname(bd), "BENCHMARK.json")
    man = json.load(open(man_path))
    add(bd, "traffic", "frames_16sq_2spp.json", json.dumps(
        {"driver": "frame", "width": 16, "height": 16, "spp": 2, "why": "a tiny frame"}
    ))
    add(bd, "workloads", "sphere-tiny.json", json.dumps({
        "check": {"frames": 1, "pixels": 64, "limits": {"pixels_off_pct": 1.0, "mean_abs_levels": 0.1}},
    }))
    add(bd, "drivers", "echo.py", "class Driver:\n    metric = 'frame_ms'\n")
    add(bd, "metrics", "units_seen.frame.py", "def read(r):\n    return float(r.trace.units)\n")
    man["workloads"].append({"name": "sphere-tiny", "config": "sphere", "traffic": "frames_16sq_2spp",
                             "chips": 1, "why": "a tiny cell"})
    for m in man["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append("sphere-tiny")
    man["per_layer"].append({"name": "units_seen.frame", "unit": "count", "better": "higher",
                             "source": "program_counter", "layer": "device", "moves": "frame_ms",
                             "workloads": ["sphere-tiny"]})
    with open(man_path, "w") as f:
        json.dump(man, f)

    c = cells.cell("sphere-tiny", bench_dir=bd)
    assert c.traffic["width"] == 16 and c.config["scene"] == {"obj": "scenes/sphere.obj"}
    assert [m["name"] for m in c.per_layer] == ["units_seen.frame"]
    assert {m["name"] for m in c.end_to_end} == {"frame_ms", "setup_s"}
    assert cells.module("drivers", "echo", bd).Driver.metric == "frame_ms"
    reader = cells.module("metrics", "units_seen.frame", bd)
    assert reader.read(runner.Reading(ctx=None, driver=None, trace=type("T", (), {"units": 3})())) == 3.0

    torch.set_num_threads(2)
    out = runner.run("sphere-tiny", 2**32 + 7, 0.5, False, device="cpu", bench_dir=bd)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}
    assert list(out)[-1] == "checks"
