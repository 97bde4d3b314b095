"""The benchmark's own tests, on the CPU: `python -m pytest benchmark/tests`."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def small_bench(tmp_path):
    """A copy of the benchmark whose traffic renders 32x32 frames of 4
    samples and 24x24 loss steps of 2, on a terrain of 24x24 cells, for runs
    on the CPU. Returns its `benchmark/` directory; `BENCHMARK.json` sits
    beside it."""
    bd = tmp_path / "benchmark"
    shutil.copytree(BENCH, bd, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    sizes = {"frame": dict(width=32, height=32, spp=4), "step": dict(width=24, height=24, spp=2)}
    for f in (bd / "traffic").iterdir():
        d = json.loads(f.read_text())
        d.update(sizes[d["driver"]])
        f.write_text(json.dumps(d))
    for f in (bd / "configs").iterdir():
        d = json.loads(f.read_text())
        if "terrain_grid" in d["scene"]:
            d["scene"]["terrain_grid"] = 24
            f.write_text(json.dumps(d))
    return str(bd)
