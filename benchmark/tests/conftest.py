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


# the sizes of every traffic file in a copy for runs on the CPU, set by the
# file's own keys: one that trains (it names an optimizer) renders smaller
# frames of fewer samples; a driver's name is never looked up
FRAME = dict(width=32, height=32, spp=4)
TRAIN = dict(width=24, height=24, spp=2)


def small_copy(dest, src=BENCH):
    """A copy of the benchmark ``src`` at ``dest``/benchmark with its traffic
    at the sizes above and every terrain of 24x24 cells;
    the repository's `BENCHMARK.json` sits beside it. Returns its directory."""
    bd = dest / "benchmark"
    shutil.copytree(src, bd, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest / "BENCHMARK.json")
    for f in (bd / "traffic").iterdir():
        d = json.loads(f.read_text())
        d.update(TRAIN if "optimizer" in d else FRAME)
        f.write_text(json.dumps(d))
    for f in (bd / "configs").iterdir():
        d = json.loads(f.read_text())
        if "terrain_grid" in d["scene"]:
            d["scene"]["terrain_grid"] = 24
            f.write_text(json.dumps(d))
    return str(bd)


@pytest.fixture
def small_bench(tmp_path):
    """A copy of the benchmark whose traffic renders 32x32 frames of 4
    samples and 24x24 loss steps of 2, on a terrain of 24x24 cells, for runs
    on the CPU. Returns its `benchmark/` directory; `BENCHMARK.json` sits
    beside it."""
    return small_copy(tmp_path)
