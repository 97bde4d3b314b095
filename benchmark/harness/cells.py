"""Where the benchmark's data lives, found by name.

`BENCHMARK.json` at the root of the checkout lists the metrics and the
cells, each with its configuration, traffic, chips and why. Each cell has a
file `workloads/<cell>.json` with what only it holds: the sizes and limits
of its output check. A configuration is `configs/<config>.json`; a traffic
mix is `traffic/<traffic>.json`, whose `driver` names `drivers/<driver>.py`;
a per-layer metric is read by `metrics/<metric>.py`. Adding any of them
adds a file and an entry, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


def manifest(repo: str = REPO) -> dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        return json.load(f)


def data(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    path = os.path.join(bench_dir, kind, name + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """The module `<kind>/<name>.py`, loaded from its file (a metric's name
    may hold dots)."""
    path = os.path.join(bench_dir, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    spec: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(name: str, man: dict = None, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` with its files and the metrics it reports."""
    man = man if man is not None else manifest(os.path.dirname(bench_dir))
    entries: Dict[str, dict] = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [
        m for m in man["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)
    ]
    return Cell(
        name=name, entry=entry, spec=data("workloads", name, bench_dir), config=data("configs", entry["config"], bench_dir),
        traffic=data("traffic", entry["traffic"], bench_dir), end_to_end=e2e, per_layer=per_layer,
    )
