"""Where the benchmark's data lives, found by name.

`BENCHMARK.json` at the root of the checkout lists the metrics and the
cells, each with its configuration, traffic, chips and why. Each cell has a
file `workloads/<cell>.json` with what only it holds: the sizes and limits
of its output check. A configuration is `configs/<config>.json`; a traffic
mix is `traffic/<traffic>.json`, whose `driver` names `drivers/<driver>.py`;
a per-layer metric is read by `metrics/<metric>.py`. Adding any of them
adds a file and an entry, and edits none.

A configuration names its plain reference: `"reference": "<module>"` is the
module `reference/<module>.py`, imported as `reference.<module>` (so it may
import its siblings, as `from .pathtracer import ...`); without the key it
is `pathtracer`. `scenes.reference(config)` gives the module and its scene,
and every reader of the reference goes through it: the frame driver's
`reference_u8` (the frame check and `control.py`), the step driver's
`reference_steps` (the step check and `control.py`) and the traversal
roofline's probe (`metrics/traversal_roofline_pct.frame.py`). A
configuration whose scene `pathtracer` cannot render brings a module of its
own; the `frame` driver and its traffic serve it unchanged. The module
exports what those readers use, and the harness uses nothing more:

- `load_scene(config, bench_dir)`: the configuration's scene, its files
  named under ``bench_dir`` (the harness's `BENCH_DIR`, where the program's
  scene is read too). The harness reads of it
  `v0`, `e1`, `e2` (float32 (T, 3): each triangle's first vertex and its
  two edges, which `roofline/bvh.py::build` and the roofline's walk take),
  `num_tris`, and the camera: `eye` (float32 (3,)) and `frustum(width,
  height)` (float32 (4, 3), the corner rays TL, TR, BL, BR minus the eye).
  The materials and the light table (in `pathtracer`, `light_tri` and
  `light_area`, the emissive triangles) are read by the module's own
  `RefRenderer` alone, in whatever form it keeps them.
- `Integrator(num_bounces, min_bounces_for_rr, exposure)`.
- `RefRenderer(scene, bvh, device, dtype)`, ``bvh`` being
  `roofline/bvh.py::build(v0, e1, e2)` and ``dtype`` float32 (the
  reference) or bfloat16 (the control), with
  `render_frames(seeds, pix, width, height, spp, integrator)`: the summed
  radiance [F, n, 3] of ``pix`` in each frame of seed ``seeds[f]``;
  `params(requires_grad)`: the leaves the step check follows, named as the
  program's `Trainer.trainable` leaves, every leaf that
  `reference/adam.py::BOUNDS` names among them (its `project` clamps
  them); and
  `loss(P, seed, target, width, height, spp, integrator)`.
- `to_u8(accum, spp, exposure)`: the u8 frame of a summed radiance.
- `primary_rays(seed, pix, px, py, s, width, height, frustum, eye, dtype)`:
  the (origins, directions) of sample ``s`` of pixels ``pix``.
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
