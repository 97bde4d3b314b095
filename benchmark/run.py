"""The benchmark of the PyTorch/CUDA port of polaris (`polaris_tpu_torch`).

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of BENCHMARK.json on the CUDA cards of this machine: it
sets up (scene, renderer, kernels, graphs), measures for ``--seconds``,
checks what the measured window produced against the plain reference, and
prints one JSON line last on standard output. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
profile of the window's first units. Without enough CUDA cards it exits 1
and prints no result. Every cache it writes is under ``benchmark/.cache/``
or the package's own ``build/`` directory, inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    for path in (HERE, REPO):
        if path not in sys.path:
            sys.path.insert(0, path)

    from harness import cells, device, runner

    cell = cells.cell(args.workload)
    device.require_cards(int(cell.entry["chips"]))
    result = runner.run(args.workload, args.seed, args.seconds, bool(args.trace))
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
