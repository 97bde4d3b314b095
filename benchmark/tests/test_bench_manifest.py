"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import os
import re

from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units():
    m = manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in m[k]}) == len(m[k])
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher")
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_configs():
    m = manifest()
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(REPO, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_workloads_have_their_files():
    m = manifest()
    configs = {c["name"] for c in m["configs"]}
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as f:
            spec = json.load(f)
        assert set(spec) == {"check"} and spec["check"]["limits"]  # the rest is BENCHMARK.json's
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.exists(os.path.join(BENCH, "drivers", driver + ".py"))
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)


def test_metrics():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
        assert set(x.get("workloads", cells)) <= cells
    for cell in cells:
        reported = [n for n, x in e2e.items() if cell in x.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in x["workloads"] for x in m["per_layer"])
    for x in m["per_layer"]:
        assert set(x) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(x["layer"]) and x["moves"] in e2e
        for cell in x["workloads"]:
            assert cell in cells and cell in e2e[x["moves"]].get("workloads", cells)
        assert os.path.exists(os.path.join(BENCH, "metrics", x["name"] + ".py"))
