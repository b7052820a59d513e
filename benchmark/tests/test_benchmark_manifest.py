"""BENCHMARK.json against the rules of its format, and against the files
the harness finds by name; each check also on the manifest with the cells
it holds back (tests/data/held_cells.json) put back, so that they can
return by entries alone."""

import json
import math
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
from reference import models  # noqa: E402

sys.path.insert(0, str(BENCH / "tests"))
import walk  # noqa: E402

COMMITTED = json.loads((ROOT / "BENCHMARK.json").read_text())
MANIFESTS = {"committed": COMMITTED, "with_held_cells": walk.with_held_cells(COMMITTED)}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$|per_tok)")


@pytest.fixture(params=sorted(MANIFESTS))
def bench(request):
    return MANIFESTS[request.param]


def cells(bench):
    return [w["name"] for w in bench["workloads"]]


def test_top_level_keys_and_command(bench):
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_names_units_and_keys(bench):
    cell_names = cells(bench)
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    names += cell_names
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names if n not in cell_names)) == len(names) - len(cell_names)
    assert len(set(cell_names)) == len(cell_names)
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]


def test_every_cell_one_chip_and_reports_what_it_must(bench):
    e2e = bench["end_to_end"]
    pairs = set()
    for w in bench["workloads"]:
        assert w["chips"] == 1
        pairs.add((w["config"], w["traffic"]))
        mine = [m["name"] for m in e2e if harness.applies(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in bench["per_layer"] if harness.applies(m, w["name"])]
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in mine, (w["name"], m["name"])
    assert len(pairs) == len(bench["workloads"])


def test_moves_and_workloads_lists_name_what_exists(bench):
    cell_names = cells(bench)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cell_names)) <= set(cell_names)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cell_names))


MANIFEST = MANIFESTS["with_held_cells"]


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_each_metric_reader_agrees_with_the_manifest(metric):
    entry = next(m for m in MANIFEST["per_layer"] if m["name"] == metric)
    mod = harness.load_module("metrics", f"{metric}.py")
    assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
    layers = {m["layer"] for m in MANIFEST["per_layer"] if m["layer"].lower() == entry["layer"].lower()}
    assert len(layers) == 1


@pytest.mark.parametrize("cell", cells(MANIFEST))
def test_cell_files_are_found_by_name_and_agree(cell):
    wl, config, traffic = harness.cell_files(cell)
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    assert all(wl[k] == entry[k] for k in ("config", "traffic", "chips", "why"))
    if cell in cells(COMMITTED):
        assert harness.cell_spec(cell)[:3] == (wl, config, traffic)
    assert (BENCH / "traffic" / f"{traffic['kind']}.py").exists()
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())
    conf = next(c for c in MANIFEST["configs"] if c["name"] == wl["config"])
    assert conf["file"] == f"benchmark/configs/{wl['config']}.json"
    assert conf["reduced"] == config["reduced"] == []
    assert not any(WIDTHS.search(k) for k in conf["reduced"])


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_configs_hold_the_published_parameter_count(config):
    import system

    cfg = harness.load_json("configs", f"{config}.json")
    spec = models.param_spec(cfg, system._reference_shapes(cfg))
    params = sum(math.prod(s) for n, s, _ in spec if not n.endswith(("running_mean", "running_var")))
    assert params == cfg["parameters"]
    assert len(spec) and cfg["buckets"] == len(system._reference_shapes(cfg))
