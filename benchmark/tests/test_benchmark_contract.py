"""BENCHMARK.json's format: keys, names, units, bounds, and a file for
every name it gives."""

import ast
import json
import os
import re

import pytest

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
HERE = os.path.join(ROOT, "benchmark")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_allowed_and_unique(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    e2e = {x["name"] for x in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    keys = set(m) - {"workloads"}
    if m["name"] in e2e:
        assert keys == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert keys == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in e2e
        moved = next(x for x in BENCH["end_to_end"]
                     if x["name"] == m["moves"])
        for c in m["workloads"]:
            assert c in moved.get("workloads", cells)
    assert set(m.get("workloads", cells)) <= cells
    assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_setup_s_in_every_cell():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_entry(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4)
    assert TEXT.match(w["why"])
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    assert os.path.exists(os.path.join(HERE, "traffic",
                                       w["traffic"] + ".json"))
    limits = json.load(open(os.path.join(HERE, "workloads",
                                         w["name"] + ".json")))["limits"]
    assert all(v is not None for v in limits.values())
    reported = [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                if w["name"] in m.get("workloads", [w["name"]])]
    assert sum(m in BENCH["per_layer"] for m in reported) >= 1
    assert sum(m in BENCH["end_to_end"] for m in reported) >= 2


def test_every_live_metric_has_a_live_cell():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_pairs_once_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    assert c["file"].startswith("benchmark/")
    cfg = json.load(open(os.path.join(ROOT, c["file"])))
    assert len(c["reduced"]) <= 16
    assert c["reduced"] == cfg["reduced"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


KIND_FUNCTIONS = {"inputs", "query_pool", "reference", "numbers",
                  "informative"}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_kind_has_a_file_with_the_five_functions(c):
    kind = json.load(open(os.path.join(ROOT, c["file"]))).get("kind", "adc")
    assert NAME.match(kind), kind
    path = os.path.join(HERE, "kinds", kind + ".py")
    assert os.path.exists(path), path
    tree = ast.parse(open(path).read())
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert KIND_FUNCTIONS <= defined, KIND_FUNCTIONS - defined


def test_files_are_named_from_names():
    for dirpath, _, files in os.walk(HERE):
        if "__pycache__" in dirpath or ".cache" in dirpath:
            continue
        for f in files:
            assert NAME.match(f) or f in ("__init__.py",), f
