"""BENCHMARK.json against the benchmark's rules: names, units, metric
lists, chips, files, and that every cell finds its configuration,
traffic, limits and readers."""

import json
import math
import os
import re

import pytest

from harness.main import HERE, ROOT, Cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and \
            not p.startswith("/") and ".." not in p.split("/")


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in BENCH[group]]
        assert len(seen) == len(set(seen)), group


def test_one_line_texts_and_keys():
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("perfbench/configs/")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200


def test_each_per_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", CELLS):
            e2e = {x["name"] for x in Cell(cell, BENCH).end_to_end()}
            assert m["moves"] in e2e, (m["name"], cell)


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for cell in CELLS:
        c = Cell(cell, BENCH)
        e2e = {m["name"] for m in c.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer()


def test_four_chip_cells_are_at_most_a_quarter():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_the_full_check_fits_its_time():
    n = 24
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = Cell(cell, BENCH)
    assert c.traffic["generator"] in ("train", "scene")
    assert os.path.exists(os.path.join(HERE, "generators",
                                       c.traffic["generator"] + ".py"))
    assert c.limits, "the output check has limits"
    for m in c.per_layer():
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
    for v in c.limits.values():
        assert v["lower"] < v["limit"] < v["upper"]
        assert math.isfinite(v["limit"])
