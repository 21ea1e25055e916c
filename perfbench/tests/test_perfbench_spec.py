"""The harness finds every configuration, mix, runner and metric reader by
name from BENCHMARK.json, and the file keeps the contract's shape."""

import json
import os
import re

import pytest

from perfbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    for p in SPEC["paths"]:
        assert os.path.isdir(os.path.join(harness.ROOT, p)) and not p.endswith("_torch")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    w, config, mix = harness.resolve(SPEC, cell)
    assert config["name"] == w["config"]
    assert harness.runner_of(mix).run
    assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e, per = harness.cell_metrics(SPEC, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per
    for m in per:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.metric_reader(metric))


def test_names_units_and_layers():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in SPEC["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(CELLS)


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
