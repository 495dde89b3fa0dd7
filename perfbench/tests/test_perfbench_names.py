"""The harness finds every cell, configuration, traffic mix and metric by
name, refuses an unknown one, and agrees with BENCHMARK.json."""
import dataclasses
import importlib
import json

import pytest

from conftest import BENCH
from fedbench import cells, program

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("kind", cells.KINDS)
def test_every_file_loads_by_its_name(kind):
    found = cells.names(kind)
    assert found
    for name in found:
        assert cells.load(kind, name)["name"] == name


@pytest.mark.parametrize("kind,name", [("workloads", "no-such-cell"),
                                       ("configs", "gpt-9"),
                                       ("traffic", "../workloads/x"),
                                       ("limits", "x")])
def test_unknown_names_are_refused(kind, name):
    with pytest.raises((cells.UnknownName, ValueError)):
        cells.load(kind, name)


def test_benchmark_json_names_only_files_that_exist():
    assert {w["name"] for w in SPEC["workloads"]} <= set(
        cells.names("workloads"))
    for w in SPEC["workloads"]:
        c = cells.load("workloads", w["name"])
        assert (c["config"], c["traffic"], c["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
    for c in SPEC["configs"]:
        assert cells.load("configs", c["name"])["source"] == c["source"]
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert c["reduced"] == cells.load("configs", c["name"])["reduced"]


def test_every_per_layer_metric_has_its_reader():
    for m in SPEC["per_layer"]:
        mod = importlib.import_module(f"metrics.{m['name']}")
        assert mod.UNIT == m["unit"]
        assert callable(mod.read)


def test_configs_are_the_programs_published_widths_but_for_depth():
    from repro_torch.configs import get_config
    for name in cells.names("configs"):
        cfg = cells.load("configs", name)
        got = program.port_config(cfg)
        published = get_config(cfg["arch"])
        assert cfg["reduced"] == ["num_layers"]
        assert got.num_layers == cfg["num_layers"] \
            < published.num_layers == cfg["published_num_layers"]
        assert dataclasses.replace(got, num_layers=published.num_layers) \
            == published


def test_every_cell_reads_its_config_and_traffic():
    for name in cells.names("workloads"):
        c = cells.cell(name)
        from fedbench.check import NUMBERS
        assert "loss_gap" in c["limits"] and set(c["limits"]) <= set(NUMBERS)
        assert c["traffic"]["checked_rounds"] >= 3
