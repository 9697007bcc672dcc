"""BENCHMARK.json against the contract's names, and every file it names."""

import json
import os
import re

import pytest

from ohmbench import control, find, generator, run, small
from conftest import SMALL, cell_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.load_bench()


def names():
    out = [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    out += [k for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("name", names())
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_units_use_allowed_characters(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")


@pytest.mark.parametrize("name", list(SMALL))
def test_cell_files_are_found_by_name(name):
    cell = cell_of(name)
    config = run.load_json("configs", cell["config"] + ".json")
    mix = run.load_json("traffic", cell["traffic"] + ".json")
    limits = run.load_json("limits", cell["name"] + ".json")
    assert config["mapper"] and callable(find("loops", mix["loop"]["kind"]).drive_window)
    assert len(generator.parts(mix)) == 3
    # Each mode names the numbers it compares; the cell gives each a limit.
    assert set(limits) == set(find("modes", config["mode"]).NUMBERS)
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    # The controls that must fail at the cell's CPU size are controls.
    assert set(small.load(name)["failing_controls"]) <= set(control.CONTROLS)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_benchmark_cells_name_their_configuration_files(cell):
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert entry["file"] == f"ohmbench/configs/{cell['config']}.json"
    assert os.path.exists(os.path.join(run.ROOT, entry["file"]))
    config = run.load_json("configs", cell["config"] + ".json")
    assert sorted(entry["reduced"]) == sorted(config["reduced"])
    # The size at which ohmbench/tests run the cell on the CPU.
    assert small.path(cell["name"]) == os.path.join(run.HERE, "small", cell["name"] + ".json")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_declares_what_benchmark_json_says(metric):
    reader = run.load_metric(metric["name"])
    assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == (
        metric["unit"], metric["layer"], metric["moves"], metric["source"])
    assert callable(reader.read)
    for cell in metric.get("workloads", []):
        assert any(w["name"] == cell for w in BENCH["workloads"])


def test_paths_hold_the_benchmark_and_the_command():
    assert BENCH["paths"] == ["ohmbench"]
    assert BENCH["command"][1].startswith("ohmbench/")
    assert len(json.dumps(BENCH)) < 64 * 1024
