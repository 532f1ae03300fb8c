"""BENCHMARK.json against the contract's characters and cross-references,
and every file it names found by name."""

import json
import re

import pytest

from benchmark import spec as spec_lib

SPEC = spec_lib.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[key]:
            yield key, entry


@pytest.mark.parametrize("key,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_and_text(key, entry):
    assert NAME.match(entry["name"])
    fields = ("why", "layer") + (("source",) if key == "configs" else ())
    for field in fields:
        if field in entry:
            text = entry[field]
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text
    if key == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert len(entry["reduced"]) <= 16
        assert all(NAME.match(r) for r in entry["reduced"])
        assert (spec_lib.ROOT / entry["file"]).exists()
    elif key == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] in (1, 4)
        assert NAME.match(entry["traffic"]) and NAME.match(entry["config"])
        assert (spec_lib.HERE / "traffic" / f"{entry['traffic']}.json"
                ).exists()
    else:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if key == "end_to_end" else {"layer", "moves"}
        assert set(entry) <= allowed


def test_top_level_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    names = [e["name"] for _, e in _names()]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in SPEC["per_layer"]
                 if "workloads" not in m or w["name"] in m["workloads"]]
        assert layer


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        target = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in target or w in target["workloads"]
        assert (spec_lib.HERE / "metrics" / f"{m['name']}.py").exists()
        assert callable(spec_lib.metric(m["name"]).read)
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)


def test_shares_of_a_peak_are_named_so():
    for m in SPEC["per_layer"]:
        if m["unit"] == "%" and "idle" not in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") \
                or "mfu" in m["name"]


def test_drivers_and_limits_found_by_name():
    for w in SPEC["workloads"]:
        cell = spec_lib.cell(SPEC, w["name"])
        drv = spec_lib.driver(cell["traffic"]["driver"])
        assert callable(drv.run)
        assert cell["limits"]["limits"], w["name"]


def test_run_seconds_fit_the_full_check():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_command_stays_inside_paths():
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
