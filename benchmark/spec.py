"""Finds a cell's files by the names `BENCHMARK.json` gives them.

  configs/<config>.json    the configuration (its `file` in the JSON)
  traffic/<traffic>.json   the traffic mix; its "driver" names
  drivers/<driver>.py      the kind of window that runs it
  limits/<workload>.json   the limits of the comparison that decides
                           `correct`, with the readings they were set from
  metrics/<metric>.py      a per-layer metric: read(records) -> value|None
and the metrics import `rooflines/<kernel or step>.py`, the operations and
bytes of each kernel and step.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_spec(path: Path = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark by its file (names may hold dots)."""
    name = "benchmark._by_path." + path.stem.replace(".", "__")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell(spec: dict, workload: str) -> Dict:
    """Everything one cell needs: its workload entry, configuration
    (file contents), traffic mix, limits, and its metric entries."""
    wl = {w["name"]: w for w in spec["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = (json.loads(limits_path.read_text())
              if limits_path.exists() else {})

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(workload=wl, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def driver(name: str) -> ModuleType:
    return load_module(HERE / "drivers" / f"{name}.py")


def metric(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py")

