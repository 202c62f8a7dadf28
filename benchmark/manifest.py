"""``BENCHMARK.json`` and the files it names, found by name.

- a cell: its entry in ``BENCHMARK.json`` (``workloads``), its own file
  ``benchmark/workloads/<cell>.json`` (configuration, traffic, driver, the
  driver's parameters and the limits of the correctness check) and its
  configuration ``benchmark/configs/<config>.json``;
- a driver: the module ``benchmark/drivers/<driver>.py``;
- a per-layer metric: its reader ``benchmark/metrics/<metric>.py``, a
  function ``read(readings)`` returning a number or None.

A later cell, configuration or metric is a new file and a new entry; no
file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, bench: Optional[dict] = None, here: Path = HERE) -> dict:
    """The cell ``name``: its manifest entry, its file and its configuration,
    as ``{"entry", "spec", "config"}``."""
    bench = bench or load()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    spec = json.loads((here / "workloads" / f"{name}.json").read_text())
    if (spec["config"], spec["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names {spec['config']}/{spec['traffic']}, "
                         f"BENCHMARK.json {entry['config']}/{entry['traffic']}")
    config = json.loads((here / "configs" / f"{entry['config']}.json").read_text())
    return {"entry": entry, "spec": spec, "config": config}


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, or list no cells at all."""
    return [m for m in bench[kind] if "workloads" not in m or cell_name in m["workloads"]]


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader(metric: str, here: Path = HERE) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(bench: dict, here: Path = HERE) -> List[str]:
    """What in ``bench`` breaks the naming rules, or names a file, driver or
    reader that is not there."""
    out = []
    names: Dict[str, int] = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in bench[kind]:
            if not NAME.match(item["name"]):
                out.append(f"{kind}: bad name {item['name']!r}")
            names[item["name"]] = names.get(item["name"], 0) + 1
            if "unit" in item and not UNIT.match(item["unit"]):
                out.append(f"{item['name']}: bad unit {item['unit']!r}")
    out += [f"name used twice: {n}" for n, k in names.items() if k > 1]
    for w in bench["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"{w['name']}: bad {key} {w[key]!r}")
        if not (here / "workloads" / f"{w['name']}.json").exists():
            out.append(f"{w['name']}: no workloads/{w['name']}.json")
            continue
        spec = json.loads((here / "workloads" / f"{w['name']}.json").read_text())
        if not (here / "drivers" / f"{spec['driver']}.py").exists():
            out.append(f"{w['name']}: no driver {spec['driver']}")
    for c in bench["configs"]:
        for key in c.get("reduced", []):
            if not NAME.match(key):
                out.append(f"{c['name']}: bad reduced key {key!r}")
    for m in bench["per_layer"]:
        if not (here / "metrics" / f"{m['name']}.py").exists():
            out.append(f"{m['name']}: no reader metrics/{m['name']}.py")
    return out
