"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the configuration's file
is the one ``BENCHMARK.json`` gives, the traffic mix is
``traffic/<traffic>.json``, and the mix names its driver
(``drivers/<driver>.py``) and its PrIM workloads
(``workloads/<workload>.py``, lower case).  Each metric is read by
``metrics/<metric>.py``.  All of these are loaded by path, so a later cell,
mix, workload or metric is a new file and an entry, never an edit."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
import types

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, prefix: str) -> types.ModuleType:
    """Import the file at ``path`` as a module of its own (names may hold
    dots or dashes, so never by import name); cached in ``sys.modules``."""
    name = f"bench_{prefix}_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    if not path.is_file():
        raise FileNotFoundError(f"no {prefix} file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def workload_module(name: str) -> types.ModuleType:
    return load_module(BENCH / "workloads" / f"{name.lower()}.py", "workload")


def reference_module(name: str) -> types.ModuleType:
    return load_module(BENCH / "reference" / f"{name.lower()}.py",
                       "reference")


def metric_module(name: str) -> types.ModuleType:
    return load_module(BENCH / "metrics" / f"{name}.py", "metric")


def driver_module(name: str) -> types.ModuleType:
    return load_module(BENCH / "drivers" / f"{name}.py", "driver")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything its run reads."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # metric entries this cell reports with --trace 0
    per_layer: list         # ... and with --trace 1


def _reports(metric: dict, cell: str, e2e_names: set | None) -> bool:
    """An end-to-end metric (``e2e_names`` None) without a ``workloads``
    list is every cell's; a per-layer one goes wherever the end-to-end
    metric it moves is reported."""
    listed = metric.get("workloads")
    if listed is not None:
        return cell in listed
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)
