"""Finds a cell's parts by the names in BENCHMARK.json: its configuration
(configs/<config>.json, a file named by the entry), its traffic mix
(traffic/<traffic>.json) and a reader per metric (end_to_end/<name>.py
for the end-to-end metrics, metrics/<name>.py for the per-layer ones).
A new cell or metric is new files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, root: str, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, base: str = HERE) -> dict:
    with open(os.path.join(base, "traffic", f"{name}.json")) as f:
        return json.load(f)


def metrics(bench: dict, cell: str, per_layer: bool):
    """The metric entries a cell reports in a run: the per-layer ones
    (traced run) or the end-to-end ones, each where its `workloads`
    list names the cell or where it has none."""
    entries = bench["per_layer" if per_layer else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", (cell,))]


def reader(name: str, per_layer: bool, base: str = HERE):
    """The `read(run)` function of a metric's own file."""
    folder = "metrics" if per_layer else "end_to_end"
    path = os.path.join(base, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
