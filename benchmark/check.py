"""The comparison that decides `correct`: a checked job's written answers
against the plain reference's, computed from the same input files.

Numbers compared (each the worst over the checked jobs), by the traffic
mix's `compare` list:
  resistances  ids_mismatch: point ids and matrix shape differ (0 or 1);
               pattern_mismatch: pairs that are -1 (no path) on one side
               only; resistance_rel: max |R - R_ref| / R_ref over the
               connected pairs off the diagonal
  cum_curmap   cum_map_rel: max |map - ref| / max |ref| of the cumulative
               current map, read back from the job's ASC file
  max_curmap   max_map_rel: the same for the max current map
"""

from __future__ import annotations

import importlib
import os

import numpy as np

FILES = {"resistances": "job_resistances.out",
         "cum_curmap": "job_cum_curmap.asc",
         "max_curmap": "job_max_curmap.asc"}
NAMES = {"resistances": ("ids_mismatch", "pattern_mismatch",
                         "resistance_rel"),
         "cum_curmap": ("cum_map_rel",),
         "max_curmap": ("max_map_rel",)}


def reference(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def graph_options(config) -> dict:
    """The configuration's graph rules as the reference's keywords."""
    if config["connect_four_neighbors_only"]:
        raise ValueError("the reference builds 8-neighbour graphs only")
    return {"resistances": bool(config["habitat_map_is_resistances"]),
            "avg_res": bool(config["connect_using_avg_resistances"])}


def _number(v) -> float:
    """A reading as a float; NaN (an answer that is not a number) reads as
    infinitely wrong."""
    v = float(v)
    return float("inf") if v != v else v


def _map_rel(got, want):
    scale = float(np.max(np.abs(want)))
    if got.shape != want.shape:
        return float("inf")
    return _number(np.max(np.abs(got - want)) /
                   (scale if scale > 0 else 1.0))


def compare(outputs: dict, ref: dict, kinds) -> dict:
    """{number: value} for one job: `outputs` holds the program's answers
    by kind, `ref` the reference's (grid_pairwise.pairwise's keys)."""
    got = {}
    if "resistances" in kinds:
        r, w = outputs["resistances"], ref["resistances"]
        if r.shape != w.shape or not (
                np.array_equal(r[0, 1:], w[0, 1:]) and
                np.array_equal(r[1:, 0], w[1:, 0])):
            got.update(ids_mismatch=1, pattern_mismatch=float("inf"),
                       resistance_rel=float("inf"))
        else:
            rr, wr = r[1:, 1:], w[1:, 1:]
            off = ~np.eye(rr.shape[0], dtype=bool)
            conn = off & (wr > 0)
            got["ids_mismatch"] = 0
            got["pattern_mismatch"] = int(np.count_nonzero(
                off & ((rr == -1) != (wr == -1))))
            got["resistance_rel"] = _number(np.max(
                np.abs(rr[conn] - wr[conn]) / wr[conn])) if conn.any() \
                else 0.0
    if "cum_curmap" in kinds:
        got["cum_map_rel"] = _map_rel(outputs["cum_curmap"], ref["cum"])
    if "max_curmap" in kinds:
        got["max_map_rel"] = _map_rel(outputs["max_curmap"], ref["max"])
    return got


def read_outputs(ref_mod, out_dir: str, kinds) -> dict:
    """The program's answers of one job, read back from its files."""
    outputs = {}
    for kind in kinds:
        path = os.path.join(out_dir, FILES[kind])
        if kind == "resistances":
            outputs[kind] = ref_mod.read_resistances(path)
        else:
            outputs[kind] = ref_mod.read_asc(path)[0]
    return outputs


def worst(readings) -> dict:
    out = {}
    for got in readings:
        for k, v in got.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number within its limit."""
    rows = [(k, numbers[k], limits[k]) for k in sorted(numbers)]
    return all(v <= lim for _, v, lim in rows), rows
