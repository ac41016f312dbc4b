"""The harness finds every part of a cell by name, and a configuration,
a traffic mix and a metric dropped into a copy run with no edit."""

import json
import os

import pytest

from benchmark import cells
from helpers import ROOT, run_tiny

BENCH = cells.load_benchmark(ROOT)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_parts_found(w):
    cfg = cells.config(BENCH, ROOT, w["config"])
    assert cfg["reference"] and cfg["check_jobs"] >= 1
    tr = cells.traffic(w["traffic"])
    assert tr["compare"] and set(tr["limits"]) >= {
        "ids_mismatch", "pattern_mismatch", "resistance_rel"}
    for per_layer in (False, True):
        ms = cells.metrics(BENCH, w["name"], per_layer)
        assert ms, "every cell reports metrics of both kinds"
        for m in ms:
            assert callable(cells.reader(m["name"], per_layer))
    names = {m["name"] for m in cells.metrics(BENCH, w["name"], False)}
    assert {"setup_s", "job_s"} <= names


def test_config_files_distinct_and_used():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for f in files:
        assert f.startswith("benchmark/") and os.path.isfile(
            os.path.join(ROOT, f))


def test_metric_lists_name_cells():
    cellnames = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", ())) <= cellnames


def test_dropped_in_parts_run_unedited(tiny_tree):
    root, bench = tiny_tree
    b = root / "benchmark"
    with open(b / "configs" / "tiny.json") as f:
        cfg = json.load(f)
    cfg.update(nrows=210, ncols=190)
    with open(b / "configs" / "tiny2.json", "w") as f:
        json.dump(cfg, f)
    with open(b / "traffic" / "resistances.json") as f:
        tr = json.load(f)
    with open(b / "traffic" / "again.json", "w") as f:
        json.dump(tr, f)
    (b / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return float(len(run.done))\n")
    bench["configs"].append({"name": "tiny2", "source": "a test",
                             "file": "benchmark/configs/tiny2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny2.again", "config": "tiny2",
                               "traffic": "again", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "driver", "moves": "job_s",
                               "workloads": ["tiny2.again"]})
    result, _ = run_tiny(root, bench, "tiny2.again", trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["jobs_done"]["value"] == result["attempted"]
    assert "load_graph_s" in result["metrics"]
    assert list(result)[-1] == "checks"
