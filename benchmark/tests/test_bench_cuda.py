"""On the card: one short run of the smallest cell, as the driver runs
it, must print a correct result line; and without enough cards the
command must fail with no result.

    python -m pytest -m cuda benchmark/tests/test_bench_cuda.py"""

import json
import subprocess
import sys

import pytest

from helpers import ROOT


def _run(*args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = _run("--workload", "testarea1_1M.resistances", "--seed",
               "2147483999", "--seconds", "3", "--trace", "1")
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run("--workload", "testarea1_1M.resistances", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode == 2
    assert out.stdout.strip() == ""
