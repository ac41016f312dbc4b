"""circuitscape_tpu_torch.warmup, case for case with tests/test_warmup.py,
on the CPU: a synthetic job of the real job's shape runs through
compute() into a temp directory, network jobs are refused, and the CLI
prints its usage."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _tiny_job(tmp_path, scenario="pairwise"):
    rng = np.random.default_rng(0)
    g = rng.uniform(0.5, 3, (40, 50))
    np.save(tmp_path / "c.npy", g)
    pts = np.zeros((40, 50))
    pts[3, 4], pts[10, 20], pts[30, 40] = 1, 2, 3
    np.save(tmp_path / "p.npy", pts)
    ini = tmp_path / "j.ini"
    ini.write_text(f"""[a]
data_type = raster
scenario = {scenario}
habitat_file = {tmp_path}/c.npy
point_file = {tmp_path}/p.npy
output_file = {tmp_path}/o.out
solver = cg+amg
suppress_messages = True
""")
    return str(ini)


@pytest.mark.parametrize("scenario", ["pairwise", "advanced"])
def test_warmup_runs_same_shape_job(tmp_path, scenario):
    from circuitscape_tpu_torch.warmup import warmup
    secs = warmup(_tiny_job(tmp_path, scenario), device="cpu")
    assert secs > 0
    # no stray outputs next to the real job's output_file
    assert not os.path.exists(tmp_path / "o_resistances.out")
    assert sorted(os.listdir(tmp_path)) == ["c.npy", "j.ini", "p.npy"]


def test_warmup_rejects_network(tmp_path):
    from circuitscape_tpu_torch.warmup import warmup
    with pytest.raises(ValueError):
        warmup({"data_type": "network", "scenario": "pairwise",
                "habitat_file": "x", "output_file": "y"}, device="cpu")


def test_warmup_cli_usage():
    from circuitscape_tpu_torch.warmup import main
    assert main([]) == 2
    assert main(["--help"]) == 2


def test_warmup_defaults_to_cuda(tmp_path):
    from circuitscape_tpu_torch.warmup import warmup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        warmup(_tiny_job(tmp_path))
