"""The whole golden corpus (every INI under tests/data/input) through
circuitscape_tpu_torch on the card, on both of torch_golden.py's routes
(default thresholds; the device route: raster cg+amg jobs on the stencil
path, networks on the iterative tier), with cg+amg, at the reference
harness's tolerances (torch_golden's helpers).  Each case is held to its
golden files; on the device route the goldens the JAX package's device
path departs from (torch_golden.DEVICE_DEPARTURES, ROADMAP section 3),
and an INI the corpus has no golden for (ex_advanced), are held to the
port's CPU run on the same route instead, by the same rules.  Marked
`cuda`: they skip without a CUDA device.  On a machine with one (which
need not have JAX), run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_golden.py

This file imports neither JAX nor circuitscape_tpu."""

import os

import numpy as np
import pytest
import torch

import torch_golden as tg

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("route", tg.ROUTES)
@pytest.mark.parametrize("case", tg.corpus(), ids=lambda c: c[0])
def test_corpus_on_card(dev, tmp_path, route, case):
    label, ini, gold, solver, precision = case
    stem = os.path.splitext(os.path.basename(ini))[0]
    card = str(tmp_path / "card")
    os.makedirs(card)
    if tg.has_goldens(stem) and not (route == "device" and
                                     stem in tg.DEVICE_DEPARTURES):
        _, r, _ = tg.run_case(ini, solver, precision, dev, route, card)
        tg.verify(stem, r, card, gold, precision, label)
        return
    cpu = str(tmp_path / "cpu")
    os.makedirs(cpu)
    try:
        _, ref, _ = tg.run_case(ini, solver, precision, "cpu", route, cpu)
    except Exception as e:   # oneToAllVerify7 stops at the residual gate
        with pytest.raises(type(e)):
            tg.run_case(ini, solver, precision, dev, route, card)
        return
    _, r, _ = tg.run_case(ini, solver, precision, dev, route, card)
    tol = 1e-4 if precision == "single" else 1e-6
    tg.check_resistances(np.asarray(ref), np.asarray(r), tol, label)
    n = tg.compare_outputs(card, stem, precision == "single", cpu,
                           golden=False)
    assert n == len([f for f in os.listdir(cpu)
                     if f.startswith(f"{stem}_") and "resistances" not in f
                     and (f.endswith("asc") or ("Network" in f and
                                                f.endswith(".txt")))])
