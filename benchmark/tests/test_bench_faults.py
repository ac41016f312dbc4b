"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell of this benchmark can have (one card: no
exchange between chips to leave out), and the control, the reference
in TF32, fails the same comparison."""

import numpy as np
import pytest
import torch

from helpers import run_tiny


def _unchanged(monkeypatch):
    """The pair solve returns its state as it started: X = 0, and
    converged."""
    from circuitscape_tpu_torch.solve import stencil

    def solve(S64, src, dst, *a, **k):
        H, W = S64.shape
        b = 1 << max(0, len(src) - 1).bit_length()
        return (torch.zeros((b, H, W), dtype=torch.float64),
                np.zeros(len(src)), 0)
    monkeypatch.setattr(stencil, "stencil_solve_pairs", solve)


def _half_batch(monkeypatch):
    """Half of each batch solved, the other half given the mean of the
    solved columns."""
    from circuitscape_tpu_torch.solve import stencil
    real = stencil.stencil_solve_pairs

    def solve(S64, src, dst, *a, **k):
        h = max(1, len(src) // 2)
        X, rel, it = real(S64, src[:h], dst[:h], *a, **k)
        b = 1 << max(0, len(src) - 1).bit_length()
        out = X.new_zeros((b,) + tuple(X.shape[1:]))
        out[:h] = X[:h]
        out[h:len(src)] = X[:h].mean(dim=0)
        return out, np.concatenate([rel, np.zeros(len(src) - h)]), it
    monkeypatch.setattr(stencil, "stencil_solve_pairs", solve)


def _altered_answer(monkeypatch):
    """One resistance altered by a part in a hundred where it is
    written, and one cell of the cumulative map where it is written."""
    from circuitscape_tpu_torch import out
    save, cum = out.save_resistances, out.write_cum_maps

    def save_resistances(r, cfg):
        r = r.copy()
        r[1, 2] *= 1.01
        r[2, 1] = r[1, 2]
        save(r, cfg)

    def write_cum_maps(c, *a, **k):
        i = np.unravel_index(np.argmax(c.cum_curr), c.cum_curr.shape)
        c.cum_curr[i] *= 1.01
        cum(c, *a, **k)
    monkeypatch.setattr(out, "save_resistances", save_resistances)
    monkeypatch.setattr(out, "write_cum_maps", write_cum_maps)


@pytest.mark.parametrize("traffic", ["resistances", "cum_max_maps"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer])
def test_fault_is_not_correct(tiny_tree, monkeypatch, fault, traffic):
    root, bench = tiny_tree
    fault(monkeypatch)
    result, rows = run_tiny(root, bench, f"tiny.{traffic}")
    assert result["correct"] is False, rows
    assert result["attempted"] >= 1


@pytest.mark.parametrize("traffic", ["resistances", "cum_max_maps"])
def test_sound_run_is_correct(tiny_tree, traffic):
    root, bench = tiny_tree
    result, rows = run_tiny(root, bench, f"tiny.{traffic}", trace=True)
    assert result["correct"] is True, rows
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("traffic", ["resistances", "cum_max_maps"])
def test_control_fails(tiny_tree, traffic):
    from benchmark import check, control
    root, bench = tiny_tree
    numbers, limits = control.control_numbers(
        str(root), bench, f"tiny.{traffic}", 5, "cpu",
        base=str(root / "benchmark"))
    ok, rows = check.judge(numbers, limits)
    assert not ok, rows
