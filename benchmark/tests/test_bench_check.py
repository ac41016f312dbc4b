"""The comparison itself: exact numbers, relative gaps, and answers that
are not numbers."""

import numpy as np

from benchmark import check

KINDS = ["resistances", "cum_curmap", "max_curmap"]
LIMITS = {"ids_mismatch": 0, "pattern_mismatch": 0, "resistance_rel": 1e-5,
          "cum_map_rel": 5e-5, "max_map_rel": 5e-5}


def _ref():
    r = np.array([[0, 1, 2, 3], [1, 0, 2.0, -1], [2, 2.0, 0, -1],
                  [3, -1, -1, 0]])
    m = np.arange(12.0).reshape(3, 4)
    return {"resistances": r, "cum": m, "max": m / 2}


def _out(ref):
    return {"resistances": ref["resistances"].copy(),
            "cum_curmap": ref["cum"].copy(), "max_curmap": ref["max"].copy()}


def test_equal_answers_pass():
    ref = _ref()
    ok, rows = check.judge(check.compare(_out(ref), ref, KINDS), LIMITS)
    assert ok and all(v == 0 for _, v, _ in rows)


def test_each_fault_fails():
    ref = _ref()
    cases = []
    o = _out(ref)
    o["resistances"][0, 2] = 9                  # another point id
    cases.append((o, "ids_mismatch"))
    o = _out(ref)
    o["resistances"][1, 3] = o["resistances"][3, 1] = 5.0   # a path
    cases.append((o, "pattern_mismatch"))
    o = _out(ref)
    o["resistances"][1, 2] *= 1 + 1e-4
    cases.append((o, "resistance_rel"))
    o = _out(ref)
    o["resistances"][2, 1] = np.nan
    cases.append((o, "resistance_rel"))
    o = _out(ref)
    o["cum_curmap"][1, 1] = np.nan
    cases.append((o, "cum_map_rel"))
    o = _out(ref)
    o["max_curmap"] = o["max_curmap"][:, :3]
    cases.append((o, "max_map_rel"))
    for o, name in cases:
        got = check.compare(o, ref, KINDS)
        ok, _ = check.judge(check.worst([got, check.compare(
            _out(ref), ref, KINDS)]), LIMITS)
        assert not ok and got[name] > LIMITS[name], (name, got)
