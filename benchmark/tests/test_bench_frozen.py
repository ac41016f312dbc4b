"""The frozen arithmetic: PERF.md's byte bounds of the seven kernels at
1024^2, B = 32, on the H100 SXM's 3.35 TB/s; interval unions; the
nesting-aware section sums."""

import pytest

from benchmark import frozen

# ms, PERF.md's kernel table
BOUNDS_MS = {"matvec": 0.0864, "matvec_pap": 0.0864, "cheb_step": 0.2479,
             "residual_restrict": 0.0964, "cheb_init": 0.0876,
             "residual_init": 0.1678, "cheb_finish": 0.1277}


@pytest.mark.parametrize("name", frozen.KERNELS)
def test_kernel_bounds_at_1024(name):
    rate = frozen.peak_bytes_per_s("NVIDIA H100 80GB HBM3")
    ms = 1e3 * frozen.kernel_bytes(name, 32, 1024, 1024) / rate
    assert round(ms, 4) == BOUNDS_MS[name]


def test_busy_union():
    assert frozen.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0


def test_stage_seconds_nesting():
    secs = {("complete job",): [1, 10.0],
            ("complete job", "solve"): [1, 6.0],
            ("complete job", "solve", "batched pair solve"): [2, 4.0],
            ("complete job", "solve", "write maps"): [1, 1.0],
            ("complete job", "write maps"): [1, 0.5]}
    assert frozen.stage_seconds(secs, ("batched pair solve",)) == 4.0
    assert frozen.stage_seconds(secs, ("write maps",)) == 1.5
    assert frozen.stage_seconds(secs, ("solve", "write maps")) == 6.5
    assert not frozen.sections_seen(secs, ("fetch maps",))
