"""Benchmark of circuitscape_tpu_torch: bench.py's job through the port.

    python3 bench_torch.py                # on the CUDA device
    python3 bench_torch.py --device cpu   # the same job on the CPU

The end-to-end pairwise resistance job on a 1M-cell raster that
bench.py runs through the JAX package (BASELINE.md: 1M-cell pairwise
job; Julia CHOLMOD 89.6 s on a 20-core Xeon): a 1000 x 1000 conductance
raster, uniform(0.5, 3) with ~10% NODATA, seed 42, 32 focal points,
solver = cg+amg, single precision, shortcut mode, made by
chip_smoke.make_job (CS_BENCH_SIZE and CS_BENCH_POINTS set the side and
the point count, as in bench.py).  The job runs through the public
compute(cfg, device) surface: file IO, graph build, components, the
batched stencil CG solve on the device, shortcut reconstruction, output
writing.

warmup.warmup (the nvcc build, the CUDA context, the cuBLAS handle, the
caching allocator's growth) runs first, so one-time costs stay out of
the wall clock, as bench.py keeps XLA's compile out.  Then two full
runs (chip_smoke.time_job, the timing of chip_smoke.py's phase 3), each
synchronized; each run's time goes to stderr.

Prints ONE JSON line: bench.py's metric, value (the best of the two
runs, s), unit, vs_baseline (89.6 s / value), cg_iters, mg_kernels,
both runs' times and their spread, the device, the card's name and power
limit as nvidia-smi gives them (null on the CPU), and the golden
replay's verdict on the default route (torch_golden.run_subset) under
cuda_golden ("cpu_golden" with --device cpu; CS_CUDA_GOLDEN=0 skips it).
Exits 1 when the replay is not complete or raises (the line is printed
all the same), 2 without a CUDA device unless --device cpu is given:
there is no fallback to the CPU.
"""

import argparse
import json
import os
import sys
import tempfile
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

METRIC = "pairwise_1Mcell_32pt_wall_clock"
BASELINE_SECONDS = 89.6  # Julia CHOLMOD, 1M-cell pairwise (BASELINE.md)


def note(msg):
    print(msg, file=sys.stderr, flush=True)


def bench_line(times, st, device):
    """The JSON line's fields for timed runs of `times` seconds whose
    last run left the stats `st`, on `device` ("cuda" or "cpu")."""
    import torch
    from chip_smoke import card_line

    best = min(times)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    return {
        "metric": METRIC,
        "value": best,
        "unit": "s",
        "vs_baseline": BASELINE_SECONDS / best,
        "runs_s": list(times),
        "spread_s": max(times) - best,
        "cg_iters": st.get("cg_iters"),
        "mg_kernels": st.get("mg_kernels"),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": card_line() if cuda else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device available (--device cpu runs "
              "the job on the CPU)", file=sys.stderr)
        return 2
    from chip_smoke import make_job, time_job
    from circuitscape_tpu_torch.warmup import warmup

    side = int(os.environ.get("CS_BENCH_SIZE", "1000"))
    npoints = int(os.environ.get("CS_BENCH_POINTS", "32"))
    with tempfile.TemporaryDirectory() as d:
        cfg, _ = make_job(d, side, side, npoints)
        note("bench_torch: inputs ready")
        secs = warmup(cfg, device=args.device)
        note(f"bench_torch: warmup done in {secs:.3f} s")
        r, times, _, _, st = time_job(cfg, 2, args.device, "bench", note)
    finite = r[1:, 1:][r[1:, 1:] > 0]
    if not (finite.size > 0 and np.all(np.isfinite(finite))):
        raise AssertionError("benchmark solve produced no finite "
                             "resistances")
    result = bench_line(times, st, args.device)
    ok = True
    if os.environ.get("CS_CUDA_GOLDEN", "1") != "0":
        key = f"{torch.device(args.device).type}_golden"
        try:
            from torch_golden import run_subset
            passed, total, _ = run_subset(note, args.device, "default")
            result[key] = f"{passed}/{total}"
            ok = passed == total
        except Exception as e:   # the line is printed all the same
            traceback.print_exc()
            result[key] = f"error: {type(e).__name__}: {e}"
            ok = False
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
