"""Per-job solver statistics (the BASELINE.json north-star metrics).

Counterpart of circuitscape_tpu/stats.py.  The device drivers record
machine-readable stats here: total CG iterations, fine-operator nnz,
pure solve seconds, the kernel route used at each MG level.  finalize()
adds the job's span log (timer.CSTIMER) and the kernel launches per
(wrapper, B, H, W) counted since cuda_stencil.reset_launch_counts().

Reset per job by run._run; read by chip_smoke.py after each compute().
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
JOB: dict = {}

# Published device-memory rates (NVIDIA data sheets), matched against
# torch.cuda.get_device_name(); first match wins.
_MEM_BYTES_PER_S = (
    ("H100 PCIe", 2.0e12),
    ("H100 NVL", 3.9e12),
    ("H100", 3.35e12),      # SXM5, 80 GB HBM3
    ("H200", 4.8e12),
)


def device_bytes_per_s(device_name: str):
    """Peak memory rate of the named card in bytes/s, or None if unknown."""
    for key, rate in _MEM_BYTES_PER_S:
        if key in device_name:
            return rate
    return None


def reset():
    with _lock:
        JOB.clear()


_ACCUM = {"cg_iters", "col_iters", "stencil_solves", "solve_s",
          "factor_s", "graph_replays", "graph_captures", "pen_iters"}


def record(**kw):
    """Merge stats; counter keys accumulate, others overwrite."""
    with _lock:
        for k, v in kw.items():
            if k in _ACCUM:
                JOB[k] = JOB.get(k, 0) + v
            else:
                JOB[k] = v


def record_pass(iters: int):
    """Append one refinement pass's inner CG iterations (the pair
    solve's per-pass counts, pass_iters)."""
    with _lock:
        JOB.setdefault("pass_iters", []).append(int(iters))


def record_solve(x_shape, iters: int, seconds: float):
    """Accumulate one batched device solve: x_shape = (B, H, W) of the
    device RHS block (padded batch), iters = device CG iterations."""
    record(cg_iters=int(iters), col_iters=int(x_shape[0]) * int(iters),
           stencil_solves=1, solve_s=float(seconds))


def finalize() -> dict:
    """The job's counters, span log and launch counts; returns a copy.

    Drivers accumulate per solve chunk:
      cg_iters        device CG iterations (outer count, all passes)
      col_iters       sum over chunks of (batch columns x iterations)
      stencil_solves  batched solves on the stencil path (record_solve)
      solve_s         wall seconds inside the batched device solves
      fine_nnz        stored nonzeros of the fine operator (set once)
      cells           padded grid cells (set once)
      mg_kernels      per-MG-level kernel route list (set once)
      mg_build        "device" or "host": where the hierarchy coarsened
      batch_width     columns per chunk of the shortcut pair solve
      pass_iters      inner CG iterations of each refinement pass of
                      the pair solves, in order
      graph_replays   CG iterations run as a replayed CUDA graph (the
                      stencil loop's graph route, solve/cg_graph.py)
      graph_captures  CUDA graphs that route captured
      pen_iters       CG iterations whose body carried a per-column
                      penalty field (stencil_cg with pen: all-to-one,
                      and one-to-all with polygons or on a mesh)
      device_name     torch.cuda.get_device_name() or "cpu" (set once)

    and, read at the call:
      spans           CSTIMER's span log of the job, [id, parent id,
                      name, start_ns, end_ns] per span
      spans_dropped   spans that started after the log held MAX_SPANS
                      (benchmark/spans.py refuses such a log)
      launches_bhw    [wrapper, B, H, W, launches] per kernel shape
                      launched since cuda_stencil.reset_launch_counts()
    """
    from .solve import cuda_stencil
    from .timer import CSTIMER
    with _lock:
        d = dict(JOB)
    d["spans"] = CSTIMER.spans()
    d["spans_dropped"] = CSTIMER.dropped
    d["launches_bhw"] = [[name, b, h, w, n] for (name, b, h, w), n
                         in sorted(cuda_stencil.LAUNCHES_BHW.items())]
    return d
