"""Per-job solver statistics (the BASELINE.json north-star metrics).

Counterpart of circuitscape_tpu/stats.py.  The device drivers record
machine-readable stats here: total CG iterations, fine-operator nnz,
pure solve seconds, the kernel route used at each MG level, and the
derived sustained nnz/s + %-of-memory-roofline for the fine-level SpMV.

The roofline uses the memory rate of the card that ran the job
(device_bytes_per_s), never a TPU figure; on the CPU, or on a card
missing from the table, no roofline share is derived.

Reset per job by run._run; read by chip_smoke.py after each compute().
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
JOB: dict = {}

# Weight planes the port's stencil kernels read per matvec: we, ws, wse,
# wne, diag (the TPU kernels read nine pre-shifted copies).
PLANES = 5

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


_ACCUM = {"cg_iters", "col_iters", "spmv_bytes", "solve_s", "factor_s"}


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
    b, h, w = x_shape
    record(cg_iters=int(iters), col_iters=int(b) * int(iters),
           spmv_bytes=int(iters) * spmv_bytes(h * w, b),
           solve_s=float(seconds))


def spmv_bytes(cells: int, batch: int, dtype_bytes: int = 4) -> int:
    """Bytes one batched fine-level matvec must move: x and y once per
    column plus the weight planes once (reused across the batch)."""
    return (2 * batch + PLANES) * cells * dtype_bytes


def finalize() -> dict:
    """Derived metrics from the raw counters; returns a copy.

    Drivers accumulate per solve chunk:
      cg_iters        device CG iterations (outer count, all passes)
      col_iters       sum over chunks of (batch columns x iterations)
      spmv_bytes      fine-level SpMV traffic, spmv_bytes() per
                      iteration
      solve_s         wall seconds inside the batched device solves
      fine_nnz        stored nonzeros of the fine operator (set once)
      cells           padded grid cells (set once)
      mg_kernels      per-MG-level kernel route list (set once)
      mg_build        "device" or "host": where the hierarchy coarsened
      batch_width     columns per chunk of the shortcut pair solve
      pass_iters      inner CG iterations of each refinement pass of
                      the pair solves, in order
      device_name     torch.cuda.get_device_name() or "cpu" (set once)
    """
    with _lock:
        d = dict(JOB)
    nnz = d.get("fine_nnz", 0)
    solve_s = d.get("solve_s", 0.0)
    col_iters = d.get("col_iters", 0)
    sb = d.get("spmv_bytes", 0)
    if col_iters and nnz and solve_s:
        # sustained nnz/s through the whole preconditioned solve
        # (counting fine-level nnz once per CG iteration per column; the
        # V-cycle's coarse work is the preconditioner's price, not nnz)
        d["sustained_nnz_per_s"] = round(nnz * col_iters / solve_s, 0)
    rate = device_bytes_per_s(d.get("device_name", "cpu"))
    if sb and solve_s and rate:
        # share of the solve spent streaming the fine-level SpMV if it
        # ran at the card's memory speed-of-light
        d["fine_spmv_pct_of_mem_roofline"] = round(
            100.0 * (sb / rate) / solve_s, 1)
    return d
