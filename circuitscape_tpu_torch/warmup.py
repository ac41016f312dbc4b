"""Fresh-machine warmup: prepay a job's one-time start-up costs.

Counterpart of circuitscape_tpu/warmup.py.  The JAX package prepays XLA
compiles; this package compiles nothing per shape.  What the first job
in a fresh process (or on a fresh checkout) pays here instead is:

  - the nvcc build of the stencil kernel library (csrc/, into
    build/kernels/, keyed on the source; later processes load it);
  - the g++ builds of the native host libraries (native/, into
    build/native/), where the job's tier uses them: the Cholesky of
    the direct solvers, the fast ASC reader and writer;
  - the CUDA context and the cuBLAS handle of the coarse solve;
  - the caching allocator's growth to the job's block shapes (kept for
    the rest of the process).

This module lets an operator pay them explicitly, e.g. during node
provisioning or before a measured run:

    python -m circuitscape_tpu_torch.warmup job.ini

It reads only the job's shape-determining facts (raster dimensions,
focal point count, scenario/solver/precision/neighbor flags), builds a
synthetic random job of the same shape, and runs it through the public
compute() surface into a temp directory, on the CUDA device unless the
caller passes device="cpu".  The first two items last beyond the
process; the others last only within it, so a measured run warms up in
its own process.

Jobs with polygons, masks, or include/exclude pairs run a few extra
code paths (e.g. the polygon projector); warmup covers the dominant
ones but not those data-dependent extras.  Cited for scope parity:
src/run.jl:26-45 is the surface being warmed.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

from .config import CSConfig, init_config, parse_config


def _shape_of_raster(path: str):
    from .io.raster import read_raster
    grid, _wkt, _tf = read_raster(path)
    return grid.shape


def warmup(path_or_dict, points: int | None = None, quiet: bool = True,
           device=None):
    """Run a synthetic job of the same shape as the job described by an
    INI path or config dict, on `device` (default: CUDA).  Returns the
    synthetic job's wall seconds."""
    from .run import compute, resolve_device

    dev = resolve_device(device)
    if isinstance(path_or_dict, str):
        cfg = parse_config(path_or_dict)
    else:
        d = init_config()
        d.update(path_or_dict)
        cfg = CSConfig.from_dict(d)

    if cfg.data_type != "raster":
        # network jobs build per-component operators whose shapes depend
        # on the graph itself; run the real job once
        raise ValueError("warmup supports raster jobs (network program "
                         "shapes are data-dependent)")

    H, W = _shape_of_raster(cfg.habitat_file)
    npts = points
    if npts is None and cfg.point_file:
        try:
            from .io.raster import read_raster
            pgrid, _w, _t = read_raster(cfg.point_file)
            vals = pgrid[(pgrid > 0) & (pgrid != -9999)]
            npts = max(2, len(np.unique(vals)))
        except Exception:
            npts = 32
    npts = int(npts or 32)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        g = rng.uniform(0.5, 3.0, (H, W))
        np.save(os.path.join(d, "warm_cell.npy"), g)
        pts = np.zeros((H, W))
        placed = 0
        while placed < npts:
            r, c = rng.integers(0, H), rng.integers(0, W)
            if pts[r, c] == 0:
                placed += 1
                pts[r, c] = placed
        np.save(os.path.join(d, "warm_pts.npy"), pts)

        job = {
            "data_type": "raster",
            "scenario": cfg.scenario,
            "habitat_file": f"{d}/warm_cell.npy",
            "habitat_map_is_resistances": "False",
            "point_file": f"{d}/warm_pts.npy",
            "output_file": f"{d}/warm.out",
            "solver": cfg.solver,
            "precision": cfg.precision,
            "connect_four_neighbors_only": str(cfg.connect_four_neighbors_only),
            "connect_using_avg_resistances": str(cfg.connect_using_avg_resistances),
            "write_cur_maps": str(bool(cfg.write_cur_maps)),
            "write_volt_maps": str(bool(cfg.write_volt_maps)),
            "write_max_cur_maps": str(bool(cfg.write_max_cur_maps)),
            "suppress_messages": "True" if quiet else "False",
        }
        if cfg.scenario == "advanced":
            # synthetic sources/grounds: a handful of scattered cells
            src = np.zeros((H, W))
            gnd = np.full((H, W), -9999.0)
            for k in range(8):
                src[rng.integers(0, H), rng.integers(0, W)] = 1.0
                gnd[rng.integers(0, H), rng.integers(0, W)] = 0.0
            np.save(os.path.join(d, "warm_src.npy"), src)
            np.save(os.path.join(d, "warm_gnd.npy"), gnd)
            job["source_file"] = f"{d}/warm_src.npy"
            job["ground_file"] = f"{d}/warm_gnd.npy"
            job.pop("point_file")

        compute(job, device=dev)
    return time.perf_counter() - t0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m circuitscape_tpu_torch.warmup <job.ini> "
              "[npoints]", file=sys.stderr)
        return 2
    npts = int(argv[1]) if len(argv) > 1 else None
    secs = warmup(argv[0], points=npts, quiet=True)
    print(f"warmup complete in {secs:.1f}s — kernel library and host "
          f"libraries built, device state warmed for this job's shape")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
