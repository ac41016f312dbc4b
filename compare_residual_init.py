"""residual_init of several checkouts of the port, timed on one CUDA card
on the same inputs.

    python3 compare_residual_init.py [TAG=PATH ...]

Each PATH is the root of a checkout (default: this one, tagged "this");
its circuitscape_tpu_torch/csrc/*.cu are built by nvcc with this
checkout's flags into build/compare/ here and loaded with ctypes, and its
cs_residual_init (whose C signature is the same in every checkout since
the kernel was ported) is launched on the operator of an (n, n) crop of
a bench-job conductance map (uniform(0.5, 3), ~10% zero, seed 42) and
standard normal x and b, at each side n of the bench job's (1024^2 down)
and the scale job's (3520^2 down) multigrid levels and of the Omniscape
windows' (384^2 down), and at B = 1, 2, 4, 8, 16, 32.  Each result is
held against the plain version (max |kernel - plain| <= 1e-5 * max
|plain|), then timed as chip_smoke.py times a level: the least of three
runs of 50 back-to-back launches (chip_smoke.cuda_ms).  Prints the card
(nvidia-smi's name and power limit) and one JSON line per shape and
batch: n, B, the byte bound (ms at the card's memory rate) and each
tag's ms.  Compare trees only within one run.  Fails without a CUDA
device.
"""

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SIDES = (1024, 512, 256, 128, 64, 3520, 1760, 880, 440, 220, 110, 384, 192,
         96)
BATCHES = (1, 2, 4, 8, 16, 32)


def load(tag, root):
    """Build root's kernels into build/compare/<tag>.so; the library."""
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    srcs = sorted(os.path.join(root, "circuitscape_tpu_torch", "csrc", f)
                  for f in os.listdir(os.path.join(
                      root, "circuitscape_tpu_torch", "csrc"))
                  if f.endswith(".cu"))
    out = os.path.join(HERE, "build", "compare")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"{tag}.so")
    subprocess.run([cs._nvcc(), *cs.NVCC_FLAGS, "-o", so, *srcs],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.cs_residual_init.argtypes = cs._SIGNATURES["cs_residual_init"]
    lib.cs_residual_init.restype = ctypes.c_int
    return lib


def main(argv):
    if not torch.cuda.is_available():
        print("compare_residual_init: no CUDA device available",
              file=sys.stderr)
        return 2
    import chip_smoke as c
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    trees = dict(a.split("=", 1) for a in argv) or {"this": HERE}
    libs = {tag: load(tag, os.path.abspath(root))
            for tag, root in trees.items()}
    dev = torch.device("cuda", torch.cuda.current_device())
    rate = stats.device_bytes_per_s(torch.cuda.get_device_name(dev))
    c.note(c.card_line())
    rng = np.random.default_rng(42)
    g = rng.uniform(0.5, 3.0, (max(SIDES), max(SIDES)))
    g[rng.random(g.shape) < 0.1] = 0.0
    ptr = ctypes.c_void_p
    for n in SIDES:
        A, dinv = c._crop_operator(g, n, n, dev)
        xs, bs = c._card_blocks(max(BATCHES), n, n, dev, seed=n, n=2)
        for B in BATCHES:
            x, b = xs[:B], bs[:B]
            ref = cs.residual_init_plain(A, dinv, b, x, 0.8)
            r0, x1 = torch.empty_like(x), torch.empty_like(x)
            args = [ptr(t.data_ptr()) for t in (*A.planes, dinv, b, x, r0,
                                                 x1)]
            row = {"n": n, "B": B,
                   "bound_ms": c.kernel_bytes("residual_init", B, n, n) /
                   rate * 1e3}
            for tag, lib in libs.items():
                def call():
                    err = lib.cs_residual_init(
                        *args, 0.8, B, n, n,
                        ptr(torch.cuda.current_stream().cuda_stream))
                    if err:
                        raise RuntimeError(f"{tag}: cuda error {err}")
                r0.fill_(float("nan"))
                x1.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                for got, want in zip((r0, x1), ref):
                    err = float((got - want).abs().max())
                    if not err <= c.TOL * float(want.abs().max()):
                        raise AssertionError(f"{tag} at B={B} {n}x{n}: "
                                             f"max err {err}")
                row[tag] = min(c.cuda_ms(call, n=50) for _ in range(3))
            print(json.dumps(row), flush=True)
        del A, dinv, xs, bs, x, b, ref, r0, x1
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
