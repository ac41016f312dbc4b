"""The yardstick's arithmetic, frozen here so that no change to the program
moves it: the port's kernels' byte counts, the card's peaks, the union of
device intervals and the nesting-aware sums of host-timer sections.

kernel_bytes is chip_smoke.kernel_bytes, _busy_us is
profile_torch._busy_us and stage_seconds is bench_suite_torch.stage_seconds,
as each stood when the benchmark was written.
"""

from __future__ import annotations

# Published peak memory rates (NVIDIA data sheets), matched against
# torch.cuda.get_device_name(): first match wins.
PEAK_BYTES_PER_S = (
    ("H100 PCIe", 2.0e12),
    ("H100 NVL", 3.9e12),
    ("H100", 3.35e12),      # SXM5, 80 GB HBM3
)

# The port's seven stencil kernels (circuitscape_tpu_torch/solve/
# cuda_stencil.py), by the wrapper names of its launch counters.
KERNELS = ("matvec", "matvec_pap", "cheb_step", "residual_restrict",
           "cheb_init", "residual_init", "cheb_finish")


def peak_bytes_per_s(device_name: str):
    for key, rate in PEAK_BYTES_PER_S:
        if key in device_name:
            return rate
    return None


def kernel_bytes(name: str, B: int, H: int, W: int) -> int:
    """Bytes a launch must move on a (B, H, W) float32 block: each input
    read once, each output written once.  The smoother kernels count six
    planes (the five of L and Dinv), whatever a design reads."""
    cells = H * W
    coarse = -(-H // 2) * -(-W // 2)
    return 4 * {
        "matvec": (2 * B + 5) * cells,
        "matvec_pap": (2 * B + 5) * cells + B,
        "cheb_step": (6 * B + 6) * cells,
        "residual_restrict": (2 * B + 5) * cells + B * coarse,
        "cheb_init": (2 * B + 6) * cells,
        "residual_init": (4 * B + 6) * cells,
        "cheb_finish": (3 * B + 6) * cells,
    }[name]


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -1.0
    for s, e in sorted(spans):
        if s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def stage_seconds(sections, names) -> float:
    """Seconds of the timer sections `names` in one job's {path: [calls,
    seconds]}: a section counts unless a section of `names` encloses it
    (its seconds are then already counted)."""
    names = set(names)
    return sum(secs for path, (_, secs) in sections.items()
               if path[-1] in names and not any(p in names
                                                for p in path[:-1]))


def sections_seen(sections, names) -> bool:
    return any(path[-1] in names for path in sections)


def mean_sections(jobs, names):
    """Mean over jobs of stage_seconds(job.sections, names); None where no
    job ran any of the sections."""
    if not any(sections_seen(j.sections, names) for j in jobs):
        return None
    return sum(stage_seconds(j.sections, names) for j in jobs) / len(jobs)
