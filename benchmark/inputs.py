"""The one generator of every cell's inputs, from a configuration's sizes,
a traffic mix's parameters and the run's seed.

Set-up writes a pool of landscapes as ESRI ASCII grids, each a mosaic of
the configuration's public source map mirrored at its edges, drawn from
the configuration's own `pool_seed`: every run works on the same
landscapes, so that a seed changes which points are asked for and not
how hard the landscapes are.  Each job gets its own focal-point list
("id x y" in map coordinates, upstream's documented text format), drawn
from the run's seed and the job's number.  Job k reads landscape k mod P
and point list k, so no two jobs share their inputs.  The same seed
gives the same files, byte for byte.
"""

from __future__ import annotations

import os

import numpy as np

NODATA = -9999
WARM = "warm"           # the warm-up job's point list


def seed_words(seed: int, *stream: int):
    """An entropy list for numpy's SeedSequence: any whole seed (negative
    or past 64 bits too) and a stream of small non-negative ints."""
    return [seed & (2**64 - 1), seed >> 64 & (2**64 - 1), *stream]


def base_map(config, base_dir: str):
    """The configuration's public source map (`base_map`, a path under the
    benchmark's folder), its frame cut by `base_crop` (rows off the top
    and the bottom, columns off the left and the right)."""
    from benchmark.reference.grid_pairwise import read_asc
    vals, _ = read_asc(os.path.join(base_dir, config["base_map"]))
    top, bottom, left, right = config["base_crop"]
    return np.ascontiguousarray(
        vals[top:vals.shape[0] - bottom, left:vals.shape[1] - right])


def _mirror(n: int, period: int, start: int):
    """Indices start, start + 1, ... of a line mirrored at both ends of
    `period` cells, n of them."""
    m = (start + np.arange(n)) % (2 * period)
    return np.where(m < period, m, 2 * period - 1 - m)


def landscape(config, base: np.ndarray, seed: int, index: int):
    """(grid with NODATA, active mask) of landscape `index`: the source
    map, transposed or not, mirrored at its edges and repeated over the
    configuration's nrows x ncols from an offset, each drawn from the
    seed."""
    H, W = config["nrows"], config["ncols"]
    rng = np.random.default_rng(seed_words(seed, 0, index))
    b = base.T if rng.integers(2) else base
    rows = _mirror(H, b.shape[0], int(rng.integers(2 * b.shape[0])))
    cols = _mirror(W, b.shape[1], int(rng.integers(2 * b.shape[1])))
    g = b[rows[:, None], cols[None, :]]
    return g, (g != NODATA) & (g > 0)


def asc_body(g: np.ndarray, decimals: int) -> bytes:
    """The grid as fixed-width ASCII fields (vectorised): each value with
    `decimals` decimals, NODATA as -9999, one space between fields, one
    line per row.  Values must be >= 0 or NODATA."""
    H, W = g.shape
    nodata = g == NODATA
    scaled = np.rint(np.where(nodata, 0.0, g) * 10**decimals).astype(np.int64)
    if scaled.min() < 0:
        raise ValueError("asc_body writes non-negative values only")
    int_digits = max(1, len(str(int(scaled.max()) // 10**decimals)))
    width = max(int_digits + (decimals + 1 if decimals else 0),
                len(str(NODATA)))
    chars = np.full((H, W, width + 1), ord(" "), np.uint8)
    chars[:, -1, -1] = ord("\n")
    rest = scaled.copy()
    pos = width - 1
    for _ in range(decimals):
        chars[..., pos] = ord("0") + rest % 10
        rest //= 10
        pos -= 1
    if decimals:
        chars[..., pos] = ord(".")
        pos -= 1
    chars[..., pos] = ord("0") + rest % 10
    rest //= 10
    pos -= 1
    while pos >= 0 and rest.any():
        chars[..., pos] = np.where(rest > 0, ord("0") + rest % 10, ord(" "))
        rest //= 10
        pos -= 1
    text = str(NODATA).rjust(width).encode()
    chars[nodata, :width] = np.frombuffer(text, np.uint8)
    return chars.tobytes()


def write_asc(path: str, g: np.ndarray, config) -> None:
    H, W = g.shape
    header = (f"ncols         {W}\n"
              f"nrows         {H}\n"
              f"xllcorner     {config['xllcorner']!r}\n"
              f"yllcorner     {config['yllcorner']!r}\n"
              f"cellsize      {config['cellsize']!r}\n"
              f"NODATA_value  {NODATA}\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(asc_body(g, config["decimals"]))


def focal_cells(active: np.ndarray, n: int, seed: int, key: int):
    """n distinct active cells (row, col), drawn from the seed and `key`."""
    H, W = active.shape
    rng = np.random.default_rng(seed_words(seed, 1, key))
    flat = active.ravel()
    chosen = []
    seen = set()
    while len(chosen) < n:
        for c in rng.integers(0, H * W, size=4 * n).tolist():
            if flat[c] and c not in seen:
                seen.add(c)
                chosen.append(c)
                if len(chosen) == n:
                    break
    return [(c // W, c % W) for c in chosen]


def write_points(path: str, cells, config) -> None:
    """Point ids 1..n at the centres of their cells."""
    cs = config["cellsize"]
    top = config["yllcorner"] + config["nrows"] * cs
    with open(path, "w") as f:
        for k, (r, c) in enumerate(cells, start=1):
            x = config["xllcorner"] + (c + 0.5) * cs
            y = top - (r + 0.5) * cs
            f.write(f"{k} {x!r} {y!r}\n")


class JobInputs:
    """The files of a run, all under root: the pool of landscapes, the
    warm-up's point list, and for each job its point list (written when
    the job is first asked for, from the seed and the job's number) and
    a fresh output directory."""

    def __init__(self, root: str, config, traffic, seed: int,
                 base_dir: str):
        self.root = root
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.pool = config["landscapes"]
        os.makedirs(os.path.join(root, "out"), exist_ok=True)
        base = base_map(config, base_dir)
        self.actives = []
        for p in range(self.pool):
            g, active = landscape(config, base, config["pool_seed"], p)
            write_asc(self.habitat(p), g, config)
            self.actives.append(active)
            del g
        self._write_points(WARM, self.actives[0], 2**32)

    def _write_points(self, k, active, key: int) -> None:
        write_points(self.points(k), focal_cells(
            active, self.config["focal_points"], self.seed, key),
            self.config)

    def habitat(self, p: int) -> str:
        return os.path.join(self.root, f"landscape_{p}.asc")

    def points(self, k) -> str:
        return os.path.join(self.root, f"points_{k}.txt")

    def output_dir(self, k) -> str:
        return os.path.join(self.root, "out", f"job_{k}")

    def job(self, k):
        """(config dict for compute(), habitat file, point file) of job k
        (k = WARM for the warm-up, on landscape 0)."""
        habitat = self.habitat(0 if k == WARM else k % self.pool)
        points = self.points(k)
        if not os.path.exists(points):
            self._write_points(k, self.actives[k % self.pool], k)
        out = self.output_dir(k)
        os.makedirs(out, exist_ok=True)
        c = self.config
        cfg = {
            "data_type": "raster",
            "scenario": self.traffic["scenario"],
            "habitat_file": habitat,
            "habitat_map_is_resistances": str(c["habitat_map_is_resistances"]),
            "point_file": points,
            "output_file": os.path.join(out, "job.out"),
            "solver": c["solver"],
            "precision": c["precision"],
            "connect_four_neighbors_only":
                str(c["connect_four_neighbors_only"]),
            "connect_using_avg_resistances":
                str(c["connect_using_avg_resistances"]),
            "suppress_messages": "True",
        }
        cfg.update(self.traffic["options"])
        return cfg, habitat, points
