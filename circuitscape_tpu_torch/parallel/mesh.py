"""Multi-device scale-out: the stencil solve over a ('nodes', 'batch')
device mesh.

Counterpart of circuitscape_tpu/parallel/mesh.py.  The grid's row axis
shards over 'nodes' (halo exchanges of one row per seam for the
stencil reads) and the right-hand-side batch over 'batch' (independent
columns).  One process drives every device, as the JAX package's
single-controller mesh does; nothing here starts a process group.

GSPMD placed the JAX package's collectives from array shardings.  Here
the layout is explicit: a MeshBlock holds a (B, H, W) block as one
tensor per mesh position, and a ShardStencil a level's operator as one
StencilOperator per position, each with one halo row from each
neighbour shard (built once at setup).  ShardStencil has the solver
methods of solve/stencil.StencilOperator (matvec, cheb_step,
residual_restrict, prolong_add, coarse_solve, node_flows, ...) and
MeshBlock implements the few operations the CG loop and the V-cycle apply to
blocks (elementwise arithmetic, torch.where, per-column broadcasts, the
per-column sums), so those loop bodies stay the single-device ones:

  - elementwise operations run part by part; a plain tensor operand is
    sliced to each part's rows and columns (a per-column (B, 1, 1)
    factor to its columns);
  - per-column sums add the row shards' partial sums in shard order on
    the mesh's first device, and join the column groups in column
    order; the stop test reads the whole batch there;
  - a stencil application (shard_matvec, shard_cheb_step) sends one
    boundary row of the block per seam to the neighbour shard and runs
    the CUDA kernel on each shard's (b, h_local + 2, W) extended block,
    then drops the halo rows.

A level whose rows do not split (H % nodes, or under 8 rows a shard)
is held whole, with its column groups on the devices of the mesh's
first row; so are the coarsest grid and its pseudo-inverse.

The device list comes from visible_devices(); a mesh of virtual shards
of one device (several positions on one torch.device) runs every seam
exchange, per-shard launch and cross-shard sum on that device.
"""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch

from ..solve.cuda_stencil import cheb_step, matvec, residual_restrict
from ..solve.dispatch import _free_bytes
from ..solve.geomg import (GeoMgHierarchy, GeoMgLevel, _prolong, _restrict,
                           coarse_solve)
from ..solve.stencil import (StencilOperator, _branch_dirs, _max_branch,
                             _split_flows, poly_project, stencil_cg,
                             stencil_matvec)

# Grids below this many cells stay single-device by default on a mesh
# of CPU devices: at small sizes the halo exchanges cost more than the
# per-device work saved (the JAX package's default; override with
# CS_MESH_MIN_CELLS / force with CS_FORCE_MESH=1).
MESH_MIN_CELLS = 65536

# Device bytes a stencil job held per grid cell at its peak: 19.234 GiB
# over the 7040 x 7040 padded grid of the 48M-cell scale job
# (chip_smoke.py phase_scale, H100 80GB HBM3 at 700 W).  On CUDA devices
# a job takes the mesh by default only when that many bytes a cell
# exceed one card's free memory: the mesh ran the 1M-cell bench job in
# 0.751-0.799 s on four H100s against 0.338 s on one (chip_smoke.py
# --cards, H100 80GB HBM3 at 700 W).
CARD_BYTES_PER_CELL = 417


def visible_devices() -> list:
    """The devices a mesh spans: every visible CUDA device."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A (nodes, batch) grid of torch devices; a device may appear at
    several positions (virtual shards)."""

    axis_names = ("nodes", "batch")

    def __init__(self, devices):
        self.devices = tuple(tuple(torch.device(d) for d in row)
                             for row in devices)

    @property
    def shape(self) -> dict:
        return {"nodes": len(self.devices), "batch": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def lead(self) -> torch.device:
        return self.devices[0][0]

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i][j]

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        return (f"Mesh(nodes={self.shape['nodes']}, "
                f"batch={self.shape['batch']}, {self.devices[0][0]}...)")


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A ('nodes', 'batch') mesh over the first n of `devices` (default:
    visible_devices()).  n factorizes as (rows, cols) with rows the
    largest divisor <= sqrt(n), so both the grid-row axis and the batch
    axis shard.  CS_MESH_SHAPE="R,C" overrides the factorization
    (capacity-bound jobs want R = n, C = 1)."""
    devs = list(visible_devices() if devices is None else devices)
    n = n_devices or len(devs)
    env = os.environ.get("CS_MESH_SHAPE")
    if env:
        rows, cols = (int(v) for v in env.split(","))
        if rows * cols != n:
            raise ValueError(
                f"CS_MESH_SHAPE={env} does not match {n} devices")
    else:
        rows = 1
        for r in range(int(math.isqrt(n)), 0, -1):
            if n % r == 0:
                rows = r
                break
        cols = n // rows
    if len(devs) < n:
        raise ValueError(f"a mesh of {n} devices needs {n}, "
                         f"{len(devs)} are visible")
    return Mesh([devs[r * cols:(r + 1) * cols] for r in range(rows)])


def _min_cells(dev: torch.device) -> int:
    """The smallest grid that takes the mesh: CS_MESH_MIN_CELLS when
    set; else, on a CUDA device, the first grid whose
    CARD_BYTES_PER_CELL bytes a cell do not fit in its free memory; else
    MESH_MIN_CELLS."""
    env = os.environ.get("CS_MESH_MIN_CELLS")
    if env:
        return int(env)
    if dev.type == "cuda":
        return _free_bytes(dev) // CARD_BYTES_PER_CELL + 1
    return MESH_MIN_CELLS


def active_mesh(ncells: int | None = None, device=None) -> Mesh | None:
    """The mesh a job on `device` runs on, or None for one device.

    On when more than one device of the job's device type is visible
    (CS_DISABLE_MESH turns it off) and the grid has at least _min_cells
    cells, or CS_FORCE_MESH is set.  All three are read at call time."""
    if os.environ.get("CS_DISABLE_MESH"):
        return None
    devs = visible_devices()
    if len(devs) < 2:
        return None
    if device is not None and torch.device(device).type != devs[0].type:
        return None
    if (not os.environ.get("CS_FORCE_MESH") and ncells is not None and
            ncells < _min_cells(devs[0])):
        return None
    return make_mesh(len(devs), devs)


def mesh_of(x) -> Mesh | None:
    """The mesh a MeshBlock or ShardStencil lies on; None otherwise."""
    return getattr(x, "mesh", None)


def pad_to_mesh(arr: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Pad leading (row) and trailing (batch) dims to multiples of the
    mesh axis sizes so shards are equal."""
    rows = mesh.shape["nodes"]
    batch = mesh.shape["batch"]
    if arr.ndim == 3:  # (B, H, W) solve block
        Bp = -(-arr.shape[0] // batch) * batch
        H = -(-arr.shape[1] // rows) * rows
        pads = [(0, Bp - arr.shape[0]), (0, H - arr.shape[1]), (0, 0)]
    else:              # (H, W) weight plane
        H = -(-arr.shape[0] // rows) * rows
        pads = [(0, H - arr.shape[0]), (0, 0)]
    return np.pad(arr, pads)


def _on(dev: torch.device):
    """Make dev the current CUDA device (the kernels launch there)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _once_each(items, make, key=id) -> list:
    """[make(x) for x in items], calling make once per distinct key(x)."""
    seen, out = {}, []
    for x in items:
        k = key(x)
        if k not in seen:
            seen[k] = make(x)
        out.append(seen[k])
    return out


def _per_device(t: torch.Tensor, devices) -> list:
    """t on each of devices, one copy per distinct device."""
    return _once_each(devices, t.to, key=lambda d: d)


# --- blocks ---------------------------------------------------------------

_REDUCE_DIMS = ((-2, -1), [-2, -1])


class MeshBlock:
    """A tensor laid out over a mesh.

    parts[i][j] holds row shard i (of nsh: the mesh's nodes, or 1 when
    the rows are whole) and column group j (of the mesh's batch) on
    mesh.device(i, j).  A block (B, H, W) splits B into equal column
    groups (batched); a plane (H, W), or (1, H, W), has one column group
    held on every column's device (not batched).  Parts are never
    updated in place: on virtual shards a part may share storage with
    another position's."""

    def __init__(self, mesh: Mesh, parts, batched: bool):
        self.mesh = mesh
        self.parts = [list(row) for row in parts]
        self.batched = batched

    # layout ----------------------------------------------------------
    @property
    def nsh(self) -> int:
        return len(self.parts)

    @property
    def row_counts(self) -> tuple:
        return tuple(p[0].shape[-2] for p in self.parts)

    @property
    def col_counts(self) -> tuple:
        return tuple(p.shape[0] for p in self.parts[0])

    @property
    def shape(self) -> tuple:
        p = self.parts[0][0]
        lead = ((sum(self.col_counts),) if self.batched else
                tuple(p.shape[:-2]))
        return lead + (sum(self.row_counts), p.shape[-1])

    @property
    def dtype(self):
        return self.parts[0][0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    # construction ----------------------------------------------------
    @classmethod
    def split(cls, t: torch.Tensor, mesh: Mesh, nsh: int,
              batched: bool = True) -> "MeshBlock":
        """Lay the full tensor t out over mesh with nsh row shards (its
        rows must divide) and, when batched, the mesh's column groups
        (B must divide).  Parts are contiguous; on t's own device a part
        may be a view of t."""
        ncol = mesh.shape["batch"]
        H = t.shape[-2]
        if H % nsh:
            raise ValueError(f"{H} rows do not split into {nsh} shards")
        hs = H // nsh
        if batched:
            B = t.shape[0]
            if B % ncol:
                raise ValueError(f"{B} columns do not split into {ncol} "
                                 f"groups")
            bs = B // ncol
            parts = [[t[j * bs:(j + 1) * bs, i * hs:(i + 1) * hs]
                      .to(mesh.device(i if nsh > 1 else 0, j))
                      .contiguous() for j in range(ncol)]
                     for i in range(nsh)]
        else:
            parts = [_per_device(t[..., i * hs:(i + 1) * hs, :].contiguous(),
                                 [mesh.device(i if nsh > 1 else 0, j)
                                  for j in range(ncol)])
                     for i in range(nsh)]
        return cls(mesh, parts, batched)

    def like(self, t: torch.Tensor) -> "MeshBlock":
        """A full tensor of this block's shape laid out as this block."""
        return MeshBlock.split(t, self.mesh, self.nsh, self.batched)

    def gather(self) -> torch.Tensor:
        """The full tensor on the mesh's first device: the row shards
        joined in order, then the column groups."""
        lead = self.mesh.lead
        cols = [torch.cat([self.parts[i][j].to(lead)
                           for i in range(self.nsh)], dim=-2)
                for j in range(len(self.parts[0]))]
        return torch.cat(cols, dim=0) if self.batched else cols[0]

    def rows_whole(self) -> "MeshBlock":
        """This block with its rows joined, each column group on the
        device of the mesh's first row."""
        if self.nsh == 1:
            return self
        parts = [[torch.cat([self.parts[i][j].to(self.mesh.device(0, j))
                             for i in range(self.nsh)], dim=-2)
                  for j in range(len(self.parts[0]))]]
        return MeshBlock(self.mesh, parts, self.batched)

    def rows_split(self, nsh: int) -> "MeshBlock":
        """This whole-row block split into nsh row shards."""
        if nsh == self.nsh:
            return self
        assert self.nsh == 1
        H = self.shape[-2]
        hs = H // nsh
        parts = [[self.parts[0][j][..., i * hs:(i + 1) * hs, :]
                  .to(self.mesh.device(i, j)).contiguous()
                  for j in range(len(self.parts[0]))] for i in range(nsh)]
        return MeshBlock(self.mesh, parts, self.batched)

    def map(self, fn) -> "MeshBlock":
        """fn(part, i, j) for every part, as a block of the same layout."""
        return MeshBlock(self.mesh, [[fn(p, i, j) for j, p in enumerate(row)]
                                     for i, row in enumerate(self.parts)],
                         self.batched)

    # part-wise operations ----------------------------------------------
    def _local(self, t, i, j, nrows, ncols):
        """Plain-tensor operand t sliced to part (i, j) of this layout:
        its row dim when it spans the rows, its column dim when it spans
        a batched block's columns; broadcast dims stay whole."""
        if not isinstance(t, torch.Tensor):
            return t
        dev = self.parts[i][j].device
        if t.dim() >= 2 and t.shape[-2] == sum(nrows) and t.shape[-2] > 1:
            r0 = sum(nrows[:i])
            t = t[..., r0:r0 + nrows[i], :]
        if (self.batched and t.dim() == 3 and t.shape[0] == sum(ncols) and
                t.shape[0] > 1):
            c0 = sum(ncols[:j])
            t = t[c0:c0 + ncols[j]]
        return t.to(dev)

    @staticmethod
    def apply(fn, *args, **kwargs) -> "MeshBlock":
        """fn applied part by part to MeshBlock arguments (of one row
        layout) and plain operands; the result is batched if any block
        argument is."""
        blocks = [a for a in list(args) + list(kwargs.values())
                  if isinstance(a, MeshBlock)]
        ref = next((b for b in blocks if b.batched), blocks[0])
        for b in blocks:
            if b.mesh != ref.mesh or b.row_counts != ref.row_counts:
                raise ValueError("MeshBlock operands of different layouts")
            if b.batched and b.col_counts != ref.col_counts:
                raise ValueError("MeshBlock operands of different batches")
        nrows, ncols = ref.row_counts, ref.col_counts

        def loc(a, i, j):
            if isinstance(a, MeshBlock):
                return a.parts[i][j]
            return ref._local(a, i, j, nrows, ncols)

        parts = [[fn(*(loc(a, i, j) for a in args),
                     **{k: loc(v, i, j) for k, v in kwargs.items()})
                  for j in range(len(ref.parts[0]))]
                 for i in range(ref.nsh)]
        return MeshBlock(ref.mesh, parts, any(b.batched for b in blocks))

    def colsum(self) -> torch.Tensor:
        """Per-column sum over the grid, (B,) on the mesh's first device:
        each column group's row-shard partial sums added in shard order,
        the groups joined in column order."""
        lead = self.mesh.lead
        out = []
        for j in range(len(self.parts[0])):
            acc = torch.sum(self.parts[0][j], dim=(-2, -1)).to(lead)
            for i in range(1, self.nsh):
                acc = acc + torch.sum(self.parts[i][j], dim=(-2, -1)).to(lead)
            out.append(acc)
        return torch.cat(out) if self.batched else out[0]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.sum:
            dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if dim in _REDUCE_DIMS and not kwargs.get("keepdim"):
                return args[0].colsum()
        elif func is torch.max and len(args) == 1 and not kwargs:
            a = args[0]
            return torch.stack([p.max().to(a.mesh.lead)
                                for row in a.parts for p in row]).max()
        elif func in _ELEMENTWISE:
            return MeshBlock.apply(func, *args, **kwargs)
        raise TypeError(f"{getattr(func, '__name__', func)} is not defined "
                        f"on a MeshBlock")

    def __getitem__(self, key):
        if key is None:
            return self.map(lambda t, i, j: t[None])
        raise TypeError("a MeshBlock takes only [None] indexing")

    def to(self, *args, **kwargs):
        return MeshBlock.apply(lambda t: t.to(*args, **kwargs), self)


# the operations the CG loop and the V-cycle apply to blocks
_OPS = ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
        "__truediv__", "__rtruediv__", "__gt__", "__eq__")
_ELEMENTWISE = {getattr(torch.Tensor, n) for n in _OPS} | {
    torch.Tensor.to, torch.where, torch.zeros_like}

for _name in _OPS:
    def _op(self, other, _f=getattr(torch.Tensor, _name)):
        return MeshBlock.apply(_f, self, other)
    setattr(MeshBlock, _name, _op)
MeshBlock.__hash__ = object.__hash__


def gather(x):
    """The full tensor of a MeshBlock on the mesh's first device; any
    other value unchanged."""
    return x.gather() if isinstance(x, MeshBlock) else x


# --- operators ------------------------------------------------------------

class ShardStencil:
    """A multigrid level's (or the float64 system's) stencil operator
    over a mesh: ops[i][j] a StencilOperator on mesh.device(i, j), one
    object per distinct device.  With nsh > 1 row shards each op's five
    planes (and dinv, the level's inverse diagonal, when given) carry one
    halo row from each neighbour shard: (h_local + 2, W), zero rows at
    the grid's top and bottom.  With nsh = 1 the level is whole on the
    devices of the mesh's first row and carries no halo."""

    def __init__(self, mesh: Mesh, ops, shape, dinv=None):
        self.mesh = mesh
        self.ops = ops
        self.dinv = dinv
        self.shape = tuple(shape)
        self.nsh = len(ops)
        self.h_local = self.shape[0] // self.nsh

    @property
    def halo(self) -> bool:
        return self.nsh > 1

    @property
    def dtype(self):
        return self.ops[0][0].diag.dtype

    def _interior(self, t):
        return t[1:-1] if self.halo else t

    @property
    def diag(self) -> MeshBlock:
        """The diagonal plane, as a MeshBlock without halo rows."""
        return MeshBlock(self.mesh, [[self._interior(op.diag) for op in row]
                                     for row in self.ops], False)

    def inv_diag(self) -> MeshBlock:
        return MeshBlock(self.mesh, [[self._interior(d) for d in row]
                                     for row in self.dinv], False)

    def to_dtype(self, dtype) -> "ShardStencil":
        def cast(op):
            return StencilOperator(*(p.to(dtype).contiguous()
                                     for p in op.planes))
        return ShardStencil(self.mesh, [_once_each(row, cast)
                                        for row in self.ops], self.shape)

    def full(self) -> StencilOperator:
        """The five planes joined into full (H, W) tensors on the mesh's
        first device."""
        lead = self.mesh.lead
        return StencilOperator(*(
            torch.cat([self._interior(row[0].planes[k]).to(lead)
                       for row in self.ops]) for k in range(5)))

    # StencilOperator's solver operations, over the mesh
    @property
    def col_groups(self) -> int:
        return self.mesh.shape["batch"]

    def layout(self, x) -> MeshBlock:
        return as_block(x, self)

    def gather(self, x):
        return gather(x)

    def matvec(self, x: MeshBlock) -> MeshBlock:
        return shard_matvec(self, x)

    def matvec_pap(self, p: MeshBlock):
        """(L p, p.Lp): the sharded matvec and the shard-ordered column
        sum, as the JAX package's mesh CG loop computes them."""
        y = shard_matvec(self, p)
        return y, (p * y).colsum()

    def cheb_step(self, dinv, r, d, x, ca: float, cb: float):
        """One Chebyshev step; the level's own halo-extended inverse
        diagonal takes the place of dinv."""
        return shard_cheb_step(self, r, d, x, ca, cb)

    def residual_restrict(self, b, x, coarse=None) -> MeshBlock:
        return shard_residual_restrict(
            self, b, x, 1 if coarse is None else coarse.nsh)

    def prolong_add(self, x: MeshBlock, xc: MeshBlock,
                    scale: float) -> MeshBlock:
        """x + scale * P xc, as the JAX package's mesh V-cycle computes
        it (a new block)."""
        return x + scale * shard_prolong(xc, *self.shape, self.nsh)

    def coarse_solve(self, pinv: MeshBlock, b: MeshBlock) -> MeshBlock:
        return shard_coarse_solve(pinv, b)

    def project(self, proj, y: MeshBlock) -> MeshBlock:
        """The polygon projector, whose segment sums span the grid, on
        the joined block."""
        if proj.nseg == 1:
            return y
        return y.like(poly_project(proj, y.gather()))

    def node_flows(self, V, cutoff: float):
        return shard_node_currents(self, V, cutoff)


def _row_slabs(p: torch.Tensor, nsh: int) -> list:
    hs = p.shape[0] // nsh
    return [p[i * hs:(i + 1) * hs] for i in range(nsh)]


def _extend(slabs, mesh: Mesh, halo: bool):
    """Per mesh position, slab i of a row-split plane on device (i, j):
    with halo, joined with the neighbour slabs' boundary rows (zero rows
    past the grid); one tensor per distinct device."""
    ncol = mesh.shape["batch"]
    out = []
    for i, s in enumerate(slabs):
        devs = [mesh.device(i if halo else 0, j) for j in range(ncol)]
        if halo:
            z = s.new_zeros((1, s.shape[-1]))
            up = slabs[i - 1][-1:] if i > 0 else z
            dn = slabs[i + 1][:1] if i < len(slabs) - 1 else z
            # the neighbours' boundary rows join the slab once, at setup
            s = torch.cat([up.to(s.device), s, dn.to(s.device)])
        out.append(_per_device(s.contiguous(), devs))
    return out


def shard_stencil_from_slabs(mesh: Mesh, plane_slabs,
                             dinv_slabs=None) -> ShardStencil:
    """ShardStencil from per-shard row slabs of the five planes
    (plane_slabs[k][i]) and of dinv; one shard when there is one slab."""
    nsh = len(plane_slabs[0])
    halo = nsh > 1
    ext = [_extend(slabs, mesh, halo) for slabs in plane_slabs]
    ncol = mesh.shape["batch"]
    ops = []
    for i in range(nsh):
        devs = mesh.devices[i if halo else 0]

        def op(j, i=i):
            return StencilOperator(*(ext[k][i][j] for k in range(5)))
        ops.append(_once_each(range(ncol), op, key=lambda j: devs[j]))
    dinv = None if dinv_slabs is None else _extend(dinv_slabs, mesh, halo)
    H = sum(s.shape[0] for s in plane_slabs[0])
    return ShardStencil(mesh, ops, (H, plane_slabs[0][0].shape[-1]), dinv)


def build_shard_stencil(mesh: Mesh, A: StencilOperator, dinv=None):
    """ShardStencil of A with its rows split over 'nodes'; None when the
    row count does not split evenly or leaves fewer than 8 rows a
    shard."""
    nsh = mesh.shape["nodes"]
    H, W = A.shape
    if H % nsh or (H // nsh) < 8:
        return None
    return shard_stencil_from_slabs(
        mesh, [_row_slabs(p, nsh) for p in A.planes],
        None if dinv is None else _row_slabs(dinv, nsh))


def replicate_stencil(mesh: Mesh, A: StencilOperator,
                      dinv=None) -> ShardStencil:
    """A whole on the devices of the mesh's first row."""
    return shard_stencil_from_slabs(
        mesh, [[p] for p in A.planes], None if dinv is None else [dinv])


def shard_stencil(mesh: Mesh, A: StencilOperator) -> ShardStencil:
    """A's planes row-sharded over the 'nodes' axis."""
    ss = build_shard_stencil(mesh, A)
    if ss is None:
        raise ValueError(f"{A.shape[0]} rows do not split into "
                         f"{mesh.shape['nodes']} shards of at least 8")
    return ss


def shard_rhs(mesh: Mesh, B: torch.Tensor) -> MeshBlock:
    """RHS blocks (nrhs, H, W): pairs over 'batch', grid rows over
    'nodes'."""
    return MeshBlock.split(B, mesh, mesh.shape["nodes"])


def as_block(x, ss: ShardStencil) -> MeshBlock:
    """x laid out for ss: a MeshBlock as is, a full tensor split over
    ss's row shards and, where its columns divide, the mesh's column
    groups (else one group)."""
    if isinstance(x, MeshBlock):
        return x
    ncol = ss.mesh.shape["batch"]
    if x.shape[0] % ncol == 0:
        return MeshBlock.split(x, ss.mesh, ss.nsh)
    sub = Mesh([[row[0]] for row in ss.mesh.devices])
    return MeshBlock.split(x, sub, ss.nsh)


def _with_halo(x: MeshBlock, zero: bool = False):
    """Per part, the (b, h + 2, W) block joined with one boundary row of
    each neighbour shard (zero rows past the grid, or everywhere with
    zero=True).  torch.cat copies, so no halo aliases a neighbour."""
    out = []
    for i, row in enumerate(x.parts):
        r = []
        for j, t in enumerate(row):
            z = t.new_zeros(t.shape[:-2] + (1, t.shape[-1]))
            up = z if zero or i == 0 else x.parts[i - 1][j][..., -1:, :]
            dn = z if zero or i == x.nsh - 1 else x.parts[i + 1][j][..., :1, :]
            r.append(torch.cat([up.to(t.device), t, dn.to(t.device)], dim=-2))
        out.append(r)
    return out


def shard_matvec(ss: ShardStencil, x: MeshBlock) -> MeshBlock:
    """y = L x over the mesh: each shard's block with one halo row from
    each neighbour, the stencil applied to the (b, h_local + 2, W)
    extended block, the halo rows of y dropped.  A float32 block goes
    through the CUDA matvec kernel (on a CUDA tensor the kernel or an
    exception), a float64 one (the refinement residuals) through
    stencil_matvec, as solve/stencil._apply_op does on one device."""
    f = matvec if x.dtype == torch.float32 else stencil_matvec
    if not ss.halo:
        def whole(t, i, j):
            with _on(t.device):
                return f(ss.ops[0][j], t.contiguous())
        return x.map(whole)
    xe = _with_halo(x)

    def part(t, i, j):
        with _on(t.device):
            return f(ss.ops[i][j], xe[i][j])[..., 1:-1, :].contiguous()
    return x.map(part)


def shard_cheb_step(ss: ShardStencil, r: MeshBlock, d: MeshBlock,
                    x: MeshBlock, ca: float, cb: float):
    """One Chebyshev step (cuda_stencil.cheb_step) over the mesh: d
    carries the neighbours' halo rows; r and x zero halo rows, whose
    outputs are dropped."""
    if not ss.halo:
        outs = [[None] * len(row) for row in r.parts]
        for j, t in enumerate(r.parts[0]):
            with _on(t.device):
                outs[0][j] = cheb_step(ss.ops[0][j], ss.dinv[0][j],
                                       t.contiguous(),
                                       d.parts[0][j].contiguous(),
                                       x.parts[0][j].contiguous(), ca, cb)
    else:
        de = _with_halo(d)
        re = _with_halo(r, zero=True)
        xe = _with_halo(x, zero=True)
        outs = []
        for i in range(r.nsh):
            row = []
            for j in range(len(r.parts[0])):
                with _on(re[i][j].device):
                    o = cheb_step(ss.ops[i][j], ss.dinv[i][j], re[i][j],
                                  de[i][j], xe[i][j], ca, cb)
                row.append(tuple(t[..., 1:-1, :].contiguous() for t in o))
            outs.append(row)
    return tuple(MeshBlock(r.mesh, [[o[k] for o in row] for row in outs],
                           True) for k in range(3))


def shard_residual_restrict(ss: ShardStencil, b: MeshBlock, x: MeshBlock,
                            nsh_next: int) -> MeshBlock:
    """The 2x2 restriction of b - L x, laid out for a next level of
    nsh_next row shards.  A whole level runs the residual_restrict
    kernel; a sharded one forms the residual with shard_matvec and
    restricts per shard where its local rows pair up within the shard
    and the next level keeps the split, else on the joined rows."""
    if not ss.halo:
        def whole(t, i, j):
            with _on(t.device):
                return residual_restrict(ss.ops[0][j], t.contiguous(),
                                         x.parts[0][j].contiguous())
        return b.map(whole).rows_split(nsh_next) if nsh_next > 1 else \
            b.map(whole)
    r = b - shard_matvec(ss, x)
    if nsh_next == ss.nsh and ss.h_local % 2 == 0:
        return r.map(lambda t, i, j: _restrict(t))
    rc = r.rows_whole().map(lambda t, i, j: _restrict(t))
    return rc.rows_split(nsh_next) if nsh_next > 1 else rc


def shard_prolong(xc: MeshBlock, H: int, W: int, nsh: int) -> MeshBlock:
    """Piecewise-constant interpolation of the coarse block xc to (H, W)
    laid out in nsh row shards (geomg._prolong)."""
    if xc.nsh == nsh > 1 and 2 * xc.row_counts[0] == H // nsh:
        return xc.map(lambda t, i, j: _prolong(t, 2 * t.shape[-2], W))
    up = xc.rows_whole().map(lambda t, i, j: _prolong(t, H, W))
    return up.rows_split(nsh) if nsh > 1 else up


def shard_coarse_solve(pinv: MeshBlock, b: MeshBlock) -> MeshBlock:
    """The coarsest grid's dense pseudo-inverse solve, per column group
    on the devices of the mesh's first row."""
    def solve(t, i, j):
        with _on(t.device):
            return coarse_solve(pinv.parts[0][j], t)
    return b.rows_whole().map(solve)


def shard_node_currents(ss: ShardStencil, V, cutoff=1e-8):
    """(inflow, outflow) of stencil_node_currents over the mesh, as full
    tensors on the mesh's first device: each shard's branch currents
    from its halo-extended voltages (V, full or a MeshBlock, laid out as
    ss), the per-column cutoff the maximum over every shard's interior
    cells, taken before any shard thresholds."""
    Vb = as_block(V, ss)
    if ss.halo:
        ve, rows = _with_halo(Vb), slice(1, -1)
    else:
        ve, rows = Vb.parts, slice(None)
    dirs = [[_branch_dirs(ss.ops[i][j], Vb.dtype) for j in range(len(row))]
            for i, row in enumerate(Vb.parts)]
    lead = Vb.mesh.lead
    thr = []
    for j in range(len(Vb.parts[0])):
        m = _max_branch(dirs[0][j], ve[0][j], rows).to(lead)
        for i in range(1, Vb.nsh):
            m = torch.maximum(
                m, _max_branch(dirs[i][j], ve[i][j], rows).to(lead))
        thr.append((cutoff * m)[:, None, None])
    flows = [[_split_flows(dirs[i][j], v, thr[j].to(v.device))
              for j, v in enumerate(row)] for i, row in enumerate(ve)]
    return tuple(MeshBlock(Vb.mesh, [[f[k][..., rows, :] for f in row]
                                     for row in flows], True).gather()
                 for k in range(2))


# --- hierarchy and the sharded CG -----------------------------------------

def shard_hierarchy(mesh: Mesh, hier):
    """A geo-MG hierarchy on the mesh: levels whose rows split evenly
    (at least 8 rows a shard) shard over 'nodes', with halo rows; the
    others, and the coarse pseudo-inverse, are held whole on the devices
    of the mesh's first row.  Every level smooths with the generic
    configuration (cheb_step and matvec): the fused smoother reads two
    rows across a seam."""
    levels = []
    for L in hier.levels:
        ss = L.A if isinstance(L.A, ShardStencil) else (
            build_shard_stencil(mesh, L.A, L.inv_diag) or
            replicate_stencil(mesh, L.A, L.inv_diag))
        levels.append(GeoMgLevel(ss, ss.inv_diag(), L.lam_max, False))
    pinv = hier.coarse_pinv
    if not isinstance(pinv, MeshBlock):
        pinv = MeshBlock(mesh, [_per_device(pinv, [
            mesh.device(0, j) for j in range(mesh.shape["batch"])])], False)
    return GeoMgHierarchy(tuple(levels), pinv, hier.coarse_shape,
                          hier.overcorrect)


def sharded_stencil_cg(mesh: Mesh, A: StencilOperator, B: torch.Tensor,
                       rtol=1e-6, itmax=100_000):
    """Batched Jacobi-preconditioned stencil CG over the mesh, the mesh
    counterpart of stencil.stencil_cg: A's rows shard over 'nodes', B's
    columns over 'batch'.  Returns (X (full, on the mesh's first
    device), relres (B,), iters)."""
    ss = shard_stencil(mesh, A)
    X, relres, iters = stencil_cg(ss, shard_rhs(mesh, B), rtol,
                                  itmax=itmax)
    return X.gather(), relres, iters
