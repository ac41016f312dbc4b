"""Checkpoint/resume for pairwise jobs.

The reference has no in-job checkpointing (SURVEY §5): a crashed
million-pair run restarts from zero (the closest artifact is offline
re-accumulation of per-pair current maps, src/utils.jl:43-112).  Here a
job with `checkpoint_file = path.npz` in its config periodically
persists the solved-pair set, the partial resistance matrix and the
cumulative/max current maps, and a rerun with the same config resumes
after the last completed batch.

Extension key: `checkpoint_file` is a circuitscape_tpu(_torch) addition; the
reference config parser tolerates unknown keys the same way
(src/config.jl:87-135), so INI files remain interchangeable.
"""

from __future__ import annotations

import os

import numpy as np

from . import cslog


class Checkpoint:
    def __init__(self, path: str):
        self.path = path or ""
        self.done = set()

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    def load(self, resistances: np.ndarray, cum,
             voltmatrix: np.ndarray = None) -> set:
        """Restore state in place; returns the set of completed pair
        keys ((c_i, c_j) index tuples).  voltmatrix: the shortcut-mode
        normalized-voltage matrix (needed to reconstruct non-anchor
        resistances on resume, src/core.jl:685-739 semantics)."""
        if not self.enabled or not os.path.exists(self.path):
            return set()
        try:
            data = np.load(self.path, allow_pickle=False)
        except Exception as e:
            cslog.warn("Ignoring unreadable checkpoint %s: %s", self.path, e)
            return set()
        if data["resistances"].shape != resistances.shape:
            cslog.warn("Checkpoint %s does not match this problem; ignoring",
                       self.path)
            return set()
        resistances[:] = data["resistances"]
        if voltmatrix is not None and "voltmatrix" in data and \
                data["voltmatrix"].shape == voltmatrix.shape:
            voltmatrix[:] = data["voltmatrix"]
        if cum is not None:
            if cum.cum_curr.size and "cum_curr" in data and \
                    data["cum_curr"].shape == cum.cum_curr.shape:
                cum.cum_curr[:] = data["cum_curr"]
            if cum.max_curr.size and "max_curr" in data and \
                    data["max_curr"].shape == cum.max_curr.shape:
                cum.max_curr[:] = data["max_curr"]
            if cum.cum_branch_curr.size and "cum_branch_curr" in data:
                cum.cum_branch_curr[:] = data["cum_branch_curr"]
            if cum.cum_node_curr.size and "cum_node_curr" in data:
                cum.cum_node_curr[:] = data["cum_node_curr"]
        self.done = {tuple(p) for p in data["done_pairs"]}
        cslog.info("Resumed %d completed pair solves from %s",
                   len(self.done), self.path)
        return self.done

    def save(self, resistances: np.ndarray, cum,
             voltmatrix: np.ndarray = None) -> None:
        if not self.enabled:
            return
        payload = {
            "resistances": resistances,
            "done_pairs": np.asarray(sorted(self.done), np.int64).reshape(-1, 2),
        }
        if voltmatrix is not None:
            payload["voltmatrix"] = voltmatrix
        if cum is not None:
            if cum.cum_curr.size:
                payload["cum_curr"] = cum.cum_curr
            if cum.max_curr.size:
                payload["max_curr"] = cum.max_curr
            if cum.cum_branch_curr.size:
                payload["cum_branch_curr"] = cum.cum_branch_curr
            if cum.cum_node_curr.size:
                payload["cum_node_curr"] = cum.cum_node_curr
        tmp = self.path + ".tmp"
        np.savez_compressed(tmp, **payload)
        # np.savez appends .npz to names without an extension
        if not tmp.endswith(".npz"):
            tmp = tmp + ".npz"
        os.replace(tmp, self.path)

    def mark(self, pairs) -> None:
        self.done.update(pairs)

    def finish(self) -> None:
        """Remove the checkpoint once the job completes."""
        if self.enabled and os.path.exists(self.path):
            try:
                os.remove(self.path)
            except OSError:
                pass
