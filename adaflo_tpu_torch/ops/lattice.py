"""Structured-lattice and index-map gather/scatter.

PyTorch counterpart of ``adaflo_tpu/ops/lattice.py``: on a structured mesh
the cell-local dof gather of a continuous Q_k space is strided slicing of the
dof lattice, and the transpose scatter-add is a sum of shifted window adds,
so neither needs an irregular index op and the sum order is fixed. Cell and
local orderings match ScalarSpace.cell_dofs (lexicographic, x fastest).

Periodic axes wrap by padding one node on the high side and folding its
contributions back. The parity-packed layouts of the JAX package answer the
TPU's memory system and are not ported; the CUDA kernel of
ops/coupled_matvec.py reads the nodal vectors through `cell_dof_table`.

On adaptive forests (mixed levels) `IndexMapOps` gathers through the cell
dof table and scatters through its transpose: for each dof, the flat
(cell, local) slots that touch it, padded with a slot that reads zero,
gathered and summed along the padded axis (`segment_table`,
`segment_sum`). Unlike an atomic `index_add_` on the card, that sum runs in
the same order in every run.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class LatticeOps:
    def __init__(
        self,
        n_nodes_axis: Sequence[int],
        n_cells_axis: Sequence[int],
        degree: int,
        periodic: Sequence[bool],
        n_dofs_padded: int,
    ) -> None:
        self.dim = len(n_nodes_axis)
        self.n_nodes_axis = tuple(n_nodes_axis)
        self.n_cells_axis = tuple(n_cells_axis)
        self.deg = degree
        self.periodic = tuple(periodic)
        self.n_dofs = int(np.prod(n_nodes_axis))
        self.n_dofs_padded = n_dofs_padded
        self.n_loc = (degree + 1) ** self.dim
        self.n_cells = int(np.prod(n_cells_axis))
        # lattice array shape in (z, y, x) order
        self.lat_shape = tuple(reversed(self.n_nodes_axis))

    # ------------------------------------------------------------------
    def _to_ext_lattice(self, u_flat):
        """Flat dof vector -> extended (wrap-padded) lattice array."""
        U = u_flat[: self.n_dofs].reshape(self.lat_shape)
        for a in range(self.dim):
            if self.periodic[self.dim - 1 - a]:
                U = torch.cat([U, U.narrow(a, 0, 1)], dim=a)
        return U

    def _split_axis_last(self, arr, nc: int):
        """(..., n_nodes_ext) -> (..., nc, deg+1) via overlap windows."""
        deg = self.deg
        body = arr[..., : deg * nc].reshape(arr.shape[:-1] + (nc, deg))
        last = arr[..., deg::deg]  # nodes deg, 2deg, ..., deg*nc
        return torch.cat([body, last[..., :, None]], dim=-1)

    def _combine_axis_last(self, arr, nc: int):
        """Transpose of _split_axis_last: (..., nc, deg+1) ->
        (..., deg*nc+1) with overlap accumulation."""
        deg = self.deg
        bnd0 = arr[..., :, 0]
        bndD = arr[..., :, deg]
        zeros = torch.zeros_like(bndD[..., :1])
        first_col = bnd0 + torch.cat([zeros, bndD[..., :-1]], dim=-1)
        if deg > 1:
            blocks = torch.cat([first_col[..., :, None], arr[..., :, 1:deg]], dim=-1)
        else:
            blocks = first_col[..., :, None]
        flat = blocks.reshape(arr.shape[:-2] + (nc * deg,))
        return torch.cat([flat, bndD[..., -1:]], dim=-1)

    def _gather_core(self, u_flat):
        """Window-split lattice with axes (cells..., loc_x, loc_y, loc_z)."""
        arr = self._to_ext_lattice(u_flat)
        d = self.dim
        for a in range(d):  # physical axis a = array axis d-1-a
            ax = d - 1 - a
            arr = torch.movedim(arr, ax, -1)
            arr = self._split_axis_last(arr, self.n_cells_axis[a])
            arr = torch.movedim(arr, -2, ax)
        return arr

    def gather(self, u_flat):
        """(n,) -> (E, n_loc)."""
        arr = self._gather_core(u_flat)
        d = self.dim
        loc_perm = list(range(d)) + [2 * d - 1 - i for i in range(d)]
        return arr.permute(loc_perm).reshape(self.n_cells, self.n_loc)

    def gather_t(self, u_flat):
        """(n,) -> (n_loc, E)."""
        arr = self._gather_core(u_flat)
        d = self.dim
        loc_perm = [2 * d - 1 - i for i in range(d)] + list(range(d))
        return arr.permute(loc_perm).reshape(self.n_loc, self.n_cells)

    def scatter_add(self, r_cells):
        """(E, n_loc) -> (n_padded,): transpose of gather."""
        d = self.dim
        cells_shape = tuple(reversed(self.n_cells_axis))
        arr = r_cells.reshape(cells_shape + (self.deg + 1,) * d)
        loc_perm = list(range(d)) + [2 * d - 1 - i for i in range(d)]
        return self._scatter_core(arr.permute(loc_perm))

    def scatter_add_t(self, r_t):
        """(n_loc, E) -> (n_padded,): transpose of gather_t."""
        d = self.dim
        cells_shape = tuple(reversed(self.n_cells_axis))
        arr = r_t.reshape((self.deg + 1,) * d + cells_shape)
        perm = list(range(d, 2 * d)) + [d - 1 - i for i in range(d)]
        return self._scatter_core(arr.permute(perm))

    def _scatter_core(self, arr):
        """Shared combiner: arr axes (cells..., loc_x, loc_y, loc_z)."""
        d = self.dim
        for a in reversed(range(d)):
            ax = d - 1 - a
            arr = torch.movedim(arr, ax, -2)
            arr = self._combine_axis_last(arr, self.n_cells_axis[a])
            arr = torch.movedim(arr, -1, ax)
        R = arr
        for ax in range(d):
            if self.periodic[d - 1 - ax]:
                R = torch.movedim(R, ax, -1)
                first = R[..., :1] + R[..., -1:]
                R = torch.cat([first, R[..., 1:-1]], dim=-1)
                R = torch.movedim(R, -1, ax)
        out = R.reshape(-1)
        if self.n_dofs_padded > self.n_dofs:
            out = torch.cat(
                [out, out.new_zeros(self.n_dofs_padded - self.n_dofs)]
            )
        return out

    def cell_dof_table(self) -> np.ndarray:
        """(E, n_loc) int32 cell -> dof index table in the gather's order:
        the gather applied to the dof numbers themselves."""
        idx = torch.arange(self.n_dofs, dtype=torch.int64)
        return self.gather(idx).numpy().astype(np.int32)

    @classmethod
    def for_space(cls, space) -> "LatticeOps":
        return cls(
            space.n_nodes_axis,
            space.mesh.n_cells_axis,
            space.degree,
            space.mesh.periodic,
            space.n_dofs_padded,
        )


def segment_table(ids, n_segments: int) -> np.ndarray:
    """(n_segments, width) table of the positions of `ids` that hold each
    segment number, in increasing position, padded with len(ids) (the slot
    `segment_sum` appends as zero); width is the largest segment, at
    least 1."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    counts = np.bincount(ids, minlength=n_segments)
    width = max(int(counts.max(initial=0)), 1)
    order = np.argsort(ids, kind="stable")
    starts = np.cumsum(counts) - counts
    rank = np.arange(len(ids)) - np.repeat(starts, counts)
    table = np.full((n_segments, width), len(ids), dtype=np.int64)
    table[ids[order], rank] = order
    return table


def segment_sum(vals, table):
    """Sums of the last axis of `vals` (..., L) over the segments of a
    segment_table of L positions on vals' device: (..., n_segments). A
    gather and a sum along the padded axis, the same order in every run."""
    pad = torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (1,))], dim=-1)
    return pad[..., table].sum(-1)


class IndexMapOps:
    """General gather/scatter through the explicit cell dof table, the port
    of the JAX package's IndexMapOps (adaflo_tpu/ops/lattice.py:325-363):
    the drop-in for LatticeOps where the strided-lattice path does not apply
    (adaptive forests with mixed levels). The gather is u[cell_dofs], the
    scatter the transpose table's segment_sum (deterministic, where the JAX
    package's `.at[].add` and a float64 index_add_ on the card sum in the
    order their updates land). Tables live on `device`."""

    def __init__(self, cell_dofs, n_dofs_padded: int, device) -> None:
        cd = np.asarray(cell_dofs, dtype=np.int64)
        self.n_cells, self.n_loc = cd.shape
        self.n_dofs_padded = int(n_dofs_padded)
        self.cd = torch.as_tensor(cd, device=device)
        self.table = torch.as_tensor(
            segment_table(cd.reshape(-1), self.n_dofs_padded), device=device
        )

    @classmethod
    def for_space(cls, space, device) -> "IndexMapOps":
        return cls(space.cell_dofs, space.n_dofs_padded, device)

    def gather(self, u):
        """(..., n_dofs_padded) -> (..., E, n_loc)"""
        return u[..., self.cd]

    def scatter_add(self, r_cells):
        """(..., E, n_loc) -> (..., n_dofs_padded)"""
        flat = r_cells.reshape(r_cells.shape[:-2] + (-1,))
        return segment_sum(flat, self.table)
