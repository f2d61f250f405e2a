"""Solution transfer between adaptive forest refinements.

PyTorch port's counterpart of ``adaflo_tpu/fe/forest_transfer.py`` (host
numpy). The counterpart of deal.II parallel::distributed::SolutionTransfer as the
reference uses it around every refine_grid
(source/two_phase_base_algorithm.cc refine_grid,
navier_stokes.cc refine_grid_pressure_based): the old FE function is
evaluated at the nodes of the new space. Because our spaces are nodal
(Lagrange), interpolation at nodes IS the deal.II transfer for refinement
(children interpolate the parent polynomial exactly) and coarsening
(the parent interpolates child nodal values — deal.II injects; nodal
interpolation differs only on non-nested data and is the standard choice).

Point location is O(log E) per point: every forest cell owns a contiguous
range of finest-level Morton codes, so locating a point is a searchsorted on
the cells' starting codes — no geometric walks.
"""

from __future__ import annotations

import numpy as np

from adaflo_tpu_torch.fe.forest_space import ForestSpace


def _morton(ix: np.ndarray, iy: np.ndarray, iz, L: int) -> np.ndarray:
    """Interleaved Morton code (x lowest bit) for integer coords < 2^L."""
    code = np.zeros(np.shape(ix), dtype=np.int64)
    dim = 2 if iz is None else 3
    for b in range(L):
        code |= ((ix >> b) & 1) << (dim * b)
        code |= ((iy >> b) & 1) << (dim * b + 1)
        if iz is not None:
            code |= ((iz >> b) & 1) << (dim * b + 2)
    return code


class ForestFunction:
    """Snapshot of a ForestSpace + dof vector(s), evaluable at points after
    the underlying forest has been adapted."""

    def __init__(self, space: ForestSpace) -> None:
        forest = space.forest
        self.dim = space.dim
        self.basis = space.basis
        self.cell_dofs = space.cell_dofs.copy()
        self.cell_origin = space.cell_origin.copy()
        self.h_cells = space.h_cells.copy()
        self.origin = np.asarray(forest.origin, dtype=np.float64)
        self.lengths = np.asarray(forest.lengths, dtype=np.float64)
        self.n_roots = forest.n_roots
        roots, levels, anchors = forest.cells()
        L = int(levels.max())
        self._L = L
        scale = (1 << (L - levels)).astype(np.int64)
        fx = anchors[:, 0] * scale
        fy = anchors[:, 1] * scale
        fz = anchors[:, 2] * scale if self.dim == 3 else None
        code = _morton(fx, fy, fz, L)
        root_id = roots[:, 0].astype(np.int64)
        for a in range(1, self.dim):
            root_id = root_id + roots[:, a].astype(np.int64) * int(
                np.prod(self.n_roots[:a])
            )
        n_roots_total = int(np.prod(self.n_roots))
        assert self.dim * L + max(1, n_roots_total).bit_length() < 62, (
            "forest too deep for int64 Morton keys"
        )
        key = root_id * (1 << (self.dim * L)) + code
        order = np.argsort(key)
        self._cell_order = order
        self._cell_keys = key[order]
        self._h_root = self.lengths / np.asarray(self.n_roots)

    def locate(self, points: np.ndarray) -> np.ndarray:
        """Owning cell index (original forest ordering) per point."""
        pts = np.asarray(points, dtype=np.float64)
        L = self._L
        # finest-level integer coords, clamped into the domain
        rel = (pts - self.origin) / self._h_root
        root = np.clip(rel.astype(np.int64), 0, np.asarray(self.n_roots) - 1)
        frac = rel - root
        fine = np.clip((frac * (1 << L)).astype(np.int64), 0, (1 << L) - 1)
        code = _morton(
            fine[:, 0], fine[:, 1], fine[:, 2] if self.dim == 3 else None, L
        )
        root_id = root[:, 0].copy()
        for a in range(1, self.dim):
            root_id += root[:, a] * int(np.prod(self.n_roots[:a]))
        key = root_id * (1 << (self.dim * L)) + code
        pos = np.searchsorted(self._cell_keys, key, side="right") - 1
        return self._cell_order[pos]

    def evaluate(self, u, points: np.ndarray) -> np.ndarray:
        """Evaluate dof vector(s) u (..., n_dofs) at points (N, dim) ->
        (..., N). u must already be distributed (constraints applied)."""
        u = np.asarray(u)
        pts = np.asarray(points, dtype=np.float64)
        cells = self.locate(pts)
        xi = (pts - self.cell_origin[cells]) / self.h_cells[cells]
        xi = np.clip(xi, 0.0, 1.0)
        n1 = self.basis.n_dofs
        # per-axis 1D basis values: (N, n1) each
        W = [self.basis.tabulate(xi[:, a])[0] for a in range(self.dim)]
        if self.dim == 1:
            wloc = W[0]
        elif self.dim == 2:
            wloc = np.einsum("nj,ni->nji", W[1], W[0]).reshape(len(pts), -1)
        else:
            wloc = np.einsum("nk,nj,ni->nkji", W[2], W[1], W[0]).reshape(
                len(pts), -1
            )
        dofs = self.cell_dofs[cells]  # (N, n_loc)
        return np.einsum("...nl,nl->...n", u[..., dofs], wloc)


def transfer_solution(old_fn: ForestFunction, new_space: ForestSpace, u_old):
    """Interpolate (already-distributed) u_old onto the new space's nodes."""
    return old_fn.evaluate(u_old, new_space.node_coords)
