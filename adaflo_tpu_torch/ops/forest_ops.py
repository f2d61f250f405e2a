"""Matrix-free operators on adaptive ForestSpace meshes.

PyTorch counterpart of ``adaflo_tpu/ops/forest_ops.py``: the general
index-map gather/scatter path (ops/lattice.IndexMapOps) paired with the
per-cell geometry of VariableCellEvaluator, the adaptive-mesh counterpart of
the uniform-lattice operators. Constraints follow the deal.II matrix-free
convention the lattice operators use (resolve -> cell loop -> condense ->
identity rows), with the multi-master rows of hanging nodes.

Carries the scalar building blocks (the Helmholtz operator alpha M + beta K,
its right-hand side and diagonal); the Navier-Stokes operator's forest
branch composes the same pieces.
"""

from __future__ import annotations

import torch

from adaflo_tpu_torch.device import resolve_device
from adaflo_tpu_torch.fe.constraints import Constraints
from adaflo_tpu_torch.fe.forest_space import ForestSpace
from adaflo_tpu_torch.ops.lattice import IndexMapOps
from adaflo_tpu_torch.ops.tensor import VariableCellEvaluator


def evaluator_for(space, n_q_1d: int, dtype: torch.dtype = torch.float64, device=None):
    """The per-cell-geometry evaluator of a space on the index-map path: the
    VariableCellEvaluator of axis-aligned forest cells. The JAX package's
    mapped, simplex and extruded branches are not ported."""
    if (
        getattr(space, "is_simplex", False)
        or getattr(space, "is_extruded", False)
        or hasattr(space, "mapping")
    ):
        raise NotImplementedError(
            "mapped, simplex and extruded meshes are not ported (ROADMAP.md "
            "queue 1, item 15)"
        )
    return VariableCellEvaluator(
        space.dim, space.basis, n_q_1d, space.h_cells, dtype=dtype, device=device
    )


class ForestHelmholtzOperator:
    """alpha * mass + beta * stiffness on a ForestSpace, constrained.

    vmult computes y = C^T A C u with identity on constrained rows, the
    symmetric constrained operator (SPD on the free subspace) of deal.II's
    matrix-free cell loops with AffineConstraints."""

    def __init__(
        self,
        space: ForestSpace,
        constraints: Constraints,
        n_q_1d: int | None = None,
        dtype: torch.dtype = torch.float64,
        device=None,
    ) -> None:
        self.space = space
        self.con = constraints
        self.device = resolve_device(device)
        nq = n_q_1d or (space.degree + 1)
        self.ev = evaluator_for(space, nq, dtype=dtype, device=self.device)
        self.lat = IndexMapOps.for_space(space, self.device)
        self.n = space.n_dofs_padded
        self.dtype = dtype

    def cell_apply(self, uc, alpha, beta):
        ev = self.ev
        out = 0.0
        if alpha is not None:
            out = ev.integrate_values(alpha * ev.values(uc))
        if beta is not None:
            out = out + ev.integrate_gradients(beta * ev.gradients(uc))
        return out

    def vmult(self, u, alpha=1.0, beta=1.0):
        uc = self.lat.gather(self.con.resolve(u))
        r = self.con.condense(self.lat.scatter_add(self.cell_apply(uc, alpha, beta)))
        r = self.con.set_identity(r, u)
        n = self.space.n_dofs
        if self.n > n:
            r[n:] = u[n:]
        return r

    def rhs(self, f_vals):
        """Condensed right-hand side of the q-point values f_vals (E, n_q)."""
        return self.con.condense(self.lat.scatter_add(self.ev.integrate_values(f_vals)))

    def diagonal(self, alpha=1.0, beta=1.0):
        """Global diagonal (the unit-basis trick per cell), identity on
        constrained rows."""
        E, nl = self.space.n_cells, self.ev.n_local
        eye = torch.eye(nl, dtype=self.dtype, device=self.device)
        loc = self.cell_apply(eye.expand(E, nl, nl), alpha, beta)  # (E, j, i)
        d = self.lat.scatter_add(torch.diagonal(loc, dim1=-2, dim2=-1))
        cd = self.con.constrained_dofs
        if len(cd):
            d[torch.as_tensor(cd, device=self.device)] = 1.0
        n = self.space.n_dofs
        if self.n > n:
            d[n:] = 1.0
        return d
