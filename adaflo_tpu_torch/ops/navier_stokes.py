"""Matrix-free Navier-Stokes operator on the uniform lattice.

PyTorch counterpart of ``adaflo_tpu/ops/navier_stokes.py`` (the reference's
NavierStokesMatrix, source/navier_stokes_matrix.cc:601-916 `local_operation`
plus the auxiliary ops at cc:920-1140). Terms:

- BDF time derivative with density rho (none for the Stokes and the
  stationary types),
- convective term in beta-weighted skew/conservative/convective form with
  the reference's five linearizations (Newton / Picard / semi-implicit /
  explicit / projection) through the frozen `Linearized` fields, none for
  Stokes,
- damping, symmetric viscous stress 2 mu sym(grad u), grad-div stabilization,
- pressure-divergence coupling (no pressure row in the projection scheme's
  residual), and the pressure null-space projection for pressure-fix
  problems (cc:110-168, 191-217).

Layout: velocity (dim, n_dofs_u), pressure (n_dofs_p,); cell batches
(E, comp, n_local). The residual and the preconditioner's pieces evaluate
with the sum-factorized ``CellEvaluator``; the coupled Newton mat-vec
(``vmult``) and the velocity-block mat-vec (``velocity_vmult``) go through
the coupled cell apply of ``ops/coupled_matvec.py``, which launches the CUDA
kernel for CUDA tensors and runs its plain PyTorch version for CPU tensors.

Which entry of the cell apply runs follows the JAX operator's layouts
(``_pallas_coupled_apply``), chosen by the ``layout`` argument:

- "pr": K1/K2 on the nodal vectors (the default on non-periodic lattices);
- "t", "n", "pe": K3 on (E, n_cols) cell blocks behind the lattice gather
  and scatter (the default on periodic lattices); the JAX package's three
  HBM orders of the block are one cell-major block here;
- "pi": K4, the in-kernel gather, behind the lattice scatter.

Demotions, as in the JAX operator: on a periodic lattice "pr" and "pi" run
as "t"; a linearization without the nodal u* runs "pr" and "pi" as K3; a
linearization without the u* cell dofs runs K3 on the u* q-fields instead
of the dofs. Variable coefficients run K1, the one entry that takes them.

The cell apply serves the coupled implicit Newton linearization of the
time-dependent incompressible equations in 2D and 3D at velocity degree 2
or 3 without augmented elements, the configurations for which the JAX
operator builds its Pallas tables. Every other configuration (Picard,
semi-implicit, explicit, projection, the Stokes and the stationary types,
dim 1, other degrees, augmented Taylor-Hood) has no TPU kernel in the JAX
package either:
there vmult and velocity_vmult run the JAX operator's einsum branch in
plain PyTorch with the CellEvaluator (route "einsum"), chosen by the
configuration alone and counted in ``PLAIN_ROUTE_APPLIES``.

Augmented Taylor-Hood elements (FE_Q_DG0 pressure: the Q_p space plus a
constant per cell) keep the pressure vector as [Q dofs | one constant per
cell | padding]; every exact operator is cell-local in the constants, and
the Schur complement's Poisson operator couples them by an interior-penalty
graph Laplacian (ns_prec.cc:1636-1684, 2248-2342). The JAX operator builds
no Pallas tables for them, so they take the plain cell route.

On adaptive forests (ForestSpace) the operator takes the JAX operator's
forest branch (adaflo_tpu/ops/navier_stokes.py:102-128): per-cell geometry
through VariableCellEvaluator (ops/forest_ops.evaluator_for), the index-map
gather and scatter of ops/lattice.IndexMapOps, and the hanging nodes'
affine rows in resolve and condense. The JAX package builds no Pallas
tables there (its eligibility starts with `not self.is_forest`), so every
apply takes the plain cell route. Augmented Taylor-Hood on a forest is not
ported (ROADMAP.md queue 1, item 12b); graded and mapped meshes raise
NotImplementedError (item 15).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from adaflo_tpu_torch.device import resolve_device
from adaflo_tpu_torch.fe.constraints import Constraints
from adaflo_tpu_torch.fe.space import ScalarSpace
from adaflo_tpu_torch.ops.coupled_matvec import (
    ApplyScalars,
    CoupledCells,
    coupled_apply,
    coupled_apply_cells,
    coupled_apply_gather,
    coupled_apply_velocity,
)
from adaflo_tpu_torch.ops.forest_ops import evaluator_for
from adaflo_tpu_torch.ops.lattice import IndexMapOps, LatticeOps
from adaflo_tpu_torch.ops.tensor import CellEvaluator
from adaflo_tpu_torch.parameters import FlowParameters, Linearization, PhysicalType
from adaflo_tpu_torch.utils.timer import profiler_range


class TimeWeights(NamedTuple):
    """Per-step scalars entering the operators (host floats)."""

    weight: float  # BDF weight of the new value
    weight_old: float
    weight_old_old: float
    tau1: float  # implicit weight of the spatial terms

    @classmethod
    def from_time_stepping(cls, ts) -> "TimeWeights":
        assert ts.tau2() == 0.0, "schemes with tau2 != 0 not supported in NS"
        return cls(
            float(ts.weight()),
            float(ts.weight_old()),
            float(ts.weight_old_old()),
            float(ts.tau1()),
        )


class Linearized(NamedTuple):
    """Frozen linearization state (the reference's `linearized_velocities`,
    navier_stokes_matrix.h:264-283)."""

    val: torch.Tensor  # (E, dim, n_q) linearization velocity u*
    grad: Optional[torch.Tensor]  # (E, dim, dim, n_q) full gradient (Newton)
    div: torch.Tensor  # (E, n_q) divergence of u*
    # nodal linearization point (dim, n_u), read by K1/K2 and K4
    u: Optional[torch.Tensor] = None
    # cell-local dofs of u* (E, dim, n_loc), K3's dof stream
    dofs: Optional[torch.Tensor] = None


class Coefficients(NamedTuple):
    """Optional variable coefficients at quadrature points (two-phase)."""

    rho: Optional[torch.Tensor] = None  # (E, n_q)
    mu: Optional[torch.Tensor] = None  # (E, n_q)
    damping: Optional[torch.Tensor] = None  # (E, n_q)


def _trace(g):
    """Trace over the (comp, deriv) axes of (..., comp, deriv, n_q)."""
    return torch.diagonal(g, dim1=-3, dim2=-2).sum(-1)


def _dot_dq(a, g):
    """sum_d a[..., d, q] g[..., c, d, q] -> (..., c, q)."""
    return torch.einsum("...dq,...cdq->...cq", a, g)


# the JAX operator's layouts of the fused apply (ADAFLO_PALLAS_LAYOUT)
LAYOUTS = ("pr", "t", "n", "pe", "pi")

# applies of the plain cell route ("einsum"), beside the kernel launch
# counts of ops/coupled_matvec.launches; plain integers that a caller may
# reset (chip_smoke.py reads them around a run)
PLAIN_ROUTE_APPLIES = {"vmult": 0, "velocity_vmult": 0}

# the linearizations whose residual linearizes around the extrapolated old
# velocity (navier_stokes_matrix.cc:740-781)
_EXTRAPOLATED = (
    Linearization.projection,
    Linearization.coupled_velocity_semi_implicit,
    Linearization.coupled_velocity_explicit,
)


class NavierStokesOperator:
    def __init__(
        self,
        parameters: FlowParameters,
        u_space: ScalarSpace,
        p_space: ScalarSpace,
        constraints_u: list[Constraints],
        constraints_p: Constraints,
        dtype: torch.dtype = torch.float64,
        device=None,
        layout: Optional[str] = None,
    ) -> None:
        """layout: which entry of the coupled cell apply vmult and
        velocity_vmult run (LAYOUTS, see the module docstring); None takes
        the JAX operator's default, "pr" where K1 runs ("t" on periodic
        lattices)."""
        self.parameters = parameters
        self.dim = u_space.dim
        self.u_space = u_space
        self.p_space = p_space
        self.constraints_u = constraints_u
        self.constraints_p = constraints_p
        self.dtype = dtype
        self.device = resolve_device(device)
        mesh = u_space.mesh
        if getattr(u_space, "is_mapped", False):
            raise NotImplementedError(
                "mapped meshes are not ported (ROADMAP.md queue 1, item 15)"
            )
        if getattr(mesh, "is_graded", False):
            raise NotImplementedError(
                "graded lattices are not ported (ROADMAP.md queue 1, item 15)"
            )
        # the general index-map path of adaptive forests: per-cell geometry,
        # cells leading in every cell array
        if u_space.is_forest and parameters.augmented_taylor_hood:
            raise NotImplementedError(
                "augmented Taylor-Hood on adaptive forests is not ported "
                "(ROADMAP.md queue 1, item 12b)"
            )
        deg_p = p_space.degree
        # quadrature with p+2 points (FEEvaluation<dim, degree_p+1, degree_p+2>)
        kw = dict(dtype=dtype, device=self.device)
        if u_space.is_forest:
            self.ev_u = evaluator_for(u_space, deg_p + 2, **kw)
            self.ev_p = evaluator_for(p_space, deg_p + 2, **kw)
            self.ev_p_low = evaluator_for(p_space, deg_p + 1, **kw)
            self.lat_u = IndexMapOps.for_space(u_space, self.device)
            self.lat_p = IndexMapOps.for_space(p_space, self.device)
        else:
            self.ev_u = CellEvaluator(self.dim, u_space.basis, deg_p + 2, mesh.h, **kw)
            self.ev_p = CellEvaluator(self.dim, p_space.basis, deg_p + 2, mesh.h, **kw)
            # reduced quadrature (p+1 points) for pressure-only operators
            self.ev_p_low = CellEvaluator(
                self.dim, p_space.basis, deg_p + 1, mesh.h, **kw
            )
            self.lat_u = LatticeOps.for_space(u_space)
            self.lat_p = LatticeOps.for_space(p_space)
        self.n_q = self.ev_u.n_q
        # augmented Taylor-Hood: [Q dofs | cell constants | padding]
        self.augmented = parameters.augmented_taylor_hood
        self.n_p_q = p_space.n_dofs
        self.n_p_total = p_space.n_dofs + (mesh.n_cells if self.augmented else 0)
        self.n_p_padded = self.n_p_total + p_space.n_dofs_padded - p_space.n_dofs
        self.pressure_fix_mode = None  # set by enable_pressure_fix()
        self.pressure_dg0_mode = None  # the cell constants' mode (augmented)
        self._dg0_diag = None

        # the coupled cell apply reads nodal vectors through cell tables and
        # treats constrained dofs as masks: Dirichlet rows only (the lattice
        # has no hanging nodes)
        for c in list(constraints_u) + [constraints_p]:
            if len(c.slave) and not u_space.is_forest:
                raise NotImplementedError(
                    "affine constraints on the lattice are not ported"
                )
        self.cells = None
        if self.kernel_configuration():
            mask_u = np.zeros((self.dim, u_space.n_dofs_padded), bool)
            for c, con in enumerate(constraints_u):
                mask_u[c, con.constrained_dofs] = True
            mask_p = np.zeros(p_space.n_dofs_padded, bool)
            mask_p[constraints_p.constrained_dofs] = True
            self.cells = CoupledCells(
                self.ev_u,
                self.ev_p,
                self._cell_table(self.lat_u, u_space),
                self._cell_table(self.lat_p, p_space),
                mask_u if mask_u.any() else None,
                mask_p if mask_p.any() else None,
                self.device,
                lattice=(tuple(mesh.n_cells_axis), tuple(mesh.periodic)),
            )
        # the JAX operator's _layout_default: "pr" where the resident apply
        # runs, which excludes periodic lattices
        if layout is None:
            layout = "pr" if self.cells is not None and not any(mesh.periodic) else "t"
        if layout not in LAYOUTS:
            raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
        self.layout = layout

    def kernel_configuration(self) -> bool:
        """True where the coupled cell apply serves vmult and velocity_vmult:
        the coupled implicit Newton linearization of the time-dependent
        incompressible equations in 2D or 3D at velocity degree 2 or 3,
        without augmented Taylor-Hood elements, on a lattice (the JAX
        operator's Pallas eligibility, adaflo_tpu/ops/navier_stokes.py:197-206,
        without its TPU size and dtype gate: adaptive forests never).
        Read at every apply: the initial Stokes solve switches the physical
        type for its duration."""
        par = self.parameters
        return (
            not self.u_space.is_forest
            and par.linearization == Linearization.coupled_implicit_newton
            and par.physical_type == PhysicalType.incompressible
            and self.dim in (2, 3)
            and par.velocity_degree in (2, 3)
            and not par.augmented_taylor_hood
        )

    @staticmethod
    def _cell_table(lat: LatticeOps, space) -> np.ndarray:
        table = lat.cell_dof_table()
        assert np.array_equal(table, space.cell_dofs)
        return table

    # ------------------------------------------------------------------
    # gather / scatter helpers
    def _gather_u(self, u, resolve: bool):
        """(dim, n_u) -> (E, dim, n_loc_u)"""
        if resolve:
            u = [c.resolve(u[i]) for i, c in enumerate(self.constraints_u)]
        return torch.stack([self.lat_u.gather(u[c]) for c in range(self.dim)], dim=1)

    def _gather_p(self, p, resolve: bool):
        if resolve:
            p = self.constraints_p.resolve(p)
        return self.lat_p.gather(p)

    def _scatter_u(self, r_cells):
        """(E, dim, n_loc_u) -> (dim, n_u), with condense."""
        return torch.stack(
            [
                self.constraints_u[c].condense(self.lat_u.scatter_add(r_cells[:, c, :]))
                for c in range(self.dim)
            ]
        )

    def _scatter_p(self, r_cells):
        return self.constraints_p.condense(self.lat_p.scatter_add(r_cells))

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    # the cell constants of augmented Taylor-Hood
    def _split_p(self, p):
        """(n_p_padded,) -> (Q part (n_q_padded,), cell constants (E,) or
        None without augmented elements)."""
        if not self.augmented:
            return p, None
        E = self.u_space.mesh.n_cells
        pq = torch.cat(
            [p[: self.n_p_q], p.new_zeros(self.p_space.n_dofs_padded - self.n_p_q)]
        )
        return pq, p[self.n_p_q : self.n_p_q + E]

    def _join_p(self, rq, rc):
        """The inverse of _split_p (the padding at the tail)."""
        if not self.augmented:
            return rq
        return torch.cat([rq[: self.n_p_q], rc, rq[self.n_p_q :]])

    def _cell_volumes(self):
        """(E,) cell volumes of the uniform lattice."""
        mesh = self.u_space.mesh
        return torch.full(
            (mesh.n_cells,), float(np.prod(mesh.h)), dtype=self.dtype, device=self.device
        )

    @staticmethod
    def _dg0_integrate(ev, val):
        """(E,) cell integrals of an (E, n_q) q-point field: the rows of the
        cell constants."""
        return val @ ev.jxw

    def pressure_values_q(self, p, ev, resolve: bool):
        """The pressure at the q points of `ev`, the cell constant added."""
        pq, pc = self._split_p(p)
        vals = ev.values(self._gather_p(pq, resolve))
        return vals if pc is None else vals + pc[:, None]

    def _integrate_pressure_row(self, f_q):
        """A q-point field integrated against the pressure test space (the Q
        part and, augmented, the cell constants)."""
        rq = self._scatter_p(self.ev_p.integrate_values(f_q))
        if not self.augmented:
            return rq
        return self._join_p(rq, self._dg0_integrate(self.ev_p, f_q))

    def _dg0_graph_laplacian(self, pc):
        """sum over interior faces of penalty |F| (p_K - p_K'), the penalty
        deg (deg + 1) / h of the reference's interior penalty, by banded
        differences on the uniform lattice."""
        mesh = self.u_space.mesh
        dim, deg = self.dim, self.p_space.degree
        vol = float(np.prod(mesh.h))
        P = pc.reshape(tuple(reversed(mesh.n_cells_axis)))
        out = torch.zeros_like(P)
        for a in range(dim):
            ax = dim - 1 - a
            coeff = (deg * (deg + 1) / mesh.h[a]) * (vol / mesh.h[a])
            d = torch.diff(P, dim=ax)  # p_(i+1) - p_i
            lo = [0, 0] * dim
            hi = [0, 0] * dim
            # F.pad lists the last axis first: (last lo, last hi, ...)
            lo[2 * (dim - 1 - ax) + 1] = 1
            hi[2 * (dim - 1 - ax)] = 1
            out = out + coeff * (
                torch.nn.functional.pad(-d, lo) + torch.nn.functional.pad(d, hi)
            )
        return out.reshape(-1)

    def dg0_diagonal(self):
        """Diagonal of the cell constants' interior-penalty graph Laplacian
        (built once)."""
        if self._dg0_diag is None:
            self._dg0_diag = self._dg0_diagonal()
        return self._dg0_diag

    def _dg0_diagonal(self):
        mesh = self.u_space.mesh
        deg = self.p_space.degree
        vol = float(np.prod(mesh.h))
        diag = np.zeros(tuple(reversed(mesh.n_cells_axis)))
        for a in range(self.dim):
            ax = self.dim - 1 - a
            coeff = (deg * (deg + 1) / mesh.h[a]) * (vol / mesh.h[a])
            n_faces = np.full(mesh.n_cells_axis[a], 2)
            n_faces[0] = n_faces[-1] = 1
            shape = [1] * self.dim
            shape[ax] = -1
            diag = diag + coeff * n_faces.reshape(shape)
        return torch.as_tensor(diag.reshape(-1), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    def enable_pressure_fix(self) -> None:
        """Project the constant pressure mode(s) out of residual and vmult
        (navier_stokes_matrix.cc:110-168): mode 0 spans the Q part, mode 1
        (augmented) the cell constants; the weights are the lumped pressure
        mass restricted to each mode."""
        E = self.u_space.mesh.n_cells
        ones = torch.ones((E, self.ev_p_low.n_q), dtype=self.dtype, device=self.device)
        lumped = self.lat_p.scatter_add(self.ev_p_low.integrate_values(ones))
        n = self.p_space.n_dofs
        mode = self._zeros(self.p_space.n_dofs_padded)
        mode[:n] = 1.0
        cd = self.constraints_p.constrained_dofs
        if len(cd):
            idx = torch.as_tensor(cd, device=self.device)
            mode[idx] = 0.0
            lumped[idx] = 0.0
        weights = lumped * mode
        if self.augmented:
            zc = self._zeros(E)
            mode, weights = self._join_p(mode, zc), self._join_p(weights, zc)
            m1 = self._join_p(torch.zeros_like(lumped), torch.ones_like(zc))
            w1 = self._join_p(torch.zeros_like(lumped), self._cell_volumes())
            self.pressure_dg0_mode = (m1, w1, 1.0 / float(m1 @ w1))
        self.pressure_fix_mode = (mode, weights, 1.0 / float(mode @ weights))

    def apply_pressure_average_projection(self, rp):
        """(navier_stokes_matrix.cc:191-205)"""
        if self.pressure_fix_mode is None:
            return rp
        par = self.parameters
        if (
            par.linearization == Linearization.projection
            or par.physical_type == PhysicalType.incompressible_stationary
        ):
            return rp
        mode, weights, inv = self.pressure_fix_mode
        rp = rp - (weights @ rp) * inv * mode
        if self.pressure_dg0_mode is not None:
            m1, w1, i1 = self.pressure_dg0_mode
            rp = rp - (w1 @ rp) * i1 * m1
        return rp

    def apply_pressure_shift(self, shift: float, p):
        if self.pressure_fix_mode is None:
            return p
        return p + shift * self.pressure_fix_mode[0]

    # ------------------------------------------------------------------
    # the local q-point terms (reference local_operation, nsm.cc:601-916)
    def _q_point_terms(
        self,
        op: str,
        tw: TimeWeights,
        val_u,  # (..., E, dim, n_q)
        grad_u,  # (..., E, dim, dim, n_q): [., comp, deriv, q]
        p_q,  # (E, n_q) or None
        old_val,
        old_old_val,
        lin: Optional[Linearized],
        coeffs: Coefficients,
    ):
        par = self.parameters
        dim = self.dim
        beta = par.beta_convective_term_momentum_balance
        div = _trace(grad_u)

        submit_val = None
        new_lin = None
        if par.physical_type != PhysicalType.stokes:
            rho = coeffs.rho if coeffs.rho is not None else par.density
            if par.physical_type == PhysicalType.incompressible:
                conv = val_u * tw.weight
            else:  # stationary: no time derivative
                conv = torch.zeros_like(val_u)
            if op == "residual":
                if par.physical_type != PhysicalType.incompressible_stationary:
                    conv = conv + old_val * tw.weight_old + old_old_val * tw.weight_old_old
                if par.linearization in _EXTRAPOLATED:
                    # lin holds the extrapolated old velocity here
                    if par.linearization == Linearization.coupled_velocity_explicit:
                        res = beta * lin.div[..., None, :] * lin.val + _dot_dq(
                            lin.val, lin.grad
                        )
                        new_lin = lin
                    else:
                        res = beta * lin.div[..., None, :] * val_u + _dot_dq(
                            lin.val, grad_u
                        )
                        new_lin = Linearized(lin.val, None, lin.div)
                    conv = conv + tw.tau1 * res
                else:
                    # Newton / Picard: linearize around the current iterate
                    res = beta * div[..., None, :] * val_u + _dot_dq(val_u, grad_u)
                    conv = conv + tw.tau1 * res
                    if par.linearization == Linearization.coupled_implicit_newton:
                        new_lin = Linearized(val_u, grad_u, div)
                    else:
                        new_lin = Linearized(val_u, None, div)
            else:  # vmult / vmult_velocity
                if par.linearization == Linearization.coupled_implicit_newton:
                    res = (
                        beta * div[..., None, :] * lin.val
                        + beta * _trace(lin.grad)[..., None, :] * val_u
                        + _dot_dq(lin.val, grad_u)
                        + _dot_dq(val_u, lin.grad)
                    )
                    conv = conv + tw.tau1 * res
                elif par.linearization != Linearization.coupled_velocity_explicit:
                    res = beta * lin.div[..., None, :] * val_u + _dot_dq(
                        lin.val, grad_u
                    )
                    conv = conv + tw.tau1 * res
            conv = conv * (rho if np.isscalar(rho) else rho[:, None, :])
            damping = coeffs.damping if coeffs.damping is not None else par.damping
            conv = conv - (
                damping if np.isscalar(damping) else damping[:, None, :]
            ) * val_u
            submit_val = conv

        # viscous + grad-div + pressure (all ops)
        mu = coeffs.mu if coeffs.mu is not None else par.viscosity
        tmu = (mu if np.isscalar(mu) else mu[:, None, None, :]) * tw.tau1
        stress = tmu * (grad_u + grad_u.transpose(-3, -2))
        eye = torch.eye(dim, dtype=grad_u.dtype, device=grad_u.device)[:, :, None]
        stress = stress + par.tau_grad_div * div[..., None, None, :] * eye
        if op != "vmult_velocity":
            stress = stress - p_q[..., None, None, :] * eye
        return submit_val, stress, div, new_lin

    # ------------------------------------------------------------------
    @profiler_range
    def residual_assemble(
        self,
        u,
        p,
        u_old,
        u_old_old,
        tw: TimeWeights,
        coeffs: Coefficients = Coefficients(),
        extrapolation: tuple = (1.0, 0.0),
    ):
        """Assemble the positive operator terms A(u) at the current state
        (plain reads honoring inhomogeneous BCs) and freeze the linearization.
        Returns (r_u, r_p, Linearized). The caller forms
        rhs = user_rhs + const_rhs - A(u) (navier_stokes_matrix.cc:266-293).
        `extrapolation`: the factors (f1, f2) of the old velocities that the
        semi-implicit, explicit and projection schemes linearize around."""
        par = self.parameters
        uc = self._gather_u(u, resolve=False)
        val_u = self.ev_u.values(uc)
        grad_u = self.ev_u.gradients(uc)
        p_q = self.pressure_values_q(p, self.ev_p, resolve=False)
        old_val = old_old_val = None
        lin = None
        if par.physical_type == PhysicalType.incompressible:
            oc = self._gather_u(u_old, resolve=False)
            ooc = self._gather_u(u_old_old, resolve=False)
            old_val = self.ev_u.values(oc)
            old_old_val = self.ev_u.values(ooc)
            if par.linearization in _EXTRAPOLATED:
                # extrapolate the old velocities to the new time
                # (navier_stokes_matrix.cc:740-781)
                f1, f2 = extrapolation
                ex_grad = f1 * self.ev_u.gradients(oc) + f2 * self.ev_u.gradients(ooc)
                lin = Linearized(
                    f1 * old_val + f2 * old_old_val, ex_grad, _trace(ex_grad)
                )
        submit_val, stress, div, new_lin = self._q_point_terms(
            "residual", tw, val_u, grad_u, p_q, old_val, old_old_val, lin, coeffs
        )
        if new_lin is not None and par.linearization in (
            Linearization.coupled_implicit_newton,
            Linearization.coupled_implicit_picard,
        ):
            # the coupled cell apply reads the linearization point nodally
            # (K1, K4) or as cell dofs (K3's stream, gathered here once per
            # Newton step)
            new_lin = new_lin._replace(u=u, dofs=uc)
        r_u = self.ev_u.integrate_gradients(stress)
        if submit_val is not None:
            r_u = r_u + self.ev_u.integrate_values(submit_val)
        ru = self._scatter_u(r_u)
        if par.linearization == Linearization.projection:
            # the fractional-step scheme assembles no pressure block
            # (navier_stokes_matrix.cc:902-907)
            rp = self._zeros(self.n_p_padded)
        else:
            rp = self._integrate_pressure_row(-div)
        return ru, rp, new_lin

    def _apply_scalars(self, tw: TimeWeights) -> ApplyScalars:
        par = self.parameters
        return ApplyScalars(
            par.beta_convective_term_momentum_balance,
            tw.weight,
            tw.tau1,
            par.density,
            par.viscosity,
            par.damping,
            par.tau_grad_div,
        )

    def _cell_coeffs(self, coeffs: Coefficients):
        if coeffs.rho is None and coeffs.mu is None and coeffs.damping is None:
            return None
        return tuple(
            None if c is None else c.to(self.dtype).contiguous()
            for c in (coeffs.rho, coeffs.mu, coeffs.damping)
        )

    def route(self, lin: Optional[Linearized], coeffs: Coefficients = Coefficients()) -> str:
        """The route that vmult and velocity_vmult run for this
        linearization: an entry of the coupled cell apply, "nodal" (K1/K2),
        "gather" (K4), "cells" (K3, u* dof stream) or "qfields" (K3, u*
        q-field stream), where the configuration has the kernel
        (kernel_configuration), else "einsum", the plain cell route. The
        layout is demoted as the JAX operator's _pallas_coupled_apply
        demotes it."""
        if not self.kernel_configuration():
            return "einsum"
        if self.cells is None:
            raise RuntimeError(
                "the operator was built for a configuration without the "
                "coupled cell apply; build it anew for this one"
            )
        if lin is None or lin.grad is None:
            raise ValueError(
                "the coupled Newton apply needs the Newton linearization "
                "that residual_assemble freezes"
            )
        if self._cell_coeffs(coeffs) is not None:
            if lin.u is None:
                raise ValueError(
                    "variable coefficients need the nodal linearization point "
                    "of K1, which the coupled Newton residual sets"
                )
            return "nodal"
        layout = self.layout
        if layout in ("pr", "pi") and any(self.u_space.mesh.periodic):
            layout = "t"
        if layout in ("pr", "pi") and lin.u is None:
            layout = "pe"
        if layout == "pr":
            return "nodal"
        if layout == "pi":
            return "gather"
        return "cells" if lin.dofs is not None else "qfields"

    @staticmethod
    def qfields(lin: Linearized):
        """K3's q-field stream: (E, dim (dim+1), n_q) with [value, d/dx_0,
        ..] of each u* component at the q points (physical gradients), the
        JAX package's qfields_t without its TPU row padding."""
        E, dim, n_q = lin.val.shape
        fields = torch.cat([lin.val[:, :, None, :], lin.grad], dim=2)
        return fields.reshape(E, dim * (dim + 1), n_q).contiguous()

    def cell_apply(
        self,
        du,
        dp,
        tw: TimeWeights,
        lin: Linearized,
        route: str,
        coeffs: Coefficients = Coefficients(),
    ):
        """The coupled cell apply of vmult (dp given) or velocity_vmult
        (dp None) through one entry (`route`, as route() names them), with
        identity rows on the constrained dofs (+du, -dp) and without the
        pressure-average projection. Returns (r_u, r_p or None)."""
        if route == "einsum":
            return self._einsum_apply(du, dp, tw, lin, coeffs)
        sc = self._apply_scalars(tw)
        cco = self._cell_coeffs(coeffs)
        if cco is not None and route != "nodal":
            raise ValueError("only the nodal entry (K1) takes variable coefficients")
        du = du.contiguous()
        dp = None if dp is None else dp.contiguous()
        if route == "nodal":
            if dp is None:
                ru = coupled_apply_velocity(
                    du, lin.u.contiguous(), self.cells, sc, coeffs=cco
                )
                return ru, None
            return coupled_apply(
                du, dp, lin.u.contiguous(), self.cells, sc, coeffs=cco,
                identity=True,
            )
        if route == "gather":
            out = coupled_apply_gather(du, dp, lin.u.contiguous(), self.cells, sc)
        elif route in ("cells", "qfields"):
            cols = [
                self.lat_u.gather(self.constraints_u[c].resolve(du[c]))
                for c in range(self.dim)
            ]
            if dp is not None:
                cols.append(self.lat_p.gather(self.constraints_p.resolve(dp)))
            x = torch.cat(cols, dim=1)
            if route == "cells":
                s = lin.dofs.reshape(lin.dofs.shape[0], -1).contiguous()
            else:
                s = self.qfields(lin)
            out = coupled_apply_cells(
                x, s, self.cells, sc, velocity_only=dp is None
            )
        else:
            raise ValueError(f"unknown route {route!r}")
        # scatter, condense, and the identity rows of vmult (cc:247-256)
        nl = self.u_space.n_local
        ru = torch.stack(
            [
                self.constraints_u[c].set_identity(
                    self.constraints_u[c].condense(
                        self.lat_u.scatter_add(out[:, c * nl : (c + 1) * nl])
                    ),
                    du[c],
                )
                for c in range(self.dim)
            ]
        )
        if dp is None:
            return ru, None
        rp = self.constraints_p.condense(self.lat_p.scatter_add(out[:, self.dim * nl :]))
        cp = self.constraints_p.constrained_dofs
        if len(cp):
            idx = torch.as_tensor(cp, device=rp.device)
            rp[idx] = -dp[idx]
        return ru, rp

    def _einsum_apply(self, du, dp, tw: TimeWeights, lin, coeffs: Coefficients):
        """The plain cell route: the JAX operator's einsum branch of vmult
        (dp given, adaflo_tpu/ops/navier_stokes.py:635-646) or
        velocity_vmult (dp None, :1151-1154) with the CellEvaluator, and the
        identity rows
        (+du, -dp) on the constrained dofs."""
        uc = self._gather_u(du, resolve=True)
        if dp is None:
            PLAIN_ROUTE_APPLIES["velocity_vmult"] += 1
            ru = self._scatter_u(self.local_velocity_apply(uc, tw, lin, coeffs))
            rp = None
        else:
            PLAIN_ROUTE_APPLIES["vmult"] += 1
            val_u = self.ev_u.values(uc)
            grad_u = self.ev_u.gradients(uc)
            p_q = self.pressure_values_q(dp, self.ev_p, resolve=True)
            submit_val, stress, div, _ = self._q_point_terms(
                "vmult", tw, val_u, grad_u, p_q, None, None, lin, coeffs
            )
            r_u = self.ev_u.integrate_gradients(stress)
            if submit_val is not None:
                r_u = r_u + self.ev_u.integrate_values(submit_val)
            ru = self._scatter_u(r_u)
            rp = self._integrate_pressure_row(-div)
            cp = self.constraints_p.constrained_dofs
            if len(cp):
                idx = torch.as_tensor(cp, device=rp.device)
                rp[idx] = -dp[idx]
        ru = torch.stack(
            [self.constraints_u[c].set_identity(ru[c], du[c]) for c in range(self.dim)]
        )
        return ru, rp

    @profiler_range
    def vmult(
        self,
        du,
        dp,
        tw: TimeWeights,
        lin: Linearized,
        coeffs: Coefficients = Coefficients(),
    ):
        """Coupled-system mat-vec (navier_stokes_matrix.cc:221-262) with
        identity on constrained rows (pressure with sign -1, cc:247-256)."""
        ru, rp = self.cell_apply(du, dp, tw, lin, self.route(lin, coeffs), coeffs)
        return ru, self.apply_pressure_average_projection(rp)

    def local_velocity_apply(
        self,
        uc,  # (..., E, dim, n_loc_u) cell-local velocity dofs
        tw: TimeWeights,
        lin: Optional[Linearized],
        coeffs: Coefficients = Coefficients(),
    ):
        """Cell-local velocity-block application (no gather/scatter); used to
        extract the matrix diagonal for Jacobi/Chebyshev smoothing."""
        val_u = self.ev_u.values(uc)
        grad_u = self.ev_u.gradients(uc)
        submit_val, stress, _, _ = self._q_point_terms(
            "vmult_velocity", tw, val_u, grad_u, None, None, None, lin, coeffs
        )
        r_u = self.ev_u.integrate_gradients(stress)
        if submit_val is not None:
            r_u = r_u + self.ev_u.integrate_values(submit_val)
        return r_u

    @profiler_range
    def velocity_vmult(
        self,
        du,
        tw: TimeWeights,
        lin: Linearized,
        coeffs: Coefficients = Coefficients(),
    ):
        """(0,0)-block mat-vec (navier_stokes_matrix.cc:337-382)."""
        route = self.route(lin, coeffs)
        return self.cell_apply(du, None, tw, lin, route, coeffs)[0]

    def velocity_block_diagonal(
        self,
        tw: TimeWeights,
        lin: Optional[Linearized],
        coeffs: Coefficients = Coefficients(),
        batch: int = 9,
    ):
        """Exact matrix diagonal of the velocity block, assembled matrix-free
        by applying the cell-local kernel to unit local vectors, `batch`
        units at a time. Returns (dim, n_dofs_u) with 1.0 on constrained
        rows."""
        E = self.u_space.mesh.n_cells
        dim, n_loc = self.dim, self.u_space.n_local
        n_units = dim * n_loc
        units = torch.eye(n_units, dtype=self.dtype, device=self.device)
        units = units.reshape(n_units, dim, n_loc)
        diag_loc = self._zeros(E, dim, n_loc)
        # cells lead and the units follow them, (cell, unit, comp, local), as
        # the per-cell evaluators of a forest need; the per-cell fields gain
        # the unit axis
        def per_cell(f):
            return None if f is None else f[:, None]

        if lin is not None:
            lin = Linearized(per_cell(lin.val), per_cell(lin.grad), per_cell(lin.div))
        coeffs = Coefficients(*(per_cell(f) for f in coeffs))
        for b0 in range(0, n_units, batch):
            b1 = min(b0 + batch, n_units)
            uc = units[b0:b1].expand(E, b1 - b0, dim, n_loc)
            out = self.local_velocity_apply(uc, tw, lin, coeffs)
            for k in range(b0, b1):
                c, i = divmod(k, n_loc)
                diag_loc[:, c, i] = out[:, k - b0, c, i]
        rows = []
        for c in range(dim):
            d = self.lat_u.scatter_add(diag_loc[:, c, :])
            cd = self.constraints_u[c].constrained_dofs
            if len(cd):
                d[torch.as_tensor(cd, device=self.device)] = 1.0
            rows.append(d)
        return torch.stack(rows)

    # ------------------------------------------------------------------
    def divergence_vmult_add(
        self, dst_p, u, weight_by_viscosity=False,
        coeffs: Coefficients = Coefficients(), plain=False,
    ):
        """dst_p += -(q, w * div u) (navier_stokes_matrix.cc:920-961)."""
        par = self.parameters
        uc = self._gather_u(u, resolve=not plain)
        div = _trace(self.ev_u.gradients(uc))
        if weight_by_viscosity:
            mu = coeffs.mu if coeffs.mu is not None else par.viscosity
            w = -mu
        else:
            w = -1.0
        return dst_p + self._integrate_pressure_row(w * div)

    def pressure_poisson_vmult(
        self,
        p,
        inv_rho_weight,
        coeffs: Coefficients = Coefficients(),
        constraints: Optional[Constraints] = None,
    ):
        """(grad q, 1/(rho*weight) grad p) (navier_stokes_matrix.cc:965-1032).
        With variable density the per-q 1/rho enters (then inv_rho_weight is
        the 1/weight factor). `constraints` selects the Schur-complement
        constraint set inside the preconditioner (ns_prec.cc:386-415)."""
        con = constraints if constraints is not None else self.constraints_p
        ev = self.ev_p_low if coeffs.rho is None else self.ev_p
        pq, pc = self._split_p(p)
        grad_p = ev.gradients(self.lat_p.gather(con.resolve(pq)))
        if coeffs.rho is not None:
            grad_p = grad_p * (inv_rho_weight / coeffs.rho)[:, None, :]
        else:
            grad_p = grad_p * inv_rho_weight
        rp = con.condense(self.lat_p.scatter_add(ev.integrate_gradients(grad_p)))
        if pc is not None:
            # the interior-penalty graph Laplacian between the cell constants
            # (ns_prec.cc:1649-1683; no Q-constant coupling: this operator
            # only preconditions the Schur complement)
            rp = self._join_p(rp, self._dg0_graph_laplacian(pc) * inv_rho_weight)
        return con.set_identity(rp, p)

    def pressure_mass_vmult(
        self, p, coefficient, coeffs: Coefficients = Coefficients(),
        constraints: Optional[Constraints] = None,
    ):
        """(q, c p) with c = 1/(mu + tau_gd) or 1 (cc:1036-1071); `coefficient`
        is a scalar or a per-cell (E,) tensor."""
        con = constraints if constraints is not None else self.constraints_p
        ev = self.ev_p_low
        pq, pc = self._split_p(p)
        val = ev.values(self.lat_p.gather(con.resolve(pq)))
        if pc is not None:
            val = val + pc[:, None]
        if torch.is_tensor(coefficient) and coefficient.ndim == 1:
            val = val * coefficient[:, None]
        else:
            val = val * coefficient
        rp = con.condense(self.lat_p.scatter_add(ev.integrate_values(val)))
        if pc is not None:
            rp = self._join_p(rp, self._dg0_integrate(ev, val))
        rp = con.set_identity(rp, p)
        # the cell constants' mode projected out (cc:449-454)
        if (
            self.pressure_dg0_mode is not None
            and self.parameters.linearization != Linearization.projection
        ):
            m1, w1, i1 = self.pressure_dg0_mode
            rp = rp - (w1 @ rp) * i1 * m1
        return rp

    def pressure_convdiff_vmult(
        self, p, coeffs: Coefficients = Coefficients(),
        constraints: Optional[Constraints] = None,
    ):
        """mu-weighted pressure Laplacian of the Kay-Loghin-Wathen
        stationary Schur complement (navier_stokes_matrix.cc:1099-1140; the
        convective part is off in the reference as well)."""
        con = constraints if constraints is not None else self.constraints_p
        ev = self.ev_p
        grad_p = ev.gradients(self.lat_p.gather(con.resolve(p)))
        mu = coeffs.mu if coeffs.mu is not None else self.parameters.viscosity
        grad_p = grad_p * (mu if np.isscalar(mu) else mu[:, None, :])
        rp = con.condense(self.lat_p.scatter_add(ev.integrate_gradients(grad_p)))
        return con.set_identity(rp, p)

    def pressure_poisson_diagonal(
        self, inv_rho_weight, constraints=None, coeffs: Coefficients = Coefficients()
    ):
        """Exact diagonal of the pressure Poisson operator (unit-vector
        trick), for Jacobi/Chebyshev smoothing."""
        con = constraints if constraints is not None else self.constraints_p
        ev = self.ev_p_low if coeffs.rho is None else self.ev_p
        E = self.u_space.mesh.n_cells
        n_loc = self.p_space.n_local
        units = torch.eye(n_loc, dtype=self.dtype, device=self.device)
        g = ev.gradients(units.expand(E, n_loc, n_loc))  # (cell, unit, local)
        if coeffs.rho is not None:
            g = g * (inv_rho_weight / coeffs.rho)[:, None, None, :]
        else:
            g = g * inv_rho_weight
        diag_loc = torch.diagonal(ev.integrate_gradients(g), dim1=1, dim2=2)
        d = self.lat_p.scatter_add(diag_loc)
        if self.augmented:
            d = self._join_p(d, self.dg0_diagonal() * inv_rho_weight)
        if len(con.constrained_dofs):
            d[torch.as_tensor(con.constrained_dofs, device=self.device)] = 1.0
        return d

    def pressure_lumped_mass(self, coefficient=None):
        """Lumped pressure mass diagonal (for the diagonal preconditioner of
        the mass solves, diagonal_preconditioner.cc), with the cell volumes
        of the augmented constants; `coefficient`: optional per-cell (E,)
        weight."""
        E = self.u_space.mesh.n_cells
        ones = torch.ones((E, self.ev_p_low.n_q), dtype=self.dtype, device=self.device)
        if coefficient is not None:
            ones = ones * (
                coefficient[:, None]
                if torch.is_tensor(coefficient) and coefficient.ndim == 1
                else coefficient
            )
        lumped = self.lat_p.scatter_add(self.ev_p_low.integrate_values(ones))
        if not self.augmented:
            return lumped
        cvol = self._cell_volumes()
        if coefficient is not None:
            cvol = cvol * coefficient
        return self._join_p(lumped, cvol)
