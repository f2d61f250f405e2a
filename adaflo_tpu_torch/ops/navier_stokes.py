"""Matrix-free Navier-Stokes operator on the uniform lattice.

PyTorch counterpart of ``adaflo_tpu/ops/navier_stokes.py`` (the reference's
NavierStokesMatrix, source/navier_stokes_matrix.cc:601-916 `local_operation`
plus the auxiliary ops at cc:920-1140). Terms:

- BDF time derivative with density rho,
- convective term in beta-weighted skew/conservative/convective form,
  linearized by Newton around the frozen iterate,
- damping, symmetric viscous stress 2 mu sym(grad u), grad-div stabilization,
- pressure-divergence coupling, and the pressure null-space projection for
  pressure-fix problems (cc:110-168, 191-217).

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

Only the lattice branch of the JAX operator is ported: adaptive forests,
graded and mapped meshes and augmented Taylor-Hood raise NotImplementedError
(ROADMAP.md queue 1, items 11, 12 and 15).
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
from adaflo_tpu_torch.ops.lattice import LatticeOps
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
        if getattr(u_space, "is_forest", False) or getattr(u_space, "is_mapped", False):
            raise NotImplementedError(
                "forest and mapped meshes are not ported (ROADMAP.md queue 1, "
                "items 12 and 15)"
            )
        if getattr(mesh, "is_graded", False):
            raise NotImplementedError(
                "graded lattices are not ported (ROADMAP.md queue 1, item 15)"
            )
        if parameters.augmented_taylor_hood:
            raise NotImplementedError(
                "augmented Taylor-Hood is not ported (ROADMAP.md queue 1, item 11)"
            )
        deg_p = p_space.degree
        # quadrature with p+2 points (FEEvaluation<dim, degree_p+1, degree_p+2>)
        kw = dict(dtype=dtype, device=self.device)
        self.ev_u = CellEvaluator(self.dim, u_space.basis, deg_p + 2, mesh.h, **kw)
        self.ev_p = CellEvaluator(self.dim, p_space.basis, deg_p + 2, mesh.h, **kw)
        # reduced quadrature (p+1 points) for pressure-only operators
        self.ev_p_low = CellEvaluator(
            self.dim, p_space.basis, deg_p + 1, mesh.h, **kw
        )
        self.lat_u = LatticeOps.for_space(u_space)
        self.lat_p = LatticeOps.for_space(p_space)
        self.n_q = self.ev_u.n_q
        self.n_p_padded = p_space.n_dofs_padded
        self.pressure_fix_mode = None  # set by enable_pressure_fix()

        # the coupled cell apply reads nodal vectors through cell tables and
        # treats constrained dofs as masks: Dirichlet rows only (the lattice
        # has no hanging nodes)
        for c in list(constraints_u) + [constraints_p]:
            if len(c.slave):
                raise NotImplementedError(
                    "affine constraints on the lattice are not ported"
                )
        self.cells = None
        if (
            parameters.linearization == Linearization.coupled_implicit_newton
            and parameters.physical_type == PhysicalType.incompressible
        ):
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
    def enable_pressure_fix(self) -> None:
        """Project the constant pressure mode out of residual and vmult
        (navier_stokes_matrix.cc:110-168); weights are the lumped pressure
        mass restricted to the mode."""
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
        return rp - (weights @ rp) * inv * mode

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
                if par.linearization not in (
                    Linearization.coupled_implicit_newton,
                    Linearization.coupled_implicit_picard,
                ):
                    raise NotImplementedError(
                        f"{par.linearization} is not ported (ROADMAP.md queue 1, item 9c)"
                    )
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
                else:
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
    ):
        """Assemble the positive operator terms A(u) at the current state
        (plain reads honoring inhomogeneous BCs) and freeze the linearization.
        Returns (r_u, r_p, Linearized). The caller forms
        rhs = user_rhs + const_rhs - A(u) (navier_stokes_matrix.cc:266-293)."""
        par = self.parameters
        uc = self._gather_u(u, resolve=False)
        val_u = self.ev_u.values(uc)
        grad_u = self.ev_u.gradients(uc)
        p_q = self.ev_p.values(self._gather_p(p, resolve=False))
        old_val = old_old_val = None
        if par.physical_type == PhysicalType.incompressible:
            old_val = self.ev_u.values(self._gather_u(u_old, resolve=False))
            old_old_val = self.ev_u.values(self._gather_u(u_old_old, resolve=False))
        submit_val, stress, div, new_lin = self._q_point_terms(
            "residual", tw, val_u, grad_u, p_q, old_val, old_old_val, None, coeffs
        )
        # the coupled cell apply reads the linearization point nodally (K1,
        # K4) or as cell dofs (K3's stream, gathered here once per Newton
        # step)
        new_lin = new_lin._replace(u=u, dofs=uc)
        r_u = self.ev_u.integrate_gradients(stress)
        if submit_val is not None:
            r_u = r_u + self.ev_u.integrate_values(submit_val)
        ru = self._scatter_u(r_u)
        rp = self._scatter_p(self.ev_p.integrate_values(-div))
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
        """The entry of the coupled cell apply that vmult and velocity_vmult
        run for this linearization: "nodal" (K1/K2), "gather" (K4), "cells"
        (K3, u* dof stream) or "qfields" (K3, u* q-field stream). The
        layout is demoted as the JAX operator's _pallas_coupled_apply
        demotes it."""
        if self.cells is None or lin is None or lin.grad is None:
            raise NotImplementedError(
                "the mat-vec is ported for the coupled implicit Newton "
                "linearization of the incompressible equations only "
                "(ROADMAP.md queue 1, item 9c)"
            )
        if self._cell_coeffs(coeffs) is not None:
            if lin.u is None:
                raise NotImplementedError(
                    "variable coefficients need the nodal linearization point "
                    "of K1, which the coupled Newton residual sets; other "
                    "linearizations are not ported (ROADMAP.md queue 1, item 9c)"
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
        for b0 in range(0, n_units, batch):
            b1 = min(b0 + batch, n_units)
            uc = units[b0:b1, None].expand(b1 - b0, E, dim, n_loc)
            out = self.local_velocity_apply(uc, tw, lin, coeffs)
            for k in range(b0, b1):
                c, i = divmod(k, n_loc)
                diag_loc[:, c, i] = out[k - b0, :, c, i]
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
        return dst_p + self._scatter_p(self.ev_p.integrate_values(w * div))

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
        grad_p = ev.gradients(self.lat_p.gather(con.resolve(p)))
        if coeffs.rho is not None:
            grad_p = grad_p * (inv_rho_weight / coeffs.rho)[:, None, :]
        else:
            grad_p = grad_p * inv_rho_weight
        rp = con.condense(self.lat_p.scatter_add(ev.integrate_gradients(grad_p)))
        return con.set_identity(rp, p)

    def pressure_mass_vmult(
        self, p, coefficient, coeffs: Coefficients = Coefficients(),
        constraints: Optional[Constraints] = None,
    ):
        """(q, c p) with c = 1/(mu + tau_gd) or 1 (cc:1036-1071); `coefficient`
        is a scalar or a per-cell (E,) tensor."""
        con = constraints if constraints is not None else self.constraints_p
        ev = self.ev_p_low
        val = ev.values(self.lat_p.gather(con.resolve(p)))
        if torch.is_tensor(coefficient) and coefficient.ndim == 1:
            val = val * coefficient[:, None]
        else:
            val = val * coefficient
        rp = con.condense(self.lat_p.scatter_add(ev.integrate_values(val)))
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
        pc = units[:, None, :].expand(n_loc, E, n_loc)
        g = ev.gradients(pc)
        if coeffs.rho is not None:
            g = g * (inv_rho_weight / coeffs.rho)[:, None, :]
        else:
            g = g * inv_rho_weight
        out = ev.integrate_gradients(g)  # (n_loc, E, n_loc)
        idx = torch.arange(n_loc, device=self.device)
        diag_loc = out[idx, :, idx].transpose(0, 1)  # (E, n_loc)
        d = self.lat_p.scatter_add(diag_loc)
        if len(con.constrained_dofs):
            d[torch.as_tensor(con.constrained_dofs, device=self.device)] = 1.0
        return d

    def pressure_lumped_mass(self, coefficient=None):
        """Lumped pressure mass diagonal (for the diagonal preconditioner of
        the mass solves, diagonal_preconditioner.cc); `coefficient`: optional
        per-cell (E,) weight."""
        E = self.u_space.mesh.n_cells
        ones = torch.ones((E, self.ev_p_low.n_q), dtype=self.dtype, device=self.device)
        if coefficient is not None:
            ones = ones * (
                coefficient[:, None]
                if torch.is_tensor(coefficient) and coefficient.ndim == 1
                else coefficient
            )
        return self.lat_p.scatter_add(self.ev_p_low.integrate_values(ones))
