"""Preconditioner building blocks and the block-triangular NS preconditioner.

PyTorch counterpart of ``adaflo_tpu/solvers/preconditioner.py`` (the
reference's NavierStokesPreconditioner,
source/navier_stokes_preconditioner.cc:593-737), lattice branch: the same
block structure

  1. approximate velocity-block inverse (one lattice GMG V-cycle per
     component for 'amg*', Chebyshev/Jacobi otherwise, Jacobi-GMRES when the
     block is convection dominated),
  2. apply the divergence block,
  3. Schur complement: Cahouet-Chabbard (scaled pressure-mass solve plus a
     pressure-Poisson approximation).

The stationary type takes the Kay-Loghin-Wathen Schur complement
(ns_prec.cc:678-708) and a velocity block without mass; the projection
scheme's fractional step (`solve_projection_system`, ns_prec.cc:777-850)
solves the momentum equation with GMRES, the pressure Poisson equation with
CG and adds the rotational correction.

With the two-phase flow's per-q-point density and viscosity, the Schur
complement takes per-q 1/rho in the pressure Poisson operator and per-cell
1/(mu + tau_gd) in the pressure mass (not in the projection scheme or the
stationary type), and the GMG levels per-subcell coefficients. The cell
constants of augmented Taylor-Hood take Jacobi beside the pressure V-cycle
and their mode is projected out of the mass solve. State lives
in a NamedTuple (`PrecState`) rebuilt by `compute`.

On adaptive forests the multigrid is the forest hierarchy's ForestGMG
(solvers/forest_multigrid.py): one per velocity component on its fully
constrained sides, and the pressure Poisson's with the Schur complement's
pinned dof; its levels keep the mesh cells, so per-cell coefficients pass
to them directly (the JAX package's per_cell_levels,
adaflo_tpu/solvers/preconditioner.py:258-292, 407-409, 528-534). Mapped
meshes and the graded lattice are not ported (ROADMAP.md queue 1, item 15).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from adaflo_tpu_torch.ops.navier_stokes import (
    Coefficients,
    NavierStokesOperator,
    TimeWeights,
)
from adaflo_tpu_torch.parameters import (
    FlowParameters,
    Linearization,
    PhysicalType,
    PressurePreconditioner,
    VelocityPreconditioner,
)
from adaflo_tpu_torch.solvers.forest_multigrid import ForestGMG
from adaflo_tpu_torch.solvers.krylov import bicgstab, cg, gmres
from adaflo_tpu_torch.solvers.multigrid import LatticeGMG
from adaflo_tpu_torch.utils.timer import profiler_range


class DiagonalPreconditioner:
    """Inverse-diagonal application with the reference's thresholding
    (diagonal_preconditioner.cc:38-124): entries below 1e-10 * ||d||_inf are
    treated as 1."""

    def __init__(self, diagonal) -> None:
        self.diagonal = diagonal
        mx = torch.max(torch.abs(diagonal))
        self.inverse = torch.where(
            torch.abs(diagonal) > 1e-10 * mx, 1.0 / diagonal, 1.0
        )

    def vmult(self, r):
        return self.inverse * r

    __call__ = vmult


def estimate_lambda_max(A: Callable, Dinv, shape_like, n_iter: int = 12) -> float:
    """Power iteration estimate of lambda_max(D^-1 A) (replaces deal.II
    PreconditionChebyshev's Lanczos estimate). Deterministic start vector."""
    n = shape_like.numel()
    v = torch.cos(
        torch.arange(n, dtype=shape_like.dtype, device=shape_like.device) * 0.7 + 0.3
    ).reshape(shape_like.shape)
    v = v / torch.sqrt(torch.sum(v * v))
    lam = torch.ones((), dtype=shape_like.dtype, device=shape_like.device)
    for _ in range(n_iter):
        w = Dinv * A(v)
        lam = torch.sqrt(torch.sum(w * w))
        v = w / torch.clamp(lam, min=1e-30)
    return float(lam)


class ChebyshevPreconditioner:
    """Chebyshev-polynomial approximate inverse of an SPD(-dominated)
    operator preconditioned by its inverse diagonal."""

    def __init__(
        self,
        A: Callable,
        diagonal,
        lambda_max: float,
        degree: int = 4,
        smoothing_range: float = 30.0,
    ) -> None:
        self.A = A
        self.Dinv = DiagonalPreconditioner(diagonal).inverse
        self.degree = degree
        self.lmax = 1.2 * lambda_max
        self.lmin = lambda_max / smoothing_range

    def vmult(self, b):
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma1 = theta / delta
        z = self.Dinv * b
        d = z / theta
        x = d
        rho_old = 1.0 / sigma1
        for _ in range(1, self.degree):
            r = b - self.A(x)
            z = self.Dinv * r
            rho = 1.0 / (2.0 * sigma1 - rho_old)
            d = rho * rho_old * d + 2.0 * rho / delta * z
            x = x + d
            rho_old = rho
        return x

    __call__ = vmult


class PrecState(NamedTuple):
    """Data rebuilt on preconditioner refresh (the analog of the
    reference's assemble_matrices + compute, ns_prec.cc:899-974)."""

    u_diag: torch.Tensor  # (dim, n_u) velocity-block diagonal
    u_lambda_max: float
    poisson_diag: torch.Tensor  # (n_p,)
    poisson_lambda_max: float
    mass_diag: torch.Tensor  # (n_p,) lumped pressure mass (unweighted)
    mass_diag_w: torch.Tensor  # (n_p,) lumped mass weighted by mass_coefficient
    inv_rho_weight: float  # 1/(time weight * rho_min)
    mass_coefficient: object  # 1/(mu + tau_gd): a float, or per cell (E,)
    lin: object  # frozen Linearized state
    coeffs: Coefficients
    u_gmg: object = None  # tuple of per-component GMGState, or None
    p_gmg: object = None  # GMGState for the pressure Poisson, or None
    # contraction factor of the velocity-block Chebyshev as a fixed-point
    # iteration; > 1 switches the apply to Jacobi-GMRES
    u_cheb_growth: float = 0.0


class NavierStokesPreconditioner:
    """Block-triangular preconditioner; `apply` mirrors ns_prec.cc:593-737."""

    def __init__(
        self,
        parameters: FlowParameters,
        op: NavierStokesOperator,
        constraints_schur,
        u_chebyshev_degree: int = 5,
        p_chebyshev_degree: int = 5,
    ) -> None:
        self.parameters = parameters
        self.op = op
        self.constraints_schur = constraints_schur
        self.u_cheb_deg = u_chebyshev_degree
        self.p_cheb_deg = p_chebyshev_degree
        # geometric multigrid on the Q1-subelement lattice replaces the
        # reference's AMG ('lin velocity preconditioner = amg*'); 'ilu*'
        # falls back to Chebyshev/Jacobi
        self.use_gmg = parameters.precondition_velocity in (
            VelocityPreconditioner.u_amg,
            VelocityPreconditioner.u_amg_linear,
        )
        kw = dict(dtype=op.dtype, device=op.device)
        if op.u_space.is_forest:
            self._forest_gmg(op, constraints_schur, **kw)
            return
        mesh = op.u_space.mesh
        h_u = mesh.h / parameters.velocity_degree
        h_p = mesh.h / max(parameters.pressure_degree, 1)
        self.u_gmg_geom = [
            LatticeGMG(
                op.u_space.n_nodes_axis,
                h_u,
                op.constraints_u[c].constrained_dofs,
                op.u_space.n_dofs_padded,
                **kw,
            )
            for c in range(op.dim)
        ] if self.use_gmg else None
        self.p_gmg_geom = LatticeGMG(
            op.p_space.n_nodes_axis,
            h_p,
            constraints_schur.constrained_dofs,
            op.p_space.n_dofs_padded,
            **kw,
        ) if parameters.pressure_degree >= 1 else None

    def _forest_gmg(self, op, constraints_schur, **kw) -> None:
        """ForestGMG per velocity component on the sides whose dofs its
        constraints hold all (forest NS: Dirichlet and no-slip sides, a
        symmetry side in its normal component), and the pressure Poisson's
        with the first Schur-constrained dof as the pin."""
        u_space, p_space = op.u_space, op.p_space
        sides = [(a, s) for a in range(op.dim) for s in (0, 1)]
        self.u_gmg_geom = [
            ForestGMG(
                u_space,
                [
                    (a, s) for a, s in sides
                    if len(d := u_space.side_dofs(a, s)) and con.is_constrained[d].all()
                ],
                u_space.n_dofs_padded,
                **kw,
            )
            for con in op.constraints_u
        ] if self.use_gmg else None
        pin = None
        if len(constraints_schur.dirichlet_dofs):
            pin = p_space.node_coords[int(constraints_schur.dirichlet_dofs[0])]
        self.p_gmg_geom = ForestGMG(
            p_space, [], p_space.n_dofs_padded, pin_position=pin, **kw
        ) if self.parameters.pressure_degree >= 1 else None

    def _to_levels(self, x_cells, deg: int):
        """A per-cell coefficient on the GMG's finest level: as it is on a
        forest, whose levels keep the mesh cells, on the deg^dim Q1 subcells
        of each cell on a lattice."""
        if self.op.u_space.is_forest:
            return x_cells
        return _cells_to_subcells(x_cells, self.op.u_space.mesh.n_cells_axis, deg)

    # -- build ----------------------------------------------------------
    def compute(self, tw: TimeWeights, lin, coeffs: Coefficients) -> PrecState:
        """Freeze the linearization point and rebuild diagonals, eigenvalue
        estimates and multigrid levels (the analog of
        fix_linearization_point + assemble + ILU/AMG setup)."""
        par = self.parameters
        op = self.op
        u_diag = op.velocity_block_diagonal(tw, lin, coeffs)
        uA = lambda v: op.velocity_vmult(v, tw, lin, coeffs)
        u_dinv = DiagonalPreconditioner(u_diag).inverse
        u_lmax = estimate_lambda_max(uA, u_dinv, u_diag)

        # stability probe: one error-propagation step of the Chebyshev
        # fixed-point iteration; growth > 1 flags a convection-dominated block
        cheb_probe = ChebyshevPreconditioner(uA, u_diag, u_lmax, self.u_cheb_deg)
        e0 = torch.cos(
            torch.arange(u_diag.numel(), dtype=u_diag.dtype, device=u_diag.device)
            * 0.7
        ).reshape(u_diag.shape)
        e1 = e0 - cheb_probe(uA(e0))
        e2 = e1 - cheb_probe(uA(e1))
        u_cheb_growth = float(
            torch.sqrt(torch.sum(e2 * e2) / torch.clamp(torch.sum(e1 * e1), min=1e-300))
        )

        # variable-coefficient Schur pieces (the reference's
        # use_variable_coefficients branches): per-q 1/rho in the pressure
        # Poisson (nsm.cc:976-997) and per-cell 1/(mu + tau) at the cell's
        # centre q-point in the scaled pressure mass (nsm.cc:1050-1061),
        # neither in the projection scheme nor the stationary type
        if par.physical_type == PhysicalType.incompressible_stationary:
            inv_rho_weight = mass_coefficient = 1.0
        else:
            rho_min = min(par.density, par.density + par.density_diff)
            inv_rho_weight = 1.0 / (tw.weight * rho_min) if rho_min > 0 else 0.0
            if par.linearization == Linearization.projection:
                mass_coefficient = 1.0
            elif coeffs.mu is not None:
                mu_cell = coeffs.mu[:, coeffs.mu.shape[1] // 2]
                mass_coefficient = 1.0 / (mu_cell + par.tau_grad_div)
            else:
                mass_coefficient = 1.0 / (par.viscosity + par.tau_grad_div)

        pscale, pcoeffs = self._poisson_scale_coeffs(
            inv_rho_weight, coeffs if self._variable_schur else Coefficients()
        )
        poisson_diag = op.pressure_poisson_diagonal(
            pscale, self.constraints_schur, pcoeffs
        )
        pA = lambda p: op.pressure_poisson_vmult(
            p, pscale, pcoeffs, self.constraints_schur
        )
        p_dinv = DiagonalPreconditioner(poisson_diag).inverse
        p_lmax = estimate_lambda_max(pA, p_dinv, poisson_diag)
        mass_diag = op.pressure_lumped_mass()
        if torch.is_tensor(mass_coefficient):
            mass_diag_w = op.pressure_lumped_mass(mass_coefficient)
        else:
            mass_diag_w = mass_diag * mass_coefficient

        # the velocity V-cycle serves constant coefficients in the coupled
        # solve on a lattice (see _u_approx_inverse), any on a forest, and
        # any in the projection scheme's momentum solve; the lattice's GMG
        # levels smooth on Q1 subcells, with per-cell rho, mu and 1/rho
        # upsampled to the deg^dim subcells of each cell
        u_gmg = p_gmg = None
        constant = coeffs.rho is None and coeffs.mu is None
        if self.use_gmg and self.u_gmg_geom is not None and (
            constant
            or self.op.u_space.is_forest
            or par.linearization == Linearization.projection
        ):
            deg = par.velocity_degree
            if coeffs.rho is not None:
                alpha_u = tw.weight * self._to_levels(torch.mean(coeffs.rho, dim=1), deg)
            else:
                alpha_u = tw.weight * par.density
            if par.physical_type != PhysicalType.incompressible:
                alpha_u = 0.0 * alpha_u  # no mass term (stationary / Stokes)
            if coeffs.mu is not None:
                beta_u = tw.tau1 * self._to_levels(torch.mean(coeffs.mu, dim=1), deg)
            else:
                beta_u = tw.tau1 * par.viscosity
            u_gmg = tuple(g.compute(alpha_u, beta_u) for g in self.u_gmg_geom)
        if self.p_gmg_geom is not None:
            if pcoeffs.rho is not None:
                inv_rho_cell = torch.mean(1.0 / pcoeffs.rho, dim=1)
                beta_p = pscale * self._to_levels(
                    inv_rho_cell, max(par.pressure_degree, 1)
                )
            else:
                beta_p = pscale
            p_gmg = self.p_gmg_geom.compute(0.0, beta_p)

        return PrecState(
            u_diag,
            u_lmax,
            poisson_diag,
            p_lmax,
            mass_diag,
            mass_diag_w,
            inv_rho_weight,
            mass_coefficient,
            lin,
            coeffs,
            u_gmg,
            p_gmg,
            u_cheb_growth,
        )

    # -- pieces ---------------------------------------------------------
    @property
    def _variable_schur(self) -> bool:
        """Whether the Schur complement takes the variable coefficients: not
        in the projection scheme, nor in the stationary type."""
        par = self.parameters
        return (
            par.linearization != Linearization.projection
            and par.physical_type != PhysicalType.incompressible_stationary
        )

    def _poisson_scale_coeffs(self, inv_rho_weight: float, coeffs: Coefficients):
        """(scale, coeffs) of the pressure Poisson operator: with variable
        density the per-q 1/rho enters and the scale is 1/weight
        (= inv_rho_weight * rho_min); otherwise the constant
        1/(weight * rho_min) and no coefficients."""
        scale = inv_rho_weight if inv_rho_weight > 0 else 1.0
        if coeffs.rho is None:
            return scale, Coefficients()
        par = self.parameters
        return scale * min(par.density, par.density + par.density_diff), coeffs

    def _u_approx_inverse(
        self, st: PrecState, ru, tw, do_inner: bool, u_robust: bool = False
    ):
        uA = lambda v: self.op.velocity_vmult(v, tw, st.lin, st.coeffs)
        if u_robust:
            # convection-dominated block: fixed-count Jacobi-GMRES in the role
            # of the reference's nonsymmetry-robust ILU (ns_prec.cc:594-665)
            dinv = DiagonalPreconditioner(st.u_diag).inverse
            n_it = 30 if do_inner else 8
            tol = 3e-2 * float(torch.sqrt(torch.sum(ru * ru))) if do_inner else 1e-50
            return gmres(
                uA, ru, torch.zeros_like(ru), tol, n_it, restart=n_it,
                M=lambda r: dinv * r,
            ).x
        # 'amg linear': one GMG V-cycle per component (ns_prec.cc velocity
        # AMG); the Q1-subcell model of a two-phase (variable-coefficient)
        # block underperforms the Chebyshev of the true operator, and so does
        # the mass-free model of the stationary block, so on a lattice the
        # V-cycle serves transient constant-coefficient blocks only, as in
        # the JAX package; forest levels carry the true per-cell rho and mu
        if (
            st.u_gmg is not None
            and self.parameters.physical_type != PhysicalType.incompressible_stationary
            and (st.coeffs.rho is None or self.op.u_space.is_forest)
        ):
            M = lambda r: torch.stack(
                [
                    self.u_gmg_geom[c].vmult(st.u_gmg[c], r[c])
                    for c in range(self.op.dim)
                ]
            )
        else:
            M = ChebyshevPreconditioner(
                uA, st.u_diag, st.u_lambda_max, self.u_cheb_deg
            )
        if not do_inner:
            return M(ru)
        # inner solve to 3e-2 relative with BiCGStab (ns_prec.cc:636-665)
        rnorm = float(torch.sqrt(torch.sum(ru * ru)))
        res = bicgstab(uA, ru, None, 3e-2 * rnorm, 50, M=M)
        # fall back to the plain apply if the inner iteration broke down
        if res.converged or res.residual < rnorm:
            return res.x
        return M(ru)

    def _poisson_preconditioner(self, st: PrecState, pA):
        if st.p_gmg is not None:
            return lambda r: self._poisson_gmg_apply(st, r)
        return ChebyshevPreconditioner(
            pA, st.poisson_diag, st.poisson_lambda_max, self.p_cheb_deg
        )

    def _poisson_gmg_apply(self, st: PrecState, r):
        """The Poisson V-cycle on the Q part; Jacobi on the cell constants
        of augmented Taylor-Hood."""
        op = self.op
        if not op.augmented:
            return self.p_gmg_geom.vmult(st.p_gmg, r)
        rq, rc = op._split_p(r)
        xq = self.p_gmg_geom.vmult(st.p_gmg, rq)
        scale = st.inv_rho_weight if st.inv_rho_weight > 0 else 1.0
        out = op._join_p(xq, rc / (op.dg0_diagonal() * scale))
        cs = self.constraints_schur.constrained_dofs
        if len(cs):
            idx = torch.as_tensor(cs, device=out.device)
            out[idx] = r[idx]
        return out

    def _poisson_approx_inverse(self, st: PrecState, rp, strong: bool):
        pscale, pcoeffs = self._poisson_scale_coeffs(
            st.inv_rho_weight, st.coeffs if self._variable_schur else Coefficients()
        )
        pA = lambda p: self.op.pressure_poisson_vmult(
            p, pscale, pcoeffs, self.constraints_schur
        )
        M = self._poisson_preconditioner(st, pA)
        if not strong:
            return M(rp)
        tol = 3e-2 * float(torch.sqrt(torch.sum(rp * rp)))
        return cg(pA, rp, None, tol, 30, M=M).x

    @profiler_range
    def solve_pressure_mass(self, st: PrecState, rp):
        """CG on the scaled pressure mass, rel 1e-2, lumped-mass diagonal
        preconditioner (ns_prec.cc:741-773); 'p_mass_diag' applies the
        inverse lumped diagonal once (ns_prec.cc:958-971). With augmented
        Taylor-Hood the mass vmult projects out the cell constants' mode
        (the operator is singular, cc:449-454), so the rhs and the
        preconditioned residuals are projected too (else the CG iterates
        take up the null component), and the solve is never the one
        diagonal apply."""
        op = self.op
        par = self.parameters
        dinv = DiagonalPreconditioner(st.mass_diag_w).inverse
        if op.pressure_dg0_mode is not None and par.linearization != Linearization.projection:
            m1, w1, i1 = op.pressure_dg0_mode
            proj = lambda v: v - (w1 @ v) * i1 * m1
            rp = proj(rp)
            M = lambda r: proj(dinv * r)
        else:
            M = lambda r: dinv * r
        if (
            par.precondition_pressure == PressurePreconditioner.p_mass_diag
            and not par.augmented_taylor_hood
        ):
            return M(rp)
        mA = lambda p: op.pressure_mass_vmult(p, st.mass_coefficient)
        return cg(
            mA, rp, torch.zeros_like(rp), 1e-50, 100, M=M, reduction=1e-2
        ).x

    # -- application ----------------------------------------------------
    @profiler_range
    def apply(
        self,
        st: PrecState,
        rhs,
        tw: TimeWeights,
        do_inner: bool,
        u_robust: bool = False,
    ):
        """Apply the block-triangular preconditioner to (ru, rp)."""
        ru, rp = rhs
        op = self.op
        du = self._u_approx_inverse(st, ru, tw, do_inner, u_robust)
        # temp = -rp + B du (ns_prec.cc:670-673)
        temp = op.divergence_vmult_add(-rp, du, coeffs=st.coeffs)
        if self.parameters.physical_type == PhysicalType.incompressible_stationary:
            # Kay-Loghin-Wathen (ns_prec.cc:678-708): a Laplacian with
            # coefficient 1 (the stationary branch of nsm.cc:1020-1024), the
            # mu-weighted Laplacian, then the pressure mass
            cs = self.constraints_schur
            pA = lambda p: op.pressure_poisson_vmult(p, 1.0, Coefficients(), cs)
            tol = 1e-2 * float(torch.sqrt(torch.sum(temp * temp)))
            dp = cg(pA, temp, None, tol, 30, M=self._poisson_preconditioner(st, pA)).x
            idx = cs.constrained_dofs
            if len(idx):
                idx = torch.as_tensor(idx, device=dp.device)
                dp = dp.clone()
                dp[idx] = 0.0
            t2 = op.pressure_convdiff_vmult(dp, st.coeffs, cs)
            if len(idx):
                t2[idx] = temp[idx]
            return (du, self.solve_pressure_mass(st, t2))
        # Cahouet-Chabbard (ns_prec.cc:710-737)
        dp = self.solve_pressure_mass(st, temp)
        if self.parameters.density > 0:
            dp = dp + self._poisson_approx_inverse(st, temp, do_inner)
        return (du, dp)

    # ------------------------------------------------------------------
    @profiler_range
    def solve_projection_system(
        self,
        st: PrecState,
        solution_u,
        rhs_u,
        tw: TimeWeights,
        nl_tolerance: float,
        lin_tolerance: float,
        dt_start: float,
        constraints_u,
        constraints_schur,
        lin=None,
    ):
        """Fractional-step pressure-correction solve (ns_prec.cc:777-850):
        GMRES momentum solve, CG pressure-Poisson projection, rotational
        update through the mu-weighted divergence and a mass solve. Returns
        (update_u, update_p, phi, iterations, residual). `lin` is the
        current step's linearization for the momentum matrix; the
        preconditioner keeps st's frozen copy."""
        op = self.op
        par = self.parameters
        lin = lin if lin is not None else st.lin
        uA = lambda v: op.velocity_vmult(v, tw, lin, st.coeffs)
        if st.u_gmg is not None:
            M = lambda r: torch.stack(
                [self.u_gmg_geom[c].vmult(st.u_gmg[c], r[c]) for c in range(op.dim)]
            )
        else:
            M = ChebyshevPreconditioner(uA, st.u_diag, st.u_lambda_max, self.u_cheb_deg)
        res_u = gmres(
            uA, rhs_u, torch.zeros_like(rhs_u), 0.5 * nl_tolerance,
            par.max_lin_iteration, restart=50, M=M,
        )
        du = torch.stack([con.distribute(res_u.x[c]) for c, con in enumerate(constraints_u)])
        u_star = solution_u + du

        # pressure Poisson: rhs = -div(u*) with plain reads (cc:811-825);
        # constant coefficients with rho_min (the reference's
        # use_variable_coefficients excludes projection, nsm.cc:976-978)
        zeros_p = torch.zeros(
            op.n_p_padded, dtype=solution_u.dtype, device=solution_u.device
        )
        rhs_p = op.divergence_vmult_add(zeros_p, u_star, coeffs=st.coeffs, plain=True)
        pA = lambda p: op.pressure_poisson_vmult(
            p, st.inv_rho_weight, Coefficients(), constraints_schur
        )
        rho_min = min(par.density, par.density + par.density_diff)
        tol_p = 0.1 * dt_start / rho_min * nl_tolerance
        cs = constraints_schur.constrained_dofs
        if len(cs):
            rhs_p = rhs_p.clone()
            rhs_p[torch.as_tensor(cs, device=rhs_p.device)] = 0.0
        phi = cg(pA, rhs_p, None, tol_p, 1000, M=self._poisson_preconditioner(st, pA)).x
        phi = constraints_schur.distribute(phi)

        # rotational part: rhs = -mu div(u*); mass solve (cc:827-846)
        rhs_rot = op.divergence_vmult_add(
            zeros_p, u_star, weight_by_viscosity=True, coeffs=st.coeffs, plain=True
        )
        mA = lambda p: op.pressure_mass_vmult(p, 1.0)
        dinv = DiagonalPreconditioner(st.mass_diag).inverse
        dp_rot = cg(
            mA, rhs_rot, torch.zeros_like(rhs_rot), 1e-50, 1000,
            M=lambda r: dinv * r, reduction=0.1 * lin_tolerance,
        ).x
        dp = constraints_schur.distribute(dp_rot) + phi
        return du, dp, phi, res_u.iterations, res_u.residual


def _cells_to_subcells(x_cells, n_cells_axis, deg: int):
    """Upsample a per-cell tensor to the deg^dim Q1 subcells of each cell
    (lexicographic subcell order of the GMG's finest level)."""
    dim = len(n_cells_axis)
    xx = x_cells.reshape(tuple(reversed(n_cells_axis)))
    for a in range(dim):
        xx = torch.repeat_interleave(xx, deg, dim=a)
    return xx.reshape(-1)
