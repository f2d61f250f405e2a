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

With the two-phase flow's per-q-point density and viscosity, the Schur
complement takes per-q 1/rho in the pressure Poisson operator and per-cell
1/(mu + tau_gd) in the pressure mass, and the GMG levels per-subcell
coefficients. State lives in a NamedTuple (`PrecState`) rebuilt by
`compute`. Forest and mapped meshes, the graded lattice and the stationary
(Kay-Loghin-Wathen) and projection variants raise NotImplementedError
(ROADMAP.md queue 1).
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
        if (
            parameters.physical_type != PhysicalType.incompressible
            or parameters.linearization == Linearization.projection
        ):
            raise NotImplementedError(
                "only the time-dependent coupled preconditioner is ported "
                "(ROADMAP.md queue 1, item 9c)"
            )
        # geometric multigrid on the Q1-subelement lattice replaces the
        # reference's AMG ('lin velocity preconditioner = amg*'); 'ilu*'
        # falls back to Chebyshev/Jacobi
        self.use_gmg = parameters.precondition_velocity in (
            VelocityPreconditioner.u_amg,
            VelocityPreconditioner.u_amg_linear,
        )
        mesh = op.u_space.mesh
        kw = dict(dtype=op.dtype, device=op.device)
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
        # centre q-point in the scaled pressure mass (nsm.cc:1050-1061)
        rho_min = min(par.density, par.density + par.density_diff)
        inv_rho_weight = 1.0 / (tw.weight * rho_min) if rho_min > 0 else 0.0
        if coeffs.mu is not None:
            mu_cell = coeffs.mu[:, coeffs.mu.shape[1] // 2]
            mass_coefficient = 1.0 / (mu_cell + par.tau_grad_div)
        else:
            mass_coefficient = 1.0 / (par.viscosity + par.tau_grad_div)

        pscale, pcoeffs = self._poisson_scale_coeffs(inv_rho_weight, coeffs)
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

        # the velocity V-cycle serves constant coefficients only (see
        # _u_approx_inverse); the pressure GMG smooths on Q1 subcells, with
        # per-cell 1/rho upsampled to the deg^dim subcells of each cell
        n_cells_axis = op.u_space.mesh.n_cells_axis
        u_gmg = p_gmg = None
        constant = coeffs.rho is None and coeffs.mu is None
        if self.use_gmg and self.u_gmg_geom is not None and constant:
            alpha_u = tw.weight * par.density
            beta_u = tw.tau1 * par.viscosity
            u_gmg = tuple(g.compute(alpha_u, beta_u) for g in self.u_gmg_geom)
        if self.p_gmg_geom is not None:
            if pcoeffs.rho is not None:
                inv_rho_cell = torch.mean(1.0 / pcoeffs.rho, dim=1)
                beta_p = pscale * _cells_to_subcells(
                    inv_rho_cell, n_cells_axis, max(par.pressure_degree, 1)
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
        # block underperforms the Chebyshev of the true operator, so the
        # V-cycle serves constant coefficients only, as in the JAX package
        if st.u_gmg is not None:
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

    def _poisson_approx_inverse(self, st: PrecState, rp, strong: bool):
        pscale, pcoeffs = self._poisson_scale_coeffs(st.inv_rho_weight, st.coeffs)
        pA = lambda p: self.op.pressure_poisson_vmult(
            p, pscale, pcoeffs, self.constraints_schur
        )
        if st.p_gmg is not None:
            M = lambda r: self.p_gmg_geom.vmult(st.p_gmg, r)
        else:
            M = ChebyshevPreconditioner(
                pA, st.poisson_diag, st.poisson_lambda_max, self.p_cheb_deg
            )
        if not strong:
            return M(rp)
        tol = 3e-2 * float(torch.sqrt(torch.sum(rp * rp)))
        return cg(pA, rp, None, tol, 30, M=M).x

    @profiler_range
    def solve_pressure_mass(self, st: PrecState, rp):
        """CG on the scaled pressure mass, rel 1e-2, lumped-mass diagonal
        preconditioner (ns_prec.cc:741-773); 'p_mass_diag' applies the
        inverse lumped diagonal once (ns_prec.cc:958-971)."""
        op = self.op
        dinv = DiagonalPreconditioner(st.mass_diag_w).inverse
        M = lambda r: dinv * r
        if self.parameters.precondition_pressure == PressurePreconditioner.p_mass_diag:
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
        du = self._u_approx_inverse(st, ru, tw, do_inner, u_robust)
        # temp = -rp + B du (ns_prec.cc:670-673)
        temp = self.op.divergence_vmult_add(-rp, du, coeffs=st.coeffs)
        # Cahouet-Chabbard (ns_prec.cc:710-737)
        dp = self.solve_pressure_mass(st, temp)
        if self.parameters.density > 0:
            dp = dp + self._poisson_approx_inverse(st, temp, do_inner)
        return (du, dp)


def _cells_to_subcells(x_cells, n_cells_axis, deg: int):
    """Upsample a per-cell tensor to the deg^dim Q1 subcells of each cell
    (lexicographic subcell order of the GMG's finest level)."""
    dim = len(n_cells_axis)
    xx = x_cells.reshape(tuple(reversed(n_cells_axis)))
    for a in range(dim):
        xx = torch.repeat_interleave(xx, deg, dim=a)
    return xx.reshape(-1)
