"""Matrix-free conservative level-set (Olsson-Kreiss-Zahedi) solver.

PyTorch counterpart of ``adaflo_tpu/twophase/level_set_okz.py`` (the
reference's LevelSetOKZSolver + LevelSetBaseAlgorithm, source/
level_set_okz.cc, level_set_base.cc): the four OKZ operators of
ops/level_set.py, the tanh distance transform, the discrete (Peskin)
heaviside, the surface-tension force into the NS solver's user_rhs and its
per-q-point density and viscosity into the NS coefficients, and the time
step advance_concentration -> reinitialize -> compute_force -> NS solve with
the excessive-residual correction (level_set_base.cc:188-291).

Each solve is a Krylov loop on the host over tensor operations on the
solver's device, in the order of the JAX package's step; the JAX package's
fused pre-Newton program (one XLA dispatch for the same arithmetic) is a
dispatch fusion for the TPU and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from adaflo_tpu_torch.ops.level_set import LevelSetOperators
from adaflo_tpu_torch.ops.navier_stokes import Coefficients, TimeWeights
from adaflo_tpu_torch.parameters import FlowParameters
from adaflo_tpu_torch.solvers.krylov import bicgstab, cg, gmres
from adaflo_tpu_torch.solvers.preconditioner import (
    ChebyshevPreconditioner,
    DiagonalPreconditioner,
    estimate_lambda_max,
)
from adaflo_tpu_torch.twophase.base import TwoPhaseBaseAlgorithm


def _norm(x) -> float:
    return float(torch.sqrt(torch.sum(x * x)))


class LevelSetOKZSolver(TwoPhaseBaseAlgorithm):
    def __init__(self, parameters: FlowParameters, mesh, out=None, device=None) -> None:
        super().__init__(parameters, mesh, "iso_q1", out=out, device=device)
        self.last_smoothing_step = 0
        self.old_residual = 1e30
        self.first_advance = True

    # ------------------------------------------------------------------
    def transform_distance_function(self, vector):
        """phi = -tanh(d / (2 eps)) (level_set_okz.cc:201-210)."""
        return -torch.tanh(vector / (2.0 * self.epsilon_used))

    def initialize_data_structures(self) -> None:
        ops = self.ops = LevelSetOperators(
            self.parameters,
            self.ls_space,
            self.navier_stokes.u_space,
            self.navier_stokes.p_space,
            self.constraints_ls,
            self.constraints_normals,
            self.constraints_curvature,
            self.epsilon_used,
            self.cell_diameter,
            self.minimal_edge_length,
            dtype=self.dtype,
            device=self.device,
        )
        dim = self.mesh.dim
        self.mass_diag = ops.lumped_mass()
        self.inv_mass_diag = DiagonalPreconditioner(self.mass_diag).inverse
        self.proj_diag = ops.projection_diagonal()
        self.proj_diag_block = self.proj_diag.expand(dim, -1)
        self.proj_lambda = estimate_lambda_max(
            ops.projection_vmult_block,
            DiagonalPreconditioner(self.proj_diag_block).inverse,
            self._zeros(dim, len(self.proj_diag)),
        )
        self.evaluated_normal_q = self._zeros(self.mesh.n_cells, dim, ops.n_q)

    # -- the solves --------------------------------------------------------
    def _mass_inverse(self, r):
        return self.inv_mass_diag * r

    def _advect(self, u_fields, tw, abs_tol: float, old_dt: float):
        """Concentration increment of the advection step: BiCGStab(30), then
        GMRES(300, restart 50) when it did not converge (the JAX package's
        lax.cond); returns (increment, iterations of both, |rhs|)."""
        ops = self.ops
        c, c_old, c_old_old = self.solution[0], self.solution_old[0], self.solution_old_old[0]
        rhs, conv, nu_art = ops.advection_rhs(
            c, c_old, c_old_old, *u_fields, tw, True, old_dt
        )
        A = lambda x: ops.advection_vmult(x, conv, tw, self.mass_diag, nu_art)
        res = bicgstab(A, rhs, None, abs_tol, 30, M=self._mass_inverse)
        rhs_norm = _norm(rhs)
        if res.converged:
            return res.x, res.iterations, rhs_norm
        r2 = gmres(A, rhs, None, abs_tol, 300, 50, M=self._mass_inverse)
        return r2.x, res.iterations + r2.iterations, rhs_norm

    def _normal(self, c, reduction: float):
        """Projected normal field (compute_normal.cc:207-278)."""
        ops = self.ops
        A = ops.projection_vmult_block
        cheb = ChebyshevPreconditioner(A, self.proj_diag_block, self.proj_lambda, degree=5)
        rhs = ops.normal_rhs(c)
        res = cg(A, rhs, torch.zeros_like(rhs), 1e-50, 400, M=cheb, reduction=reduction)
        nv = torch.stack([ops.con_nrm.distribute(res.x[d]) for d in range(self.mesh.dim)])
        return nv, res.iterations

    def _curvature(self, nv):
        """Projected curvature (compute_curvature.cc:212-379)."""
        ops = self.ops
        A = ops.projection_vmult_scalar
        cheb = ChebyshevPreconditioner(A, self.proj_diag, self.proj_lambda, degree=5)
        rhs = ops.curvature_rhs(nv)
        res = cg(A, rhs, torch.zeros_like(rhs), 1e-50, 400, M=cheb, reduction=1e-8)
        return ops.con_curv.distribute(res.x), res.iterations

    def _reinit_step(self, c, nv, first_step: bool, en, dtau_inv: float, diffuse_only: bool):
        """One reinitialization step (reinit.cc:256-363); returns (c, the
        frozen normal at the q-points, CG iterations, |increment|)."""
        ops = self.ops
        rhs, en = ops.reinit_rhs(c, nv, first_step, en, diffuse_only)
        A = lambda x: ops.reinit_vmult(x, en, dtau_inv, diffuse_only, self.mass_diag)
        res = cg(
            A, rhs, torch.zeros_like(rhs), 1e-50, 600, M=self._mass_inverse,
            reduction=1e-6,
        )
        inc = self.constraints_ls.distribute(res.x)
        return c + inc, en, res.iterations, _norm(inc)

    def _dtau_inv(self) -> float:
        sub = self.parameters.concentration_subdivisions
        return max(
            0.95 / ((1.0 / (self.mesh.dim**2)) * self.minimal_edge_length / sub),
            1.0 / (5.0 * self.time_stepping.step_size()),
        )

    def _verbose(self) -> bool:
        par = self.parameters
        return not par.do_iteration and par.output_verbosity > 0

    def _u_fields(self):
        ns = self.navier_stokes
        return ns.solution[0], ns.solution_old[0], ns.solution_old_old[0]

    # -- operations ------------------------------------------------------
    def compute_normal(self, fast: bool) -> None:
        if getattr(self.parameters, "approximate_projections", False):
            raise NotImplementedError(
                "'approximate projections' is not implemented (the reference "
                "asserts ExcNotImplemented here too); unset it to use the full "
                "projection solves"
            )
        self.normal_vector_field, _ = self._normal(self.solution[0], 1e-5 if fast else 1e-7)

    def compute_curvature(self) -> None:
        self.compute_normal(False)
        kappa, _ = self._curvature(self.normal_vector_field)
        if self.parameters.curvature_correction:
            kappa = self._curvature_correction(kappa)
        self.solution[1] = kappa

    def _curvature_correction(self, kappa, c=None):
        """kappa -> 1/(1/kappa + d/(dim-1)) away from the interface
        (curv.cc:361-377)."""
        if c is None:
            c = self.solution[0]
        eps = self.epsilon_used
        c2 = 1 - c * c
        distance = torch.where(
            c2 > 1e-2, eps * torch.log((1 + c) / torch.clamp(1 - c, min=1e-30)), 0.0
        )
        corrected = 1.0 / (1.0 / kappa + distance / (self.mesh.dim - 1))
        return torch.where(kappa > 1e-4, corrected, kappa)

    def reinitialize(self, stab_steps: int, diff_steps: int = 0) -> None:
        """OKZ reinitialization (reinit.cc:256-363): `diff_steps` pure
        diffusion steps (3 more when the concentration left [-1.02, 1.02])
        and then `stab_steps` compression steps, stopping at an increment
        below 1e-6."""
        ts = self.time_stepping
        lo, hi = self.last_concentration_range
        actual_diff = diff_steps + (3 if (lo < -1.02 or hi > 1.02) else 0)
        if self._verbose():
            lead = "  " if ts.now() == ts.start() else " and "
            self._p(f"{lead}reinitialize (", end="")
        tags = self._reinit_chain(actual_diff, stab_steps)
        if self._verbose():
            self._p(" + ".join(tags) + ")")

    def _reinit_chain(self, actual_diff: int, stab_steps: int) -> list[str]:
        dtau_inv = self._dtau_inv()
        tags = []
        for tau in range(actual_diff + stab_steps):
            first = tau == actual_diff
            if first:
                self.compute_normal(True)
            diffuse_only = tau < actual_diff
            c, en, iters, update_norm = self._reinit_step(
                self.solution[0], self.normal_vector_field, first,
                self.evaluated_normal_q, dtau_inv, diffuse_only,
            )
            self.solution[0], self.evaluated_normal_q = c, en
            tags.append(("d" if diffuse_only else "") + str(iters))
            if update_norm < 1e-6:
                break
        return tags

    def _heaviside(self, c):
        """Log-transform of the tanh profile and the Peskin discrete
        heaviside, constant far field (level_set_okz.cc:479-540)."""
        par = self.parameters
        cutoff = np.tanh(2.0)
        eps = 1e-12
        c_cl = torch.clamp(c, -1 + eps, 1 - eps)
        distance = torch.where(
            c < -cutoff,
            -3.0,
            torch.where(c > cutoff, 3.0, torch.log((1 + c_cl) / (1 - c_cl))),
        )
        distance = distance * (par.epsilon * 2.0 / par.concentration_subdivisions)
        return _discrete_heaviside(distance)

    def compute_heaviside(self) -> None:
        self.heaviside = self._heaviside(self.solution[0])

    def compute_force(self) -> None:
        """Heaviside, curvature, the surface-tension force into
        navier_stokes.user_rhs (condensed) and the per-q-point density and
        viscosity into navier_stokes.coefficients."""
        self.compute_heaviside()
        self.compute_curvature()
        ns = self.navier_stokes
        h_force = (
            self.heaviside
            if getattr(self.parameters, "surface_tension_from_heaviside", True)
            else 0.5 * (self.solution[0] + 1.0)
        )
        user_u, rho_q, mu_q = self.ops.compute_force(h_force, self.solution[1])
        ns.user_rhs[0] = torch.stack(
            [ns.constraints_u[c].condense(user_u[c]) for c in range(self.mesh.dim)]
        )
        if rho_q is not None:
            ns.coefficients = Coefficients(rho_q.contiguous(), mu_q.contiguous(), None)

    # ------------------------------------------------------------------
    def _advance_concentration_and_reinit(self) -> None:
        """The advection step and reinitialize(n_reinit_steps), printed on
        one line."""
        par = self.parameters
        ts = self.time_stepping
        tw = TimeWeights.from_time_stepping(ts)
        lo, hi = self.last_concentration_range
        actual_diff = 3 if (lo < -1.02 or hi > 1.02) else 0
        inc, a_iters, rhs_norm = self._advect(
            self._u_fields(), tw, 0.05 * par.tol_nl_iteration, ts.old_step_size()
        )
        self.solution[0] = self.solution[0] + self.constraints_ls.distribute(inc)
        tags = self._reinit_chain(actual_diff, par.n_reinit_steps)
        if self._verbose():
            self._p(f"  Concentration advance: advect [{fmtg3(rhs_norm)}/{a_iters}]", end="")
            lead = "  " if ts.now() == ts.start() else " and "
            self._p(f"{lead}reinitialize (" + " + ".join(tags) + ")")

    def advance_time_step(self):
        """One two-phase step (level_set_base.cc:188-291); returns the
        Newton and Krylov iteration counts."""
        ns = self.navier_stokes
        self.init_time_advance()
        with ns.timer.section("LS advance concentration + reinit."):
            self._advance_concentration_and_reinit()
        with ns.timer.section("LS compute force."):
            self.compute_force()
            actual_res = ns.compute_initial_residual()
        return self._finish_time_step(actual_res)

    def _finish_time_step(self, actual_res: float):
        """Excessive-residual correction and the Newton solve
        (level_set_base.cc:260-291)."""
        ns = self.navier_stokes
        ts = self.time_stepping
        if (
            ts.step_no() > 3 + self.last_smoothing_step
            and ts.step_no() > 2 + self.last_refine_step
            and actual_res >= 2.0 * self.old_residual
        ):
            self._p("\n  Correct excessive residual: ", end="")
            self.reinitialize(self.parameters.n_reinit_steps, 10)
            self.compute_force()
            actual_res = ns.compute_initial_residual()
            self.last_smoothing_step = ts.step_no()
        self.old_residual = actual_res
        return ns.solve_nonlinear_system(actual_res)

    # ------------------------------------------------------------------
    def setup_problem(self, initial_velocity_fn, initial_distance_fn) -> None:
        super().setup_problem(initial_velocity_fn, initial_distance_fn)
        # initial reinitialization for imperfect profiles, and the heaviside
        # (level_set_base.cc:144-154)
        self.reinitialize(self.parameters.n_initial_reinit_steps)
        self.compute_heaviside()

    def get_time_stepping(self):
        return self.time_stepping


def _discrete_heaviside(x):
    """Integral of Peskin's sqrt-formed discrete delta
    (level_set_base.h:120-142), elementwise."""
    ax = -torch.abs(x)
    pi = np.pi

    def mid(v):  # -1 <= v <= 0
        return (
            1.0 / 8.0 * (3.0 * v + v * v)
            - 1.0 / 32.0 * (-1.0 - 2.0 * v)
            * torch.sqrt(torch.clamp(1.0 - 4.0 * v - 4.0 * v * v, min=0.0))
            + 1.0 / 16.0 * torch.arcsin(torch.clamp(np.sqrt(2.0) * (v + 0.5), -1, 1))
            + 15.0 / 32.0
            - pi / 64.0
        )

    def outer(v):  # -2 <= v < -1
        return (
            1.0 / 8.0 * (5.0 * v + v * v)
            + 1.0 / 32.0 * (-3.0 - 2.0 * v)
            * torch.sqrt(torch.clamp(-7.0 - 12.0 * v - 4.0 * v * v, min=0.0))
            - 1.0 / 16.0 * torch.arcsin(torch.clamp(np.sqrt(2.0) * (v + 1.5), -1, 1))
            + 23.0 / 32.0
            - pi / 64.0
        )

    neg_val = torch.where(ax < -2.0, 0.0, torch.where(ax < -1.0, outer(ax), mid(ax)))
    return torch.where(x > 0, 1.0 - neg_val, neg_val)


def fmtg3(x: float) -> str:
    s = f"{x:.3g}"
    if "e" in s:
        mant, ex = s.split("e")
        return f"{mant}e{int(ex):+03d}"
    return s
