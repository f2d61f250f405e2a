"""Single-phase Navier-Stokes solver on the uniform lattice.

PyTorch counterpart of ``adaflo_tpu/solvers/navier_stokes_solver.py`` (the
reference's NavierStokes<dim>, source/navier_stokes.cc), coupled implicit
Newton branch: owns the (u, p) Taylor-Hood spaces, the boundary-condition
machinery, the Newton loop with extrapolated initial guesses and
preconditioner-staleness heuristics (cc:833-1159) and the two-stage linear
solve (cheap preconditioner first, then inner solves, cc:559-653).

Host Python drives the time steps, the Newton loop and the Krylov loops and
prints the residual tables; the operators run as tensor operations on the
solver's device, with the coupled mat-vec in the CUDA kernel of
ops/coupled_matvec.py. The solver runs on the card unless the caller passes
device="cpu".

Ported: structured lattices with Dirichlet / no-slip velocity boundaries,
symmetry boundaries (the normal component constrained), periodic axes (the
lattice wraps, as in the JAX package) and a pressure-fix point,
time-dependent incompressible flow, coupled implicit Newton, with constant
or per-q-point (two-phase) density and viscosity.
Everything else raises NotImplementedError with the ROADMAP.md queue that
brings it.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from adaflo_tpu_torch.device import resolve_device
from adaflo_tpu_torch.fe.constraints import Constraints
from adaflo_tpu_torch.fe.space import ScalarSpace
from adaflo_tpu_torch.flow_base import FlowBaseAlgorithm
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.ops.navier_stokes import (
    Coefficients,
    NavierStokesOperator,
    TimeWeights,
)
from adaflo_tpu_torch.parameters import (
    FlowParameters,
    Linearization,
    PhysicalType,
    VelocityPreconditioner,
)
from adaflo_tpu_torch.solvers.krylov import fgmres
from adaflo_tpu_torch.solvers.preconditioner import NavierStokesPreconditioner, PrecState
from adaflo_tpu_torch.time_stepping import TimeStepping
from adaflo_tpu_torch.utils.timer import Statistics, TimerOutput, profiler_range


class ExcNavierStokesNoConvergence(Exception):
    pass


class NavierStokes(FlowBaseAlgorithm):
    def __init__(
        self,
        parameters: FlowParameters,
        mesh: StructuredMesh,
        out=None,
        device=None,
        dtype: torch.dtype = torch.float64,
    ) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.parameters = parameters
        self.mesh = mesh
        if not isinstance(mesh, StructuredMesh):
            raise NotImplementedError(
                "only structured lattices are ported (ROADMAP.md queue 1, "
                "items 12 and 15)"
            )
        if parameters.linearization != Linearization.coupled_implicit_newton:
            raise NotImplementedError(
                f"linearization '{parameters.linearization.value}' is not "
                "ported (ROADMAP.md queue 1, item 9c)"
            )
        if parameters.physical_type != PhysicalType.incompressible:
            raise NotImplementedError(
                f"physical type '{parameters.physical_type.value}' is not "
                "ported (ROADMAP.md queue 1, item 9c)"
            )
        self.time_stepping = TimeStepping(parameters)
        self.out = out
        self.dim = mesh.dim
        self.system_is_setup = False
        # preconditioner bookkeeping (navier_stokes.h / cc:833-971)
        self.update_preconditioner = True
        self.update_preconditioner_frequency = 0
        self.n_iterations_last_prec_update = 0
        self.time_step_last_prec_update = 0
        self.user_rhs_u = None
        self.user_rhs_p = None
        self.coefficients = Coefficients()
        self.timer = TimerOutput()
        self.statistics = Statistics()

    def _p(self, *args, **kw):
        print(*args, **kw, file=self.out or sys.stdout)

    # ------------------------------------------------------------------
    def setup_problem(self, initial_velocity_fn=None) -> None:
        """Refine, make the periodic axes wrap, build spaces, constraints,
        operator and preconditioner, and set the initial velocity from
        `initial_velocity_fn(coords, t)` where one is given."""
        par = self.parameters
        bd = self.boundary
        if bd.normal_flux or bd.open_conditions_p:
            raise NotImplementedError(
                "normal-flux and open boundaries are not ported "
                "(ROADMAP.md queue 1, item 9a)"
            )
        if par.global_refinements < 15:
            self.mesh.refine_global(par.global_refinements)
        for axis in sorted(bd.periodic_axes):
            self.mesh.set_periodic(axis)
        self._setup_discretization()
        self._allocate_vectors(initial_velocity_fn)
        self.system_is_setup = True
        self._prec_state: Optional[PrecState] = None
        self._last_lin = None

    def _setup_discretization(self) -> None:
        par = self.parameters
        self.u_space = ScalarSpace(self.mesh, par.velocity_degree)
        self.p_space = ScalarSpace(self.mesh, par.pressure_degree)
        self._build_constraints()
        self.operator = NavierStokesOperator(
            par,
            self.u_space,
            self.p_space,
            self.constraints_u,
            self.constraints_p,
            dtype=self.dtype,
            device=self.device,
        )
        if self.boundary.pressure_fix:
            self.operator.enable_pressure_fix()
        self.preconditioner = NavierStokesPreconditioner(
            par, self.operator, self.constraints_schur
        )

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _allocate_vectors(self, initial_velocity_fn=None) -> None:
        n_u = self.u_space.n_dofs_padded
        n_p = self.p_space.n_dofs_padded
        zu, zp = self._zeros(self.dim, n_u), self._zeros(n_p)
        self.solution = [zu, zp]
        self.solution_old = [zu, zp]
        self.solution_old_old = [zu, zp]
        self.solution_update = [zu, zp]
        self.const_rhs = [zu, zp]
        self.user_rhs = [zu, zp]
        if initial_velocity_fn is not None and not self.time_stepping.at_end():
            vals = np.asarray(
                initial_velocity_fn(self.u_space.node_coords, self.time_stepping.now())
            )
            u = zu.clone()
            u[:, : vals.shape[1]] = torch.as_tensor(vals, dtype=self.dtype, device=self.device)
            self.solution[0] = u

    def _build_constraints(self) -> None:
        """Dirichlet and no-slip constrain all velocity components, a
        symmetry side only the component normal to it
        (navier_stokes.cc:228-360); the Schur-complement constraints hold
        the pressure-fix dof (ns_prec.cc:1087-1186)."""
        bd = self.boundary
        u_space, p_space = self.u_space, self.p_space
        cu = [Constraints(u_space.n_dofs) for _ in range(self.dim)]
        dirichlet_ids = set(bd.dirichlet_conditions_u) | bd.no_slip
        for bid in dirichlet_ids:
            dofs = u_space.boundary_dofs(bid)
            for c in range(self.dim):
                cu[c].add_dirichlet(dofs)
        for bid in sorted(bd.symmetry):
            for axis, _, face_dofs in u_space.boundary_faces(bid):
                cu[axis].add_dirichlet(np.unique(face_dofs))
        for c in cu:
            c.close()
        self.constraints_u = cu
        # symmetry dofs that no Dirichlet function covers: their constrained
        # component is written to zero with the boundary values
        covered = (
            np.unique(np.concatenate([u_space.boundary_dofs(b) for b in dirichlet_ids]))
            if dirichlet_ids
            else np.empty(0, dtype=np.int64)
        )
        self._zero_dofs_u = [
            np.setdiff1d(con.dirichlet_dofs, covered) for con in cu
        ]
        cp = Constraints(p_space.n_dofs)
        cp.close()
        self.constraints_p = cp
        cs = Constraints(p_space.n_dofs)
        for bid in bd.pressure_fix:
            dofs = p_space.boundary_dofs(bid)
            if len(dofs):
                cs.add_dirichlet(dofs[:1])
        cs.close()
        self.constraints_schur = cs

    # ------------------------------------------------------------------
    @property
    def n_dofs(self):
        return (self.dim * self.u_space.n_dofs, self.p_space.n_dofs)

    def print_n_dofs(self) -> None:
        nu, npp = self.n_dofs
        self._p(f" Number of active cells: {self.mesh.n_cells}.")
        self._p(
            f" Number of degrees of freedom (velocity/pressure): "
            f"{nu + npp} ({nu} + {npp})."
        )
        # the reference prints the LAST cell's diameter (navier_stokes.cc:174)
        self._p(
            f" Approximate size last cell: "
            f"{self.mesh.cell_diameter / np.sqrt(self.dim):.6g}"
        )

    # ------------------------------------------------------------------
    def apply_boundary_conditions(self) -> None:
        """Write Dirichlet values into the solution at the current time
        (navier_stokes.cc:1214-1318)."""
        bd = self.boundary
        t = self.time_stepping.now()
        u = self.solution[0].clone()
        for bid, fn in bd.dirichlet_conditions_u.items():
            dofs = self.u_space.boundary_dofs(bid)
            if len(dofs) == 0:
                continue
            vals = np.asarray(fn(self.u_space.node_coords[dofs], t))
            u[:, torch.as_tensor(dofs, device=self.device)] = torch.as_tensor(
                vals, dtype=self.dtype, device=self.device
            )
        for bid in bd.no_slip:
            dofs = self.u_space.boundary_dofs(bid)
            if len(dofs):
                u[:, torch.as_tensor(dofs, device=self.device)] = 0.0
        for c, dofs in enumerate(self._zero_dofs_u):
            if len(dofs):
                u[c, torch.as_tensor(dofs, device=self.device)] = 0.0
        self.solution[0] = u
        self.const_rhs = [
            self._zeros(self.dim, self.u_space.n_dofs_padded),
            self._zeros(self.p_space.n_dofs_padded),
        ]

    def compute_initial_stokes_field(self) -> None:
        """Divergence-free initial velocity when the boundary conditions are
        inconsistent with u = 0 (navier_stokes.cc:1162-1210): with zero
        boundary data there is nothing to solve."""
        self.apply_boundary_conditions()
        if float(torch.linalg.vector_norm(self.solution[0])) == 0:
            return
        raise NotImplementedError(
            "the initial Stokes solve needs the Stokes physical type, which is "
            "not ported (ROADMAP.md queue 1, item 9c)"
        )

    # ------------------------------------------------------------------
    def init_time_advance(self, print_time_info: bool = True) -> None:
        assert self.system_is_setup, "System has not yet been set up!"
        ts = self.time_stepping
        ts.next()
        f1, f2 = ts.extrapolation_factors
        for b in range(2):
            cur, old = self.solution[b], self.solution_old[b]
            self.solution_old_old[b] = old
            self.solution_old[b] = cur
            self.solution[b] = f1 * cur + f2 * old
        if print_time_info and self.parameters.output_verbosity > 0:
            self._p(
                f"\nTime step #{ts.step_no()}, advancing from t_n-1 = "
                f"{fmt_g(ts.previous())} to t = {fmt_g(ts.now())} "
                f"(dt = {fmt_g(ts.step_size())}). "
            )
        with self.timer.section("NS apply boundary conditions."):
            self.apply_boundary_conditions()

    def advance_time_step(self):
        self.init_time_advance()
        return self.evaluate_time_step()

    def evaluate_time_step(self):
        initial_residual = self.compute_initial_residual()
        try:
            return self.solve_nonlinear_system(initial_residual)
        except ExcNavierStokesNoConvergence:
            self._p("Warning: nonlinear iteration did not converge!")
            return (0, 0)

    # ------------------------------------------------------------------
    def _residual(self, u, p):
        """(ru, rp, lin, |ru|, |rp|) at the state (u, p): rhs = const + user
        - A(u, p) with the pressure mean projected out."""
        op = self.operator
        tw = TimeWeights.from_time_stepping(self.time_stepping)
        au, ap, lin = op.residual_assemble(
            u, p, self.solution_old[0], self.solution_old_old[0], tw,
            self.coefficients,
        )
        ru = self.const_rhs[0] + self.user_rhs[0] - au
        rp = op.apply_pressure_average_projection(
            self.const_rhs[1] + self.user_rhs[1] - ap
        )
        res_u, res_p = torch.stack(
            [torch.sqrt(torch.sum(ru * ru)), torch.sqrt(torch.sum(rp * rp))]
        ).tolist()
        return ru, rp, lin, res_u, res_p

    def compute_residual(self, precomputed=None) -> float:
        if precomputed is None:
            precomputed = self._residual(self.solution[0], self.solution[1])
        ru, rp, lin, res_u, res_p = precomputed
        self.system_rhs = [ru, rp]
        self._last_lin = lin
        res = float(np.sqrt(res_u**2 + res_p**2))
        v = self.parameters.output_verbosity
        if v == 1:
            self._p(f"[{fmt_g(res)}", end="")
        elif v == 2:
            self._p(f"   {res:<12.3e} ", end="")
        elif v == 3:
            self._p(f"   {res_u:<11.3e} {res_p:<12.3e} ", end="")
        return res

    def compute_initial_residual(self, precomputed=None) -> float:
        v = self.parameters.output_verbosity
        if v == 1:
            self._p("  Residual/iterations: ", end="")
        elif v == 2:
            self._p(
                "\n   Nonlin Res     Prec Upd     Increment   Lin Iter     Lin Res"
                "\n   ____________________________________________________________"
            )
        elif v == 3:
            self._p(
                "\n   NL Resid u  NL Resid p     Prec Upd     Increm u   Increm p"
                "   Lin Iter     Lin Res"
                "\n   _______________________________________________________________"
                "___________________"
            )
        return self.compute_residual(precomputed)

    # ------------------------------------------------------------------
    @profiler_range
    def build_preconditioner(self) -> None:
        tw = TimeWeights.from_time_stepping(self.time_stepping)
        self._prec_state = self.preconditioner.compute(
            tw, self._last_lin, self.coefficients
        )
        # convection-dominated velocity blocks defeat the real-interval
        # Chebyshev; switch its apply to Jacobi-GMRES
        self._u_robust = self._prec_state.u_cheb_growth > 1.0
        v = self.parameters.output_verbosity
        # label by the user's preconditioner selection, with the reference's
        # spelling (navier_stokes.cc:536-547)
        label = {
            VelocityPreconditioner.u_ilu: "ILU ",
            VelocityPreconditioner.u_ilu_scalar: "ILUs",
            VelocityPreconditioner.u_amg: "AMG ",
            VelocityPreconditioner.u_amg_linear: "AMGl",
        }[self.parameters.precondition_velocity]
        if v == 1:
            self._p(f"/{label.strip()}", end="")
        elif v >= 2:
            self._p(f"    {label}   ", end="")

    @profiler_range
    def _linear_solve(self, rhs_u, rhs_p, tol: float, do_inner: bool, max_iter: int):
        """One FGMRES stage on the flat [u | p] vector, preconditioned by the
        block preconditioner frozen in the preconditioner state."""
        op = self.operator
        prec = self.preconditioner
        st = self._prec_state
        tw = TimeWeights.from_time_stepping(self.time_stepping)
        lin = self._last_lin
        u_robust = getattr(self, "_u_robust", False)
        shape_u = rhs_u.shape
        n_u = rhs_u.numel()

        def split(x):
            return x[:n_u].view(shape_u), x[n_u:]

        def A(x):
            # the system matrix linearizes around the CURRENT iterate while
            # the preconditioner keeps its frozen copy in `st`
            # (navier_stokes_matrix.cc:1144-1152); its variable coefficients
            # are those the preconditioner was built with, as in the JAX
            # package's solve
            ru, rp = op.vmult(*split(x), tw, lin, st.coeffs)
            return torch.cat([ru.reshape(-1), rp])

        def M(r):
            du, dp = prec.apply(st, split(r), tw, do_inner, u_robust)
            return torch.cat([du.reshape(-1), dp])

        b = torch.cat([rhs_u.reshape(-1), rhs_p])
        res = fgmres(A, b, None, tol, max_iter, restart=50, M=M)
        du, dp = split(res.x)
        return du, dp, res.iterations, res.residual, res.converged

    def solve_system(self, linear_tolerance: float):
        """Two-stage linear solve (navier_stokes.cc:559-653), the Newton
        update and the fresh nonlinear residual at the new iterate."""
        t0 = time.perf_counter()
        par = self.parameters
        rhs_u, rhs_p = self.system_rhs
        cheap_iters = min(par.iterations_before_inner_solvers, par.max_lin_iteration)
        stage2 = max(
            par.max_lin_iteration - par.iterations_before_inner_solvers, 0
        ) or par.max_lin_iteration
        du, dp, iters, residual, conv = self._linear_solve(
            rhs_u, rhs_p, linear_tolerance, False, cheap_iters
        )
        if not conv:
            # second stage with inner solves (navier_stokes.cc:588-641)
            du, dp, it2, residual, conv = self._linear_solve(
                rhs_u, rhs_p, linear_tolerance, True, stage2
            )
            iters += it2
        du = torch.stack(
            [self.constraints_u[c].distribute(du[c]) for c in range(self.dim)]
        )
        dp = self.constraints_p.distribute(dp)
        self.solution_update = [du, dp]
        u_new, p_new = self.solution[0] + du, self.solution[1] + dp
        self._solved_residual = self._residual(u_new, p_new)
        self.solution[0], self.solution[1] = u_new, p_new
        self._solved_upd_norms = tuple(
            torch.stack(
                [torch.sqrt(torch.sum(du * du)), torch.sqrt(torch.sum(dp * dp))]
            ).tolist()
        )
        self.statistics.add("lin solver", time.perf_counter() - t0)
        self.statistics.add("mat-vec", 0.0, max(iters, 1))
        return iters, residual

    # ------------------------------------------------------------------
    def solve_nonlinear_system(self, initial_residual: float):
        with self.timer.section("NS solve system."):
            return self._solve_nonlinear_system(initial_residual)

    def _solve_nonlinear_system(self, initial_residual: float):
        par = self.parameters
        ts = self.time_stepping
        step = 0
        n_tot_iterations = 0
        premature_update = False
        res = initial_residual
        v = par.output_verbosity
        while step < par.max_nl_iteration:
            # linear tolerance policy (cc:851-868)
            linear_tolerance = par.tol_lin_iteration
            if par.rel_lin_iteration:
                if res * par.tol_lin_iteration < 0.5 * par.tol_nl_iteration:
                    linear_tolerance = 0.5 * par.tol_nl_iteration
                else:
                    linear_tolerance = min(
                        par.tol_lin_iteration * res, par.tol_lin_iteration
                    )
            if step == 0 and self.update_preconditioner:
                self.build_preconditioner()
            elif (
                not premature_update
                and ts.step_no() > 1
                and n_tot_iterations > 1.5 * self.n_iterations_last_prec_update
            ):
                self.build_preconditioner()
                premature_update = True
            elif v >= 2:
                self._p("    ---    ", end="")

            iters, lin_res = self.solve_system(linear_tolerance)
            n_tot_iterations += iters
            iu, ip = self._solved_upd_norms
            if v == 1:
                self._p(f"/{iters}] ", end="")
            elif v == 2:
                norm = float(np.sqrt(iu**2 + ip**2))
                self._p(f"    {norm:<5.2e}     {iters:4d}       {lin_res:<5.2e}")
            elif v == 3:
                self._p(
                    f"    {iu:<5.2e}   {ip:<5.2e}    {iters:4d}       {lin_res:<5.2e}"
                )
            step += 1
            res = self.compute_residual(precomputed=self._solved_residual)
            self._solved_residual = None
            if res < par.tol_nl_iteration:
                if v == 1:
                    self._p("/conv.]")
                elif v >= 2:
                    self._p(" converged.\n")
                break
        return self._newton_tail(step, n_tot_iterations, premature_update)

    def _newton_tail(self, step: int, n_tot_iterations: int, premature_update: bool):
        """Preconditioner refresh policy (navier_stokes.cc:941-971) and the
        pressure fix shift."""
        par = self.parameters
        ts = self.time_stepping
        if (
            self.update_preconditioner_frequency > 0
            and ts.step_no() % (50 * self.update_preconditioner_frequency) == 0
        ):
            self.update_preconditioner_frequency = 0
        if self.update_preconditioner:
            self.n_iterations_last_prec_update = n_tot_iterations
            self.time_step_last_prec_update = ts.step_no()
            self.update_preconditioner = False
        if n_tot_iterations > 1.2 * self.n_iterations_last_prec_update:
            if (
                premature_update
                or n_tot_iterations > 2 * self.n_iterations_last_prec_update
            ):
                self.update_preconditioner_frequency = (
                    ts.step_no() - self.time_step_last_prec_update
                )
            self.update_preconditioner = True
        if (
            self.time_step_last_prec_update < 3 and ts.step_no() > 14
        ) or ts.step_no() < 2:
            self.update_preconditioner = True
        if (
            not self.update_preconditioner
            and not premature_update
            and self.update_preconditioner_frequency > 0
            and ts.step_no() + 1 - self.time_step_last_prec_update
            >= self.update_preconditioner_frequency
        ):
            self.update_preconditioner = True
        if step == par.max_nl_iteration and par.output_verbosity == 1:
            self._p("]")
        self._apply_pressure_fix_shift()
        return (step, n_tot_iterations)

    def _apply_pressure_fix_shift(self) -> None:
        """Shift the pressure so the first dof on the pressure-fix boundary
        matches the prescribed value (navier_stokes.cc:984-1044)."""
        for bid, fn in self.boundary.pressure_fix.items():
            dofs = self.p_space.boundary_dofs(bid)
            dofs = dofs[~self.constraints_p.is_constrained[dofs]]
            if len(dofs) == 0:
                continue
            dof = int(dofs[0])
            x = self.p_space.node_coords[dof : dof + 1]
            target = (
                float(np.asarray(fn(x, self.time_stepping.now()))[0])
                if fn is not None
                else 0.0
            )
            shift = target - float(self.solution[1][dof])
            self.solution[1] = self.operator.apply_pressure_shift(
                shift, self.solution[1]
            )
            return


def fmt_g(x: float) -> str:
    """C++ ostream precision(3) general formatting."""
    s = f"{x:.3g}"
    if "e" in s:
        mant, ex = s.split("e")
        return f"{mant}e{int(ex):+03d}"
    return s
