"""Shared two-phase infrastructure on the uniform lattice.

PyTorch counterpart of ``adaflo_tpu/twophase/base.py`` (the reference's
TwoPhaseBaseAlgorithm, source/two_phase_base.cc): owns the Navier-Stokes
solver and the FE_Q_iso_Q1 concentration space, the concentration
extrapolation, the adaptive time step from the CFL and capillary limits
(cc:596-617), the maximal velocity and concentration range, and the bubble
statistics: in 2D with the explicit sub-cell reconstruction of the zero
contour (cc:621-968), in 3D with the smeared heaviside/delta form
(cc:972-1091). The statistics are host diagnostics: the fields are evaluated
on the solver's device and reduced on the host.

Only the lattice branch is ported: forest, mapped, extruded and simplex
meshes raise NotImplementedError (ROADMAP.md queue 1, items 12b and 15),
fluid-type (inflow) concentration boundaries item 13 (with the phase field,
whose Poiseuille driver sets them) and VTU output item 17.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from adaflo_tpu_torch.fe.basis import equidistant_points, iterated_gauss_quadrature
from adaflo_tpu_torch.fe.constraints import Constraints
from adaflo_tpu_torch.fe.space import ScalarSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.ops.lattice import LatticeOps
from adaflo_tpu_torch.ops.tensor import CellEvaluator
from adaflo_tpu_torch.parameters import FlowParameters
from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes, fmt_g


class TwoPhaseBaseAlgorithm:
    def __init__(
        self,
        parameters: FlowParameters,
        mesh: StructuredMesh,
        concentration_support: str = "iso_q1",
        out=None,
        device=None,
    ) -> None:
        self.parameters = parameters
        self.mesh = mesh
        self.out = out
        self.navier_stokes = NavierStokes(parameters, mesh, out=out, device=device)
        self.device = self.navier_stokes.device
        self.dtype = self.navier_stokes.dtype
        self.boundary = self.navier_stokes.boundary
        self.time_stepping = self.navier_stokes.time_stepping
        self.concentration_support = concentration_support
        self.last_concentration_range = (-1.0, 1.0)
        self.global_omega_diameter = 0.0
        self.last_refine_step = 0

    # -- the BC setter API lives on the NS solver
    def __getattr__(self, name):
        if name.startswith("set_") or name == "fix_pressure_constant":
            return getattr(self.navier_stokes, name)
        raise AttributeError(name)

    def _p(self, *a, **k):
        print(*a, **k, file=self.out or sys.stdout)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    def setup_problem(self, initial_velocity_fn, initial_distance_fn) -> None:
        par = self.parameters
        mesh = self.mesh
        self.global_omega_diameter = float(np.linalg.norm(mesh.lengths))
        if par.global_refinements < 15:
            mesh.refine_global(par.global_refinements)
        # the NS solver must not refine again
        saved = par.global_refinements
        par.global_refinements = 0
        try:
            self.navier_stokes.setup_problem(initial_velocity_fn)
        finally:
            par.global_refinements = saved
        self._setup_ls_discretization()
        self._apply_initial_distance(initial_distance_fn)
        # divergence-free initial velocity if starting from zero
        if float(torch.linalg.vector_norm(self.navier_stokes.solution[0])) == 0:
            self.navier_stokes.compute_initial_stokes_field()

    def _setup_ls_discretization(self) -> None:
        """Concentration space, constraints, epsilon and vectors; prints the
        dof/mesh-size block (two_phase_base.cc:229-304)."""
        par = self.parameters
        mesh = self.mesh
        self.ls_space = ScalarSpace(
            mesh, par.concentration_subdivisions, self.concentration_support
        )
        self.lat_ls = LatticeOps.for_space(self.ls_space)
        self._build_ls_constraints()
        self.print_n_dofs()
        # epsilon for interface smoothing (two_phase_base.cc:280-291)
        self.cell_diameter = float(np.max(mesh.h))
        self.minimal_edge_length = float(np.min(mesh.h))
        self._p(
            "Mesh size (largest/smallest element length at finest level): "
            f"{self.cell_diameter:.6g} / {self.minimal_edge_length:.6g}"
        )
        self.epsilon_used = par.epsilon / par.concentration_subdivisions * self.cell_diameter

        n = self.ls_space.n_dofs_padded
        self.solution = [self._zeros(n), self._zeros(n)]  # (concentration, curvature)
        self.solution_old = [self._zeros(n), self._zeros(n)]
        self.solution_old_old = [self._zeros(n), self._zeros(n)]
        self.heaviside = self._zeros(n)
        self.normal_vector_field = self._zeros(mesh.dim, n)
        self.initialize_data_structures()

    def _apply_initial_distance(self, initial_distance_fn) -> None:
        n = self.ls_space.n_dofs_padded
        dist = np.asarray(initial_distance_fn(self.ls_space.node_coords, 0.0))
        c0 = self._zeros(n)
        c0[: len(dist)] = torch.as_tensor(dist, dtype=self.dtype, device=self.device)
        self.solution[0] = self.transform_distance_function(c0)

    def _build_ls_constraints(self) -> None:
        """Concentration, normal and curvature constraints
        (two_phase_base.cc:200-224): none on the lattice. Inflow
        (fluid-type) concentration values come with the phase field, whose
        Poiseuille driver is the one that sets them."""
        if self.boundary.fluid_type:
            raise NotImplementedError(
                "fluid-type (inflow) concentration boundaries are not ported "
                "(ROADMAP.md queue 1, item 13)"
            )
        n = self.ls_space.n_dofs
        self.constraints_ls, self.constraints_normals, self.constraints_curvature = (
            Constraints(n) for _ in range(3)
        )
        for con in (self.constraints_ls, self.constraints_normals, self.constraints_curvature):
            con.close()

    def initialize_data_structures(self) -> None:
        """Overridden by concrete solvers (OKZ adds its operators)."""

    def transform_distance_function(self, vector):
        raise NotImplementedError

    def print_n_dofs(self) -> None:
        nu, npp = self.navier_stokes.n_dofs
        self._p("")
        self._p(f"Number of active cells: {self.mesh.n_cells}.")
        self._p(f"Number of Navier-Stokes degrees of freedom: {nu + npp} ({nu} + {npp}).")
        self._p(f"Number of level set degrees of freedom: {self.ls_space.n_dofs}.")

    # ------------------------------------------------------------------
    def init_time_advance(self) -> None:
        """NS extrapolation and the concentration extrapolation with the
        step-size ratio (two_phase_base.cc:441-475)."""
        self.navier_stokes.init_time_advance(self.parameters.output_verbosity > 0)
        ts = self.time_stepping
        k, ko = ts.step_size(), ts.old_step_size()
        sol, old = self.solution, self.solution_old
        if ko > 0:
            a, b = (k + ko) / ko, -k / ko
            upd = [a * s + b * o for s, o in zip(sol, old)]
        else:
            upd = list(sol)
        self.solution_old_old = list(old)
        self.solution_old = list(sol)
        self.solution = upd
        if self.parameters.output_verbosity == 0:
            freq = self.parameters.output_frequency
            time = ts.now()
            position = int(time * 1.0000000001 / freq)
            if (time - position * freq) < ts.step_size() * 0.95:
                self._p(f"{fmt_g(time)} ", end="", flush=True)

    # ------------------------------------------------------------------
    def _velocity_cells(self):
        """(E, dim, n_loc_u) cell dofs of the current velocity."""
        ns = self.navier_stokes
        u = ns.solution[0]
        lat_u = ns.operator.lat_u
        return torch.stack([lat_u.gather(u[d]) for d in range(self.mesh.dim)], dim=1)

    def _evaluator(self, basis, quad):
        return CellEvaluator(
            self.mesh.dim, basis, quad, self.mesh.h, dtype=self.dtype, device=self.device
        )

    def get_maximal_velocity(self) -> float:
        """Max |u| over an equidistant point lattice per cell
        (two_phase_base.cc:479-509)."""
        pts = equidistant_points(self.parameters.velocity_degree + 2)
        ev = self._evaluator(self.navier_stokes.u_space.basis, (pts, np.zeros_like(pts)))
        vals = ev.values(self._velocity_cells())
        return float(torch.sqrt((vals * vals).sum(dim=1)).max())

    def get_concentration_range(self) -> tuple[float, float]:
        """Range over an equidistant lattice (two_phase_base.cc:513-545)."""
        pts = equidistant_points(self.ls_space.degree + 3)
        ev = self._evaluator(self.ls_space.basis, (pts, np.zeros_like(pts)))
        vals = ev.values(self.lat_ls.gather(self.solution[0]))
        lo, hi = torch.stack([vals.min(), vals.max()]).tolist()
        self.last_concentration_range = (float(lo), float(hi))
        return self.last_concentration_range

    def set_adaptive_time_step(self, norm_velocity: float) -> None:
        """CFL + capillary limit (two_phase_base.cc:596-617; the reference
        uses the viscosity pair in the capillary term)."""
        par = self.parameters
        rho_2 = par.viscosity_diff + par.viscosity
        h = self.minimal_edge_length
        denom = 1.0 / (par.time_stepping_cfl * h / max(norm_velocity, 1e-300)) + 1.0 / (
            par.time_stepping_coef2 * np.sqrt(rho_2 / par.surface_tension) * h**1.5
        )
        self.time_stepping.set_desired_time_step(1.0 / denom)

    # ------------------------------------------------------------------
    def compute_bubble_statistics(self, sub_refinements: Optional[int] = None) -> list[float]:
        """2D bubble diagnostics with the explicit sub-cell interface
        reconstruction (two_phase_base.cc:621-968): area, perimeter,
        circularity, mean velocity, centre of mass; also sets the adaptive
        time step and prints the diagnostics block. 3D: the smeared form."""
        if self.mesh.dim == 3:
            return self._compute_bubble_statistics_3d()
        par = self.parameters
        ns = self.navier_stokes
        sub = (
            par.velocity_degree + 3 if sub_refinements in (None, 0) else sub_refinements
        ) or par.velocity_degree + 3

        # c and u on the (sub+1)^2 equidistant lattice of every cell
        pts = equidistant_points(sub + 1)
        ev_c = self._evaluator(self.ls_space.basis, (pts, np.zeros_like(pts)))
        ev_u = self._evaluator(ns.u_space.basis, (pts, np.zeros_like(pts)))
        c_cells = self.lat_ls.gather(self.solution[0])
        u_cells = self._velocity_cells()
        c_vals = ev_c.values(c_cells).cpu().numpy()  # (E, (sub+1)^2)
        u_vals = ev_u.values(u_cells).cpu().numpy()  # (E, 2, (sub+1)^2)
        qc = ev_c.quad_coords(self.mesh)  # (E, (sub+1)^2, 2)

        # interface cells: a sign change among the concentration dofs
        c_dof_vals = c_cells.cpu().numpy()
        crosses = (c_dof_vals * c_dof_vals[:, :1] <= 0).any(axis=1)

        area = 0.0
        perimeter = 0.0
        com = np.zeros(2)
        vel = np.zeros(2)

        # interior cells: plain Gauss quadrature
        inside = (~crosses) & (c_dof_vals[:, 0] > 0)
        if inside.any():
            evg = self._evaluator(ns.u_space.basis, par.velocity_degree)
            qg = evg.quad_coords(self.mesh)[inside]
            sel = torch.as_tensor(np.flatnonzero(inside), device=self.device)
            ug = evg.values(u_cells[sel]).cpu().numpy()
            jxw = evg.jxw_np
            area += jxw.sum() * inside.sum()
            com += np.einsum("eqd,q->d", qg, jxw)
            vel += np.einsum("edq,q->d", ug, jxw)

        # interface cells: subdivided patches
        idx = np.flatnonzero(crosses)
        if len(idx):
            n1 = sub + 1
            cv = c_vals[idx].reshape(-1, n1, n1) + 1e-22
            uv = u_vals[idx].reshape(-1, 2, n1, n1)
            qq = qc[idx].reshape(-1, n1, n1, 2)
            w4 = float(np.prod(self.mesh.h)) / (sub * sub) / 4.0

            def corners(a):
                return (a[:, :-1, :-1], a[:, :-1, 1:], a[:, 1:, :-1], a[:, 1:, 1:])

            c00, c01, c10, c11 = (x.reshape(-1) for x in corners(cv))
            p00, p01, p10, p11 = (x.reshape(-1, 2) for x in corners(qq))
            v00, v01, v10, v11 = (
                np.moveaxis(x.reshape(len(idx), 2, -1), 1, 2).reshape(-1, 2)
                for x in (uv[:, :, :-1, :-1], uv[:, :, :-1, 1:], uv[:, :, 1:, :-1], uv[:, :, 1:, 1:])
            )
            a_frac, per = _patch_area_perimeter(c00, c01, c10, c11, p00, p01, p10, p11)
            perimeter += per.sum()
            w = a_frac[:, None] * w4
            area += 4.0 * (a_frac * w4).sum()
            com += (w * (p00 + p01 + p10 + p11)).sum(axis=0)
            vel += (w * (v00 + v01 + v10 + v11)).sum(axis=0)

        norm_v = np.linalg.norm(vel)
        self.set_adaptive_time_step(norm_v / area)
        circularity = 2.0 * np.sqrt(area * np.pi) / perimeter if perimeter > 0 else 0.0

        if par.output_verbosity > 0:
            self._p(f"  Degree of circularity: {fmt8(circularity)}")
            vstr = "  ".join(
                fmt8(0.0 if abs(vel[d]) < 1e-7 * norm_v else vel[d] / area) for d in range(2)
            )
            self._p(f"  Mean bubble velocity: {vstr}  ")
            cstr = "  ".join(
                fmt8(0.0 if abs(com[d]) < 1e-7 * self.global_omega_diameter else com[d] / area)
                for d in range(2)
            )
            self._p(f"  Position of the center of mass:  {cstr}  ")
            lo, hi = self.get_concentration_range()
            self._p(f"  Range of level set values: {fmt8(lo)} / {fmt8(hi)}")

        data = [self.time_stepping.now(), area, perimeter, circularity]
        data += [vel[d] / area for d in range(2)]
        data += [com[d] / area for d in range(2)]
        return data

    def _compute_bubble_statistics_3d(self) -> list[float]:
        """Smeared heaviside-delta 3D bubble diagnostics
        (two_phase_base.cc:972-1091): volume = int H, surface area =
        0.5 int |grad H|, velocity and centre weighted by H, sphericity."""
        par = self.parameters
        ns = self.navier_stokes
        q_ls = iterated_gauss_quadrature(par.concentration_subdivisions, 2)
        ev_c = self._evaluator(self.ls_space.basis, q_ls)
        ev_u = self._evaluator(ns.u_space.basis, q_ls)
        hv = self.lat_ls.gather(self.heaviside)
        H = ev_c.values(hv)  # (E, n_q)
        # delta = grad H at the quadrature points (the reference's
        # evaluate_heaviside_function, two_phase_base.cc:1016-1023)
        delta = ev_c.gradients(hv)  # (E, 3, n_q)
        uv = ev_u.values(self._velocity_cells())  # (E, 3, n_q)
        qp = torch.as_tensor(ev_c.quad_coords(self.mesh), dtype=self.dtype, device=self.device)
        jxw = ev_c.jxw
        HJ = H * jxw
        sums = torch.cat([
            HJ.sum().reshape(1),
            (0.5 * torch.sqrt((delta * delta).sum(dim=1)) * jxw).sum().reshape(1),
            torch.einsum("edq,eq->d", uv, HJ),
            torch.einsum("eqd,eq->d", qp, HJ),
        ]).tolist()
        volume, area = sums[0], sums[1]
        vel, com = np.asarray(sums[2:5]), np.asarray(sums[5:8])
        norm_v = float(np.linalg.norm(vel))
        self.set_adaptive_time_step(norm_v / volume)
        pi = np.pi
        sphericity = (pi ** (1.0 / 3.0)) * (6 * volume) ** (2.0 / 3.0) / area if area > 0 else 0.0

        if par.output_verbosity > 0:
            self._p(f"  Volume of the particle: {fmt8(volume)}")
            self._p(f"  Surface area of the particle: {fmt8(area)}")
            vstr = "  ".join(fmt8(vel[d] / volume) for d in range(3))
            self._p(f"  Mean bubble velocity: {vstr}  ")
            cstr = "  ".join(fmt8(com[d] / volume) for d in range(3))
            self._p(f"  Position of the center of mass:  {cstr}  ")
            self._p(f"  Sphericity of the particle: {fmt8(sphericity)}")
            lo, hi = self.get_concentration_range()
            self._p(f"  Range of level set values: {fmt8(lo)} / {fmt8(hi)}")

        data = [self.time_stepping.now(), volume, area]
        data += [vel[d] / volume for d in range(3)]
        data += [com[d] / volume for d in range(3)]
        data.append(sphericity)
        return data

    # ------------------------------------------------------------------
    def refine_grid(self) -> None:
        """Adaptive refinement happens on forests only; a lattice stays."""

    def output_solution(self, filename: str, n_subdivisions: int = 0) -> None:
        """Joint VTU output of velocity, pressure, concentration and
        curvature (two_phase_base.cc:550-592)."""
        if not filename or not self.parameters.print_solution_fields:
            return
        raise NotImplementedError(
            "VTU output is not ported (ROADMAP.md queue 1, item 17)"
        )


def _patch_area_perimeter(c0, c1, c2, c3, p0, p1, p2, p3):
    """Vectorized per-patch interface logic of the reference
    (two_phase_base.cc:735-845): corners ordered (x0y0, x1y0, x0y1, x1y1);
    returns (area fraction in the positive phase, interface length)."""
    n = len(c0)
    local_area = np.ones(n)
    per = np.zeros(n)

    def crossing(a, b):
        has = a * b <= 0
        return np.where(has, a / np.where(has, a - b, 1.0), -1.0)

    rx0 = crossing(c0, c1)
    rx1 = crossing(c2, c3)
    ry0 = crossing(c0, c2)
    ry1 = crossing(c1, c3)
    pos_x0 = p0 + (p1 - p0) * rx0[:, None]
    pos_x1 = p2 + (p3 - p2) * rx1[:, None]
    pos_y0 = p0 + (p2 - p0) * ry0[:, None]
    pos_y1 = p1 + (p3 - p1) * ry1[:, None]

    def seg(a, b):
        return np.linalg.norm(a - b, axis=1)

    cases = (
        ((rx0 > 0) & (ry0 > 0), 0.5 * rx0 * ry0, c0, pos_x0, pos_y0),
        ((rx0 > 0) & (ry1 > 0), 0.5 * (1 - rx0) * ry1, c1, pos_x0, pos_y1),
        ((rx0 > 0) & (rx1 > 0) & (ry0 < 0) & (ry1 < 0), 0.5 * (rx0 + rx1), c0, pos_x0, pos_x1),
        ((rx1 > 0) & (ry0 > 0), 0.5 * rx1 * (1 - ry0), c2, pos_x1, pos_y0),
        ((rx1 > 0) & (ry1 > 0), 0.5 * (1 - rx1) * (1 - ry1), c3, pos_x1, pos_y1),
        ((ry0 > 0) & (ry1 > 0) & (rx0 < 0) & (rx1 < 0), 0.5 * (ry0 + ry1), c0, pos_y0, pos_y1),
    )
    for m, my_area, corner, a, b in cases:
        local_area -= np.where(m, np.where(corner < 0, my_area, 1 - my_area), 0.0)
        per += np.where(m, seg(a, b), 0.0)
    none = (rx0 <= 0) & (rx1 <= 0) & (ry0 <= 0) & (ry1 <= 0) & (c0 <= 0)
    return np.where(none, 0.0, local_area), per


def fmt8(x: float) -> str:
    """C++ ostream precision(8) general format."""
    s = f"{x:.8g}"
    if "e" in s:
        mant, ex = s.split("e")
        return f"{mant}e{int(ex):+03d}"
    return s
