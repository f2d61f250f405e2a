"""2D Taylor / 3D Beltrami analytic Navier-Stokes benchmark driver.

PyTorch counterpart of ``adaflo_tpu/drivers/beltrami.py`` (the reference
driver tests/beltrami.cc): the decaying Taylor vortex (Kim & Moin) in 2D and
the Beltrami flow (Ethier & Steinman) in 3D on [-1,1]^dim, all-Dirichlet
time-dependent velocity BCs from the exact solution, pressure fixed against
the exact pressure at the boundary; absolute and relative L2 errors plus
cellwise divergence at the output cadence.

2D runs the reference's locally refined mesh (beltrami.cc:392-412): 4 x 4
roots, global refinements - 2 global steps, the active cells 2 and 3
refined, one more global step, an adaptive forest with hanging nodes
(1048 cells, 34158 + 9663 dofs at global refinements = 4, velocity degree
4, beltrami_2d.output). 3D keeps the uniform mesh of the recorded
reference output (beltrami_3d.output: 4096 cells, 107811 + 4913 dofs).
Augmented Taylor-Hood elements (FE_Q_DG0 pressure) run on the uniform
lattice in 2D and 3D, their pressure error with the cell constants.

Run: python -m adaflo_tpu_torch.drivers.beltrami tests/prms/beltrami_3d.prm
[--device cpu] (or beltrami_2d_small.prm, beltrami_2d_proj_small.prm on the
forest; beltrami_3d_augp_small.prm, beltrami_2d_augp_small.prm,
beltrami_2d_augp_proj_small.prm on the lattice)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from adaflo_tpu_torch.mesh.forest import ForestMesh
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.parameters import FlowParameters
from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes
from adaflo_tpu_torch.utils.errors import (
    cell_divergence_norm,
    interpolate,
    l2_error,
    l2_error_augmented_pressure,
    l2_norm,
)
from adaflo_tpu_torch.utils.timer import print_wall_times


def exact_u(nu: float, dim: int):
    a = 0.25 * np.pi
    d = (2.0 if dim == 3 else np.sqrt(2.0)) * a

    def fn(x, t=0.0):
        if dim == 2:
            decay = np.exp(-2.0 * nu * a * a * t)
            u0 = -a * np.cos(a * x[:, 0]) * np.sin(a * x[:, 1]) * decay
            u1 = a * np.sin(a * x[:, 0]) * np.cos(a * x[:, 1]) * decay
            return np.stack([u0, u1])
        decay = np.exp(-nu * d * d * t)
        u0 = -a * (
            np.exp(a * x[:, 0]) * np.sin(a * x[:, 1] + d * x[:, 2])
            + np.exp(a * x[:, 2]) * np.cos(a * x[:, 0] + d * x[:, 1])
        )
        u1 = -a * (
            np.exp(a * x[:, 1]) * np.sin(a * x[:, 2] + d * x[:, 0])
            + np.exp(a * x[:, 0]) * np.cos(a * x[:, 1] + d * x[:, 2])
        )
        u2 = -a * (
            np.exp(a * x[:, 2]) * np.sin(a * x[:, 0] + d * x[:, 1])
            + np.exp(a * x[:, 1]) * np.cos(a * x[:, 2] + d * x[:, 0])
        )
        return np.stack([u0, u1, u2]) * decay

    return fn


def exact_p(nu: float, dim: int):
    a = 0.25 * np.pi
    d = 2.0 * a

    def fn(x, t=0.0):
        if dim == 2:
            return (
                -a
                * a
                * 0.25
                * (np.cos(2 * a * x[:, 0]) + np.cos(2 * a * x[:, 1]))
                * np.exp(-4.0 * nu * a * a * t)
            )
        return (
            -a
            * a
            * 0.5
            * (
                np.exp(2 * a * x[:, 0])
                + np.exp(2 * a * x[:, 1])
                + np.exp(2 * a * x[:, 2])
                + 2
                * np.sin(a * x[:, 0] + d * x[:, 1])
                * np.cos(a * x[:, 2] + d * x[:, 0])
                * np.exp(a * (x[:, 1] + x[:, 2]))
                + 2
                * np.sin(a * x[:, 1] + d * x[:, 2])
                * np.cos(a * x[:, 0] + d * x[:, 1])
                * np.exp(a * (x[:, 2] + x[:, 0]))
                + 2
                * np.sin(a * x[:, 2] + d * x[:, 0])
                * np.cos(a * x[:, 1] + d * x[:, 2])
                * np.exp(a * (x[:, 0] + x[:, 1]))
            )
            * np.exp(-2 * nu * d * d * t)
        )

    return fn


class BeltramiProblem:
    def __init__(self, parameters: FlowParameters, out=None, device=None) -> None:
        self.parameters = parameters
        self.out = out
        dim = parameters.dimension
        if dim == 2 and not parameters.augmented_taylor_hood:
            # the reference's serial mesh: the forest's Morton order matches
            # deal.II's active cell order for the first sibling group, so
            # cells 2 and 3 are the reference's
            self.mesh = ForestMesh((4,) * dim, (-1.0,) * dim, (2.0,) * dim)
            g = parameters.global_refinements
            if g >= 2:
                self.mesh.refine_global(g - 2)
            flags = np.zeros(self.mesh.n_cells, dtype=np.int8)
            flags[2:4] = 1
            self.mesh.adapt(flags)
            self.mesh.refine_global(1)
            parameters.global_refinements = 0
        else:
            # the recorded 3D reference output (3 MPI ranks) shows the two
            # local refine flags had no effect (4096 uniform cells), so the
            # uniform lattice applies; augmented Taylor-Hood stays on it in
            # 2D as well
            self.mesh = StructuredMesh.subdivided_hyper_rectangle(
                (4,) * dim, (-1.0,) * dim, (1.0,) * dim
            )
            parameters.global_refinements = max(parameters.global_refinements - 1, 0)
        self.navier_stokes = NavierStokes(parameters, self.mesh, out=out, device=device)
        self.nu = parameters.viscosity

    def _p(self, *a, **k):
        print(*a, **k, file=self.out or sys.stdout)

    def compute_errors(self) -> None:
        ns = self.navier_stokes
        time = ns.time_stepping.now()
        deg = self.parameters.velocity_degree
        dim = self.mesh.dim
        u, p = ns.solution[0], ns.solution[1]
        cell_div = cell_divergence_norm(ns.u_space, u)
        if self.parameters.augmented_taylor_hood:
            p_err = l2_error_augmented_pressure(
                ns.operator, p, exact_p(self.nu, dim), time, deg + 2
            )
            p_norm = l2_error_augmented_pressure(
                ns.operator, p, lambda x, t: np.zeros(len(x)), time, deg
            )
        else:
            p_err = l2_error(ns.p_space, p, exact_p(self.nu, dim), time, deg + 2)
            p_norm = l2_norm(ns.p_space, p, deg)
        u_err = l2_error(
            ns.u_space, u, exact_u(self.nu, dim), time, deg + 2, n_components=dim
        )
        u_norm = l2_norm(ns.u_space, u, deg, n_components=dim)
        self._p(
            f"  L2-Errors absolute: ||e_p||_L2 = {fmt4(p_err)},"
            f"   ||e_u||_L2 = {fmt4(u_err)}"
        )
        self._p(
            f"  L2-Errors relative: ||e_p||_L2 = {fmt4(p_err / p_norm)},"
            f"   ||e_u||_L2 = {fmt4(u_err / u_norm)}"
        )
        self._p(f"  Cell divergence:    |div(u)|_cells = {fmt4(cell_div)}")

    def output_results(self) -> None:
        if self.navier_stokes.time_stepping.at_tick(self.parameters.output_frequency):
            self.compute_errors()

    def setup(self) -> None:
        """Boundary conditions, spaces and the exact initial condition."""
        ns = self.navier_stokes
        dim = self.mesh.dim
        par = self.parameters
        self._p(
            f"Running a {dim}D Beltrami problem using "
            f"{ns.time_stepping.name()}, Q{par.velocity_degree}"
            f"/Q{par.pressure_degree}{'+' if par.augmented_taylor_hood else ''} "
            "elements on 1 processes"
        )
        ns.set_velocity_dirichlet_boundary(0, lambda x, t: exact_u(self.nu, dim)(x, t))
        ns.fix_pressure_constant(0, lambda x, t: exact_p(self.nu, dim)(x, t))
        ns.setup_problem()
        ns.print_n_dofs()
        kw = dict(dtype=ns.dtype, device=ns.device)
        ns.solution[0] = torch.as_tensor(
            interpolate(ns.u_space, exact_u(self.nu, dim)), **kw
        )
        # the exact pressure in the Q part; the cell constants of augmented
        # elements start at zero (the reference's interpolate_pressure_field
        # on the FE_Q subspace)
        p0 = torch.as_tensor(interpolate(ns.p_space, exact_p(self.nu, dim)), **kw)
        p = torch.zeros_like(ns.solution[1])
        p[: len(p0)] = p0
        ns.solution[1] = p

    def step(self):
        """One time step; returns (Newton iterations, Krylov iterations)."""
        ns = self.navier_stokes
        ns.init_time_advance(True)
        counts = ns.evaluate_time_step()
        self.output_results()
        return counts

    def run(self) -> None:
        self.setup()
        self.output_results()
        while not self.navier_stokes.time_stepping.at_end():
            self.step()


def fmt4(x: float) -> str:
    s = f"{x:.4g}"
    if "e" in s:
        mant, ex = s.split("e")
        return f"{mant}e{int(ex):+03d}"
    return s


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paramfile", nargs="?", default="beltrami.prm")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain versions)",
    )
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    # no residual-path contraction in TF32 (a low-precision product floors
    # the Newton iteration in float32 runs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parameters = FlowParameters.from_file(args.paramfile)
    problem = BeltramiProblem(parameters, device=args.device)
    problem.run()
    print_wall_times(parameters, problem)


if __name__ == "__main__":
    main()
