"""2D/3D channel flow (Poiseuille) driver.

PyTorch counterpart of ``adaflo_tpu/drivers/poiseuille.py`` (the reference
driver tests/poiseuille.cc): the channel [-2,2] x [-1,0] (x [-1,0] in 3D)
with no-slip walls, a symmetry plane at y = 0 and open boundaries with the
steady pressure 2 - x driving the flow; L2 errors against the steady
analytic profile every 4th step. The time-dependent coupled Newton
configurations run the coupled cell apply (K1/K2); Stokes, stationary and
projection run the operator's plain cell route.

`ChannelProblem` takes `dimension = 3` as well (the 3D channel with the
symmetry plane y = 0); `main`, like the reference driver, runs 2D only.

Run: python -m adaflo_tpu_torch.drivers.poiseuille
tests/prms/poiseuille_ns_small.prm [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from adaflo_tpu_torch.functions import ZeroFunction
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.parameters import FlowParameters, PhysicalType
from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes, fmt_g
from adaflo_tpu_torch.utils.errors import l2_error
from adaflo_tpu_torch.utils.timer import print_wall_times


def exact_u(nu: float, dim: int):
    def fn(x, t=0.0):
        vals = np.zeros((dim, len(x)))
        vals[0] = 0.5 / nu * (1 - x[:, 1]) * (1 + x[:, 1])
        return vals

    return fn


def exact_p(x, t=0.0):
    return 2 - x[:, 0]


class ChannelProblem:
    def __init__(self, parameters: FlowParameters, out=None, device=None) -> None:
        self.parameters = parameters
        self.out = out
        dim = parameters.dimension
        subdivisions = (4,) + (1,) * (dim - 1)
        bottom_left = (-2.0,) + (-1.0,) * (dim - 1)
        top_right = (2.0,) + (0.0,) * (dim - 1)
        self.mesh = StructuredMesh.subdivided_hyper_rectangle(
            subdivisions, bottom_left, top_right
        )
        self.mesh.set_boundary_id(lambda c: np.abs(c[:, 0] - 2) < 1e-13, 1)
        self.mesh.set_boundary_id(lambda c: np.abs(c[:, 0] + 2) < 1e-13, 2)
        self.mesh.set_boundary_id(lambda c: np.abs(c[:, 1]) < 1e-13, 3)
        self.navier_stokes = NavierStokes(parameters, self.mesh, out=out, device=device)
        self.nu = parameters.viscosity
        self.output_timestep_skip = 4

    def _p(self, *a, **k):
        print(*a, **k, file=self.out or sys.stdout)

    def errors(self) -> tuple[float, float]:
        """(||e_p||_L2, ||e_u||_L2) against the steady profile."""
        ns = self.navier_stokes
        p_err = l2_error(ns.p_space, ns.solution[1], exact_p)
        u_err = l2_error(
            ns.u_space, ns.solution[0], exact_u(self.nu, self.mesh.dim),
            n_components=self.mesh.dim,
        )
        return p_err, u_err

    def compute_errors(self) -> None:
        p_err, u_err = self.errors()
        self._p(
            f"  L2-Errors: ||e_p||_L2 = {fmt4(p_err)},   ||e_u||_L2 = {fmt4(u_err)}"
        )

    def output_results(self) -> None:
        self._p(f"  Maximum velocity now: {fmt_g(0.5 / self.nu)}")

    def setup(self) -> None:
        """Boundary conditions and spaces."""
        ns = self.navier_stokes
        dim = self.mesh.dim
        self._p(
            f"Running a {dim}D channel flow problem using "
            f"{ns.time_stepping.name()}, Q{self.parameters.velocity_degree}"
            f"/Q{self.parameters.pressure_degree} elements"
        )
        ns.set_no_slip_boundary(0)
        ns.set_symmetry_boundary(3)
        ns.set_open_boundary_with_normal_flux(1, lambda x, t: exact_p(x))
        ns.set_open_boundary_with_normal_flux(2, lambda x, t: exact_p(x))
        ns.setup_problem(ZeroFunction(dim))
        ns.print_n_dofs()
        self.output_results()

    def step(self):
        """One time step with the errors at the output cadence; returns
        (Newton iterations, Krylov iterations)."""
        ns = self.navier_stokes
        counts = ns.advance_time_step()
        if (
            self.parameters.physical_type == PhysicalType.incompressible
            and ns.time_stepping.step_no() % self.output_timestep_skip == 0
        ):
            self.output_results()
            self.compute_errors()
        return counts

    def run(self) -> None:
        self.setup()
        ns = self.navier_stokes
        if self.parameters.physical_type == PhysicalType.incompressible:
            while not ns.time_stepping.at_end():
                self.step()
        else:
            self.step()
        if ns.time_stepping.step_no() % self.output_timestep_skip != 0:
            self.compute_errors()


def fmt4(x: float) -> str:
    """C++ ostream precision(4) general format."""
    s = f"{x:.4g}"
    if "e" in s:
        mant, ex = s.split("e")
        return f"{mant}e{int(ex):+03d}"
    return s


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paramfile", nargs="?", default="channel.prm")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain versions)",
    )
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parameters = FlowParameters.from_file(args.paramfile)
    assert parameters.dimension == 2, "2D only, like the reference driver"
    problem = ChannelProblem(parameters, device=args.device)
    problem.run()
    print_wall_times(parameters, problem)


if __name__ == "__main__":
    main()
