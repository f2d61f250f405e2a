"""2D Couette flow driver.

PyTorch counterpart of ``adaflo_tpu/drivers/couette.py`` (the reference
driver tests/couette.cc): the channel [-2,2] x [-1,0] with the lid at y = 0
moving at velocity (2, 0), a no-slip bottom, and zero-pressure open
boundaries left and right whose tangential velocity is constrained
(normal flux). With the coupled implicit Newton linearization it runs the
coupled cell apply (K1/K2) on velocity masks that constrain only the
tangential component on the open sides.

Run: python -m adaflo_tpu_torch.drivers.couette tests/prms/couette.prm
[--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from adaflo_tpu_torch.functions import ConstantFunction, ZeroFunction
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.parameters import FlowParameters, PhysicalType
from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes
from adaflo_tpu_torch.utils.timer import print_wall_times


class CouetteProblem:
    def __init__(self, parameters: FlowParameters, out=None, device=None) -> None:
        self.parameters = parameters
        self.out = out
        self.mesh = StructuredMesh.subdivided_hyper_rectangle(
            (4, 1), (-2.0, -1.0), (2.0, 0.0)
        )
        self.mesh.set_boundary_id(lambda c: np.abs(c[:, 0] - 2) < 1e-13, 1)
        self.mesh.set_boundary_id(lambda c: np.abs(c[:, 0] + 2) < 1e-13, 2)
        self.mesh.set_boundary_id(lambda c: np.abs(c[:, 1]) < 1e-13, 3)
        self.navier_stokes = NavierStokes(parameters, self.mesh, out=out, device=device)

    def _p(self, *a, **k):
        print(*a, **k, file=self.out or sys.stdout)

    def setup(self) -> None:
        """Boundary conditions and spaces."""
        ns = self.navier_stokes
        par = self.parameters
        self._p(
            f"Running a 2D Couette problem using {ns.time_stepping.name()}, "
            f"Q{par.velocity_degree}/Q{par.pressure_degree} elements"
        )
        ns.set_no_slip_boundary(0)
        ns.set_velocity_dirichlet_boundary(3, ConstantFunction([2.0, 0.0]))
        ns.set_open_boundary_with_normal_flux(1, ZeroFunction())
        ns.set_open_boundary_with_normal_flux(2, ZeroFunction())
        ns.setup_problem(ZeroFunction(2))
        ns.print_n_dofs()

    def step(self):
        """One time step; returns (Newton iterations, Krylov iterations)."""
        return self.navier_stokes.advance_time_step()

    def run(self) -> None:
        self.setup()
        ns = self.navier_stokes
        if self.parameters.physical_type == PhysicalType.incompressible:
            while not ns.time_stepping.at_end():
                self.step()
        else:
            self.step()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paramfile", nargs="?", default="couette.prm")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain versions)",
    )
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parameters = FlowParameters.from_file(args.paramfile)
    problem = CouetteProblem(parameters, device=args.device)
    problem.run()
    print_wall_times(parameters, problem)


if __name__ == "__main__":
    main()
