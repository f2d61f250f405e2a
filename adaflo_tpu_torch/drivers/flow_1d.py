"""1D channel flow driver (with optional damping).

PyTorch counterpart of ``adaflo_tpu/drivers/flow_1d.py`` (the reference
driver tests/1d_flow.cc): the interval [0, 2.5] refined 10 times (plus the
prm's global refinements), pressure 2 at the left and 1 at the right open
boundary, initial velocity 2; the *_damped configuration exercises the
damping term of the momentum equation. Dim 1 has no cell kernel, in the
JAX package either: the operator runs its plain cell route.

Run: python -m adaflo_tpu_torch.drivers.flow_1d tests/prms/flow_1d.prm
[--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from adaflo_tpu_torch.functions import ConstantFunction
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.parameters import FlowParameters
from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes
from adaflo_tpu_torch.utils.timer import print_wall_times


class ChannelFlow:
    def __init__(self, parameters: FlowParameters, out=None, device=None) -> None:
        self.parameters = parameters
        self.out = out
        self.mesh = StructuredMesh((1,), (0.0,), (2.5,))
        self.mesh.refine_global(10)
        self.mesh.set_side_boundary_id(0, 0, 0)
        self.mesh.set_side_boundary_id(0, 1, 1)
        self.navier_stokes = NavierStokes(parameters, self.mesh, out=out, device=device)

    def _p(self, *a, **k):
        print(*a, **k, file=self.out or sys.stdout)

    def setup(self) -> None:
        """Boundary conditions, spaces and the initial velocity."""
        ns = self.navier_stokes
        par = self.parameters
        self._p(
            f"Running a 1D flow using {ns.time_stepping.name()}, "
            f"Q{par.velocity_degree}/Q{par.pressure_degree} elements"
        )
        ns.set_open_boundary_with_normal_flux(0, ConstantFunction(2.0))
        ns.set_open_boundary_with_normal_flux(1, ConstantFunction(1.0))
        ns.setup_problem(lambda x, t: np.full((1, len(x)), 2.0))
        ns.print_n_dofs()

    def step(self):
        """One time step; returns (Newton iterations, Krylov iterations)."""
        return self.navier_stokes.advance_time_step()

    def run(self) -> None:
        self.setup()
        while not self.navier_stokes.time_stepping.at_end():
            self.step()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paramfile", nargs="?", default="1d_flow.prm")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain versions)",
    )
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parameters = FlowParameters.from_file(args.paramfile)
    assert parameters.dimension == 1
    problem = ChannelFlow(parameters, device=args.device)
    problem.run()
    print_wall_times(parameters, problem)


if __name__ == "__main__":
    main()
