"""Periodic channel on the uniform lattice.

PyTorch counterpart of ``adaflo_tpu/applications/periodic_channel.py`` (the
reference's applications/periodic_channel.cc): the channel [0, 2 pi] x
[-1, 1] (x [0, 2 pi/3] in 3D), periodic in x (and z), no-slip walls at
y = +-1, the pressure constant fixed, a constant streamwise body force (the
mean pressure gradient) applied through user_rhs, and a quartic initial
profile with a spanwise perturbation.

The reference and the JAX package cluster the cells at the walls with
y -> tanh(y)/tanh(1). Graded lattices are not ported (ROADMAP.md queue 1,
item 15), so this application runs the channel on the uniform lattice: the
JAX application without its grading line. On a periodic lattice the coupled
Newton mat-vec runs the cell-block apply (K3) behind the lattice gather and
scatter, as in the JAX package.

Run: python -m adaflo_tpu_torch.applications.periodic_channel <prm>
[--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.parameters import FlowParameters
from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes
from adaflo_tpu_torch.utils.timer import print_wall_times

BODY_FORCE_X = 0.00337204  # mean pressure gradient (periodic_channel.cc:265)


def initial_channel(x, t=0.0):
    dim = x.shape[1]
    vals = np.zeros((dim, len(x)))
    y = x[:, 1]
    z = x[:, 2] if dim == 3 else 0.0 * y
    vals[0] = (1.0 - y**4) * 1.25
    vals[1] = 0.2 * (1.0 - y**4) * np.cos(z * 3)
    if dim == 3:
        vals[2] = 0.2 * (1.0 - y**4) * np.sin(z * 3)
    return vals


class PeriodicChannelProblem:
    def __init__(
        self,
        parameters: FlowParameters,
        out=None,
        device=None,
        dtype: torch.dtype = torch.float64,
    ) -> None:
        self.parameters = parameters
        self.out = out
        dim = parameters.dimension
        if parameters.global_refinements % 4 != 0:
            raise ValueError("elements per direction must be divisible by 4")
        n = parameters.global_refinements // 4
        top = (2 * np.pi, 1.0) + ((2.0 / 3.0 * np.pi,) if dim == 3 else ())
        bottom = (0.0, -1.0) + ((0.0,) if dim == 3 else ())
        self.mesh = StructuredMesh.subdivided_hyper_rectangle(
            (n,) * dim, bottom, top
        )
        self.mesh.refine_global(2)
        parameters.global_refinements = 0
        self.navier_stokes = NavierStokes(
            parameters, self.mesh, out=out, device=device, dtype=dtype
        )

    def setup(self) -> None:
        """Boundary conditions, spaces, the initial profile and the body
        force (periodic_channel.cc:254-273)."""
        ns = self.navier_stokes
        ns.set_velocity_dirichlet_boundary(0, lambda x, t: 0 * x.T)
        ns.fix_pressure_constant(0)
        ns.set_periodic_direction(0)
        if self.parameters.dimension == 3:
            ns.set_periodic_direction(2)
        ns.setup_problem(initial_channel)
        ns.print_n_dofs()
        op = ns.operator
        ones = torch.ones(
            (self.mesh.n_cells, op.ev_u.n_q), dtype=ns.dtype, device=ns.device
        )
        f_cells = op.ev_u.integrate_values(-BODY_FORCE_X * ones)
        fx = ns.constraints_u[0].condense(op.lat_u.scatter_add(f_cells))
        rhs = ns.user_rhs[0].clone()
        rhs[0] = fx
        ns.user_rhs[0] = rhs

    def step(self):
        """One time step; returns (Newton iterations, Krylov iterations)."""
        return self.navier_stokes.advance_time_step()

    def run(self, n_steps: int | None = None) -> None:
        self.setup()
        step = 0
        while not self.navier_stokes.time_stepping.at_end():
            self.step()
            step += 1
            if n_steps is not None and step >= n_steps:
                break


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paramfile", nargs="?", default="periodic_channel.prm")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain versions)",
    )
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parameters = FlowParameters.from_file(args.paramfile)
    problem = PeriodicChannelProblem(parameters, device=args.device)
    problem.run()
    print_wall_times(parameters, problem)


if __name__ == "__main__":
    main()
