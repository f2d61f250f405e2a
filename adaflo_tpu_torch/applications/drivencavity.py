"""Lid-driven cavity application.

PyTorch counterpart of ``adaflo_tpu/applications/drivencavity.py`` (the
reference's applications/drivencavity.cc): stationary Navier-Stokes in the
unit cavity with a regularized lid velocity (cosine-smoothed so that the
corners are compatible), pressure fixed at the boundary; one stationary
solve per mesh inside the pressure-based AMR loop on the adaptive forest
(Kelly pressure-jump indicators -> refine_and_coarsen_fixed_number ->
adapt_mesh with solution transfer, drivencavity.cc:384-412). An empty
output file name writes nothing; VTU output is not ported (ROADMAP.md
queue 1, item 17).

Run: python -m adaflo_tpu_torch.applications.drivencavity <prm> [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from adaflo_tpu_torch.mesh.forest import ForestMesh
from adaflo_tpu_torch.parameters import FlowParameters
from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes
from adaflo_tpu_torch.utils.timer import print_wall_times


def lid_velocity(x, t=0.0):
    dim = x.shape[1]
    vals = np.zeros((dim, len(x)))
    on_lid = np.abs(x[:, 1] - 1.0) < 1e-12
    profile = 0.25 * (1 - np.cos(2 * np.pi * x[:, 0]))
    if dim == 3:
        profile = profile * (1 - np.cos(2 * np.pi * x[:, 2] / 3.0))
    else:
        profile = 2 * profile  # 2D: peak lid speed 1
    vals[0] = np.where(on_lid, profile, 0.0)
    return vals


class DrivenCavityProblem:
    def __init__(self, parameters: FlowParameters, out=None, device=None) -> None:
        self.parameters = parameters
        self.out = out
        dim = parameters.dimension
        if parameters.global_refinements % 4 != 0:
            raise ValueError("elements per direction must be divisible by 4")
        n = parameters.global_refinements // 4
        self.mesh = ForestMesh((n,) * dim, (0.0,) * dim, (1.0,) * dim)
        self.mesh.refine_global(2)
        # the solver's setup_problem must not refine again
        parameters.global_refinements = 0
        self.navier_stokes = NavierStokes(parameters, self.mesh, out=out, device=device)

    def run(self) -> None:
        ns = self.navier_stokes
        ns.set_velocity_dirichlet_boundary(0, lid_velocity)
        ns.fix_pressure_constant(0)
        ns.setup_problem()
        for _ in range(self.parameters.adaptive_refinements + 1):
            ns.print_n_dofs()
            ns.advance_time_step()
            ns.output_solution(self.parameters.output_filename)
            ns.refine_grid_pressure_based(100, 0.1, 0)
            # stationary pseudo-time: each mesh gets a fresh solve window
            ns.time_stepping.restart()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paramfile", nargs="?", default="drivencavity.prm")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs on the CPU)",
    )
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parameters = FlowParameters.from_file(args.paramfile)
    problem = DrivenCavityProblem(parameters, device=args.device)
    problem.run()
    print_wall_times(parameters, problem)


if __name__ == "__main__":
    main()
