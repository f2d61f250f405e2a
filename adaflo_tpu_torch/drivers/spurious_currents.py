"""Static-bubble parasitic-currents benchmark driver.

PyTorch counterpart of ``adaflo_tpu/drivers/spurious_currents.py``, lattice
branch (the reference driver tests/spurious_currents.cc): a bubble of radius
0.5, slightly off centre at (0.02, 0.03[, 0.04]), in the no-slip box
[-2.5, 2.5]^dim (the `global refinements` parameter is the number of
subdivisions per direction, not a refinement count); after each step, the
maximum spurious velocity and the relative error of the Laplace pressure
jump. The two-phase flow on the adaptive forest is not ported (ROADMAP.md
queue 1, item 12b).

Run: python -m adaflo_tpu_torch.drivers.spurious_currents
tests/prms/spurious_currents_ls_short.prm [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from adaflo_tpu_torch.drivers.rising_bubble import TwoPhaseParameters, make_solver
from adaflo_tpu_torch.fe.basis import equidistant_points
from adaflo_tpu_torch.functions import ZeroFunction
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.ops.tensor import CellEvaluator
from adaflo_tpu_torch.twophase.base import fmt8
from adaflo_tpu_torch.utils.timer import print_wall_times


def initial_distance(x, t=0.0):
    dim = x.shape[1]
    center = np.array([0.02 + 0.01 * d for d in range(dim)])
    return np.linalg.norm(x - center[None, :], axis=1) - 0.5


class MicroFluidicProblem:
    def __init__(self, parameters: TwoPhaseParameters, out=None, device=None) -> None:
        self.parameters = parameters
        self.out = out
        dim = parameters.dimension
        if parameters.adaptive_refinements > 0:
            raise NotImplementedError(
                "the two-phase flow on the adaptive forest is not ported "
                "(ROADMAP.md queue 1, item 12b)"
            )
        n = parameters.global_refinements
        self.mesh = StructuredMesh((n,) * dim, (-2.5,) * dim, (5.0,) * dim)
        self.solver = make_solver(parameters, self.mesh, out=out, device=device)
        self.navier_stokes = self.solver.navier_stokes

    def _p(self, *a, **k):
        print(*a, **k, file=self.out or sys.stdout)

    def evaluate_spurious_velocities(self) -> None:
        par = self.parameters
        ns = self.navier_stokes
        mesh = self.mesh
        dim = mesh.dim
        kw = dict(dtype=ns.dtype, device=ns.device)
        # max |u| over an equidistant lattice (spurious_currents.cc:120-150)
        pts = equidistant_points(par.velocity_degree + 3)
        ev = CellEvaluator(dim, ns.u_space.basis, (pts, np.zeros_like(pts)), mesh.h, **kw)
        vals = ev.values(self.solver._velocity_cells())
        norm_velocity = float(torch.sqrt((vals * vals).sum(dim=1)).max())

        # pressure jump: the average p over the cells whose centre is within
        # 0.1 of the origin (else the nearest cell) minus the boundary
        # average (spurious_currents.cc:185-206)
        p = ns.solution[1].cpu().numpy()
        evp = CellEvaluator(dim, ns.p_space.basis, par.velocity_degree + 1, mesh.h, **kw)
        p_vals = evp.values(ns.operator.lat_p.gather(ns.solution[1])).cpu().numpy()
        centers = evp.quad_coords(mesh).mean(axis=1)
        jxw = evp.jxw_np
        rr = np.linalg.norm(centers, axis=1)
        inner = rr < 0.1
        if not inner.any():
            inner = rr == rr.min()
        p_avg = (p_vals[inner] * jxw).sum()
        o_avg = jxw.sum() * inner.sum()

        # boundary face averages
        press_b = one_b = 0.0
        for _, _, fd, _, V_face, jxw_f in ns.p_space.boundary_face_quadrature(
            0, par.velocity_degree + 1
        ):
            press_b += ((p[fd] @ V_face.T) * jxw_f).sum()
            one_b += jxw_f.sum() * len(fd)

        jump_exact = 2.0 * (dim - 1) * par.surface_tension
        pressure_jump = (p_avg / o_avg - press_b / one_b - jump_exact) / jump_exact * 100.0
        self._p(f"  Error in pressure jump: {fmt8(pressure_jump)} %")
        self._p(f"  Size spurious currents, absolute: {fmt8(norm_velocity)}")

    def setup(self) -> None:
        solver = self.solver
        solver.set_no_slip_boundary(0)
        solver.fix_pressure_constant(0)
        solver.setup_problem(ZeroFunction(self.parameters.dimension), initial_distance)

    def step(self):
        counts = self.solver.advance_time_step()
        self.evaluate_spurious_velocities()
        return counts

    def run(self) -> None:
        self.setup()
        while not self.solver.get_time_stepping().at_end():
            self.step()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paramfile", nargs="?", default="spurious_currents.prm")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain versions)",
    )
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parameters = TwoPhaseParameters.from_file(args.paramfile)
    problem = MicroFluidicProblem(parameters, device=args.device)
    problem.run()
    print_wall_times(parameters, problem)


if __name__ == "__main__":
    main()
