"""2D/3D rising bubble benchmark driver.

PyTorch counterpart of ``adaflo_tpu/drivers/rising_bubble.py``, lattice
branch (the reference driver tests/rising_bubble.cc): a bubble of radius
0.25 centred at (0.5, 0.5[, 0.5]) in the [0,1]^(dim-1) x [0,2] channel,
no-slip top and bottom, symmetry on the x = 0 and x = 1 sides, the pressure
fixed; the conservative level set ("level set okz") and the bubble
statistics after every step.

`flagship_mesh_3d` builds the 3D configuration of the repository's
flagship size: the unit cube in 32^3 cells with symmetry on the four side
faces (tests/prms/rising_bubble_ls_3d_bench.prm with `global refinements`
set to 0, 859,812 Navier-Stokes and 35,937 level-set dofs).

The other two-phase methods and the adaptive forest are not ported:
'level set okz matrix' (ROADMAP.md queue 1, item 14), 'phase field' (item
13), the sharp-interface methods (item 16), adaptive refinements (item 12).

Run: python -m adaflo_tpu_torch.drivers.rising_bubble
tests/prms/rising_bubble_ls_short.prm [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from adaflo_tpu_torch.functions import ZeroFunction
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.parameters import FlowParameters
from adaflo_tpu_torch.prm import ParameterHandler
from adaflo_tpu_torch.utils.timer import print_wall_times

# two-phase methods the port does not have yet, and their items
_NOT_PORTED = {"level set okz matrix": 14, "phase field": 13, "sharp level set": 16}


class TwoPhaseParameters(FlowParameters):
    """FlowParameters and the driver's 'Problem-specific' subsection
    (rising_bubble.cc:34-55)."""

    solver_method: str = "level set okz"

    @classmethod
    def _handler(cls) -> ParameterHandler:
        prm = ParameterHandler()
        cls.declare_parameters(prm)
        prm.enter_subsection("Problem-specific")
        prm.declare_entry(
            "two-phase method",
            "level set okz",
            "level set okz|level set okz matrix|phase field|"
            "front tracking|mixed level set|sharp level set|level set",
        )
        prm.leave_subsection()
        return prm

    @classmethod
    def _from_handler(cls, prm: ParameterHandler) -> "TwoPhaseParameters":
        self = cls()
        self._parse(prm)
        prm.enter_subsection("Problem-specific")
        self.solver_method = prm.get("two-phase method")
        prm.leave_subsection()
        return self

    @classmethod
    def from_file(cls, parameter_file: str) -> "TwoPhaseParameters":
        prm = cls._handler()
        if parameter_file.endswith(".json"):
            prm.parse_input_from_json(parameter_file)
        else:
            prm.parse_input(parameter_file)
        return cls._from_handler(prm)

    @classmethod
    def from_string(cls, text: str) -> "TwoPhaseParameters":
        prm = cls._handler()
        prm.parse_input_string(text)
        return cls._from_handler(prm)


def initial_distance(x, t=0.0):
    center = np.full(x.shape[1], 0.5)
    return np.linalg.norm(x - center[None, :], axis=1) - 0.25


def make_solver(parameters: TwoPhaseParameters, mesh, out=None, device=None):
    """The two-phase solver of `parameters.solver_method` on `mesh`."""
    method = parameters.solver_method
    if method == "level set okz":
        from adaflo_tpu_torch.twophase.level_set_okz import LevelSetOKZSolver

        return LevelSetOKZSolver(parameters, mesh, out=out, device=device)
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"two-phase method '{method}' is not ported (ROADMAP.md queue 1, "
            f"item {_NOT_PORTED[method]})"
        )
    raise ValueError(f"Unknown solver '{method}' selected")


def flagship_mesh_3d(n_cells: int = 32) -> StructuredMesh:
    """The unit cube in n_cells^3 cells, symmetry (id 2) on x = 0, 1 and
    y = 0, 1, id 0 (no-slip) on the bottom and top."""
    mesh = StructuredMesh.subdivided_hyper_rectangle(
        (n_cells,) * 3, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    )
    eps = 1e-14
    mesh.set_boundary_id(
        lambda c: (np.abs(c[:, 0] - 1) < eps)
        | (np.abs(c[:, 0]) < eps)
        | (np.abs(c[:, 1] - 1) < eps)
        | (np.abs(c[:, 1]) < eps),
        2,
    )
    return mesh


class MicroFluidicProblem:
    """The rising bubble; `mesh` replaces the driver's channel (the caller
    sets its boundary ids: 0 no-slip, 2 symmetry)."""

    def __init__(
        self, parameters: TwoPhaseParameters, out=None, device=None, mesh=None
    ) -> None:
        self.parameters = parameters
        self.out = out
        dim = parameters.dimension
        if parameters.adaptive_refinements > 0:
            raise NotImplementedError(
                "the adaptive forest is not ported (ROADMAP.md queue 1, item 12)"
            )
        if mesh is None:
            mesh = StructuredMesh.subdivided_hyper_rectangle(
                (5,) * (dim - 1) + (10,), (0.0,) * dim, (1.0,) * (dim - 1) + (2.0,)
            )
            # symmetry on the x = 0 / x = 1 faces (rising_bubble.cc:136-144)
            mesh.set_boundary_id(
                lambda c: (np.abs(c[:, 0] - 1) < 1e-14) | (np.abs(c[:, 0]) < 1e-14), 2
            )
        self.mesh = mesh
        self.solver = make_solver(parameters, mesh, out=out, device=device)
        self.navier_stokes = self.solver.navier_stokes

    def setup(self) -> None:
        solver = self.solver
        par = self.parameters
        solver.set_no_slip_boundary(0)
        solver.fix_pressure_constant(0)
        solver.set_symmetry_boundary(2)
        solver.setup_problem(ZeroFunction(par.dimension), initial_distance)
        solver.output_solution(par.output_filename)
        self.solution_data = [solver.compute_bubble_statistics(0)]

    def step(self):
        """One time step and its statistics; returns (Newton iterations,
        Krylov iterations)."""
        solver = self.solver
        counts = solver.advance_time_step()
        solver.output_solution(self.parameters.output_filename)
        solver.refine_grid()
        self.solution_data.append(solver.compute_bubble_statistics())
        return counts

    def run(self) -> None:
        self.setup()
        while not self.solver.get_time_stepping().at_end():
            self.step()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paramfile", nargs="?", default="rising_bubble.prm")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain versions)",
    )
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    # no residual-path contraction in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parameters = TwoPhaseParameters.from_file(args.paramfile)
    problem = MicroFluidicProblem(parameters, device=args.device)
    problem.run()
    print_wall_times(parameters, problem)


if __name__ == "__main__":
    main()
