"""The port's Poiseuille driver in the projection scheme and on the 3D
channel against the JAX package, float64 on the CPU:

- tests/prms/poiseuille_ns_proj_small.prm (32 x 8 cells) for two steps: the
  printed output, the counts and the final state to 1e-10 of the
  solution's size (torch_single_phase_cases.check_against_jax); the JAX
  state after the first step (p^n in the pressure update, phi^n in the old
  pressure) carried into a port solver (state.from_jax_state, load_state)
  gives JAX's second step;
- the 3D ChannelProblem of tests/prms/poiseuille_ns_small.prm with
  `dimension = 3` and `global refinements = 1` (8 x 2 x 2 cells), one
  coupled Newton step: the same checks, the port on K1/K2's plain
  versions;
- the initial Stokes solve of compute_initial_stokes_field on couette's
  spaces and lid-driven boundary data: the printed table and the solution
  to 1e-10 of its size."""

import importlib
import io

import numpy as np
import pytest

from adaflo_tpu_torch.drivers.poiseuille import ChannelProblem
from adaflo_tpu_torch.parameters import FlowParameters, PhysicalType
from adaflo_tpu_torch.state import from_jax_state, load_state
from adaflo_tpu_torch.testing import normalize_output, numdiff_lines
from torch_single_phase_cases import PRMS, check_against_jax, kernel_route, run


def test_projection_two_steps_and_carried_state():
    jax_run = run("adaflo_tpu", "poiseuille", "poiseuille_ns_proj_small", 2)
    port_run = run("adaflo_tpu_torch", "poiseuille", "poiseuille_ns_proj_small", 2)
    check_against_jax(jax_run, port_run, 2)
    assert kernel_route(port_run) == "einsum"

    par = FlowParameters.from_file(str(PRMS / "poiseuille_ns_proj_small.prm"))
    problem = ChannelProblem(par, out=io.StringIO(), device="cpu")
    problem.setup()
    ns = problem.navier_stokes
    load_state(ns, from_jax_state(jax_run["states"][0], "cpu"))
    assert ns.time_stepping.step_no() == 1
    counts = problem.step()
    assert (int(counts[0]), int(counts[1])) == jax_run["counts"][1]
    ref = jax_run["states"][1]
    scale = max(abs(ref["solution_u"]).max(), abs(ref["solution_p"]).max())
    for key, vec in (("solution_u", ns.solution[0]), ("solution_p", ns.solution[1]),
                     ("solution_old_p", ns.solution_old[1]),
                     ("solution_update_p", ns.solution_update[1])):
        assert abs(vec.numpy() - ref[key]).max() <= 1e-10 * scale, key


def test_channel_3d_against_jax():
    kw = dict(dimension=3, global_refinements=1)
    jax_run = run("adaflo_tpu", "poiseuille", "poiseuille_ns_small", 1, **kw)
    port_run = run("adaflo_tpu_torch", "poiseuille", "poiseuille_ns_small", 1, **kw)
    check_against_jax(jax_run, port_run, 1)
    assert kernel_route(port_run) == "kernel"
    assert "Running a 3D channel flow problem" in port_run["text"]
    ns = port_run["problem"].navier_stokes
    assert tuple(ns.mesh.n_cells_axis) == (8, 2, 2)
    # the open sides constrain the y and z components, the symmetry plane y
    masks = ns.operator.cells.mask_u
    assert [int(m.sum()) for m in masks] == [
        len(c.constrained_dofs) for c in ns.constraints_u
    ]
    assert len({int(m.sum()) for m in masks}) == 3


def _couette_stokes_field(package):
    """Couette's spaces and boundary data, then the initial Stokes solve
    (its lid makes u = 0 inconsistent with the boundary data)."""
    Params = importlib.import_module(f"{package}.parameters").FlowParameters
    funcs = importlib.import_module(f"{package}.functions")
    mod = importlib.import_module(f"{package}.drivers.couette")
    out = io.StringIO()
    kw = {} if package == "adaflo_tpu" else {"device": "cpu"}
    problem = mod.CouetteProblem(Params.from_file(str(PRMS / "couette.prm")), out=out, **kw)
    ns = problem.navier_stokes
    ns.set_no_slip_boundary(0)
    ns.set_velocity_dirichlet_boundary(3, funcs.ConstantFunction([2.0, 0.0]))
    ns.set_open_boundary_with_normal_flux(1, funcs.ZeroFunction())
    ns.set_open_boundary_with_normal_flux(2, funcs.ZeroFunction())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
        mp.setenv("ADAFLO_FUSED_NEWTON", "0")
        ns.setup_problem(funcs.ZeroFunction(2))
        ns.compute_initial_stokes_field()
    return out.getvalue(), ns


def test_initial_stokes_field_against_jax():
    """compute_initial_stokes_field solves Stokes for the lid-driven
    boundary data (the Stokes type and zero density for the solve, the
    solver's own type, density and coefficients after it), as the JAX
    solver does."""
    jtext, jns = _couette_stokes_field("adaflo_tpu")
    ttext, tns = _couette_stokes_field("adaflo_tpu_torch")
    assert "Compute initial velocity field with Stokes" in ttext
    assert numdiff_lines(normalize_output(ttext), normalize_output(jtext)) == []
    ju, jp = np.asarray(jns.solution[0]), np.asarray(jns.solution[1])
    scale = max(abs(ju).max(), abs(jp).max())
    assert abs(tns.solution[0].numpy() - ju).max() <= 1e-10 * scale
    assert abs(tns.solution[1].numpy() - jp).max() <= 1e-10 * scale
    par = tns.parameters
    assert par.physical_type == PhysicalType.incompressible and par.density == 1.0
    assert tns.update_preconditioner and tns.operator.kernel_configuration()
    # the lid's velocity reaches the interior
    assert abs(tns.solution[0][0]).max() == 2.0 and float(abs(tns.solution[0][0]).mean()) > 0.1
