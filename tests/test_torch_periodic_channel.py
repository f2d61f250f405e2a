"""One coupled-Newton time step of the 2D periodic channel on the uniform
8 x 8 lattice (616 dofs): the JAX application against the port's on the
CPU (device="cpu").

The channel is periodic in x with no-slip walls at y = +-1, the pressure
constant fixed and the streamwise body force in user_rhs. The JAX side is
adaflo_tpu/applications/periodic_channel.py without its wall grading (its
StructuredMesh.apply_axis_transform is patched to do nothing for this
module, since graded lattices are not ported), run once per module on its
einsum path (ADAFLO_PALLAS_MATVEC=0) with the step-by-step Newton loop
(ADAFLO_FUSED_NEWTON=0). The parameters are those of the JAX package's
graded-channel test with the coupled implicit Newton linearization, BDF-2
and dt = 0.1, and tolerances tight enough (NL 1e-9, linear 1e-8) that the
step's result does not depend on roundoff: with the application's own NL
1e-4 / linear 1e-5 a 1e-15 perturbation of the start moves the step's
solution by 6e-7. Held: the printed table under numdiff_lines, the Newton
and Krylov counts, the solution to 1e-9 relative, no-slip rows exactly
zero, and the K3 plain version as the mat-vec's entry on the periodic
lattice; both from the port's own setup and from the JAX state carried
across with from_jax_state."""

import io

import numpy as np
import pytest
import torch

from adaflo_tpu.applications import periodic_channel as jpc
from adaflo_tpu.mesh.structured import StructuredMesh as JMesh
from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu_torch.applications import periodic_channel as tpc
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.state import from_jax_state, load_state, state_arrays
from adaflo_tpu_torch.testing import normalize_output, numdiff_lines

torch.set_num_threads(2)

PRM = """
subsection Time stepping
  set scheme    = bdf_2
  set step size = 0.1
  set end time  = 0.1
end
subsection Navier-Stokes
  set physical type      = incompressible
  set dimension          = 2
  set global refinements = 8
  set velocity degree    = 2
  set viscosity          = 0.001472
  subsection Solver
    set linearization scheme         = coupled implicit Newton
    set NL max iterations            = 10
    set NL tolerance                 = 1.e-9
    set lin max iterations           = 200
    set lin tolerance                = 1.e-8
    set tau grad div                 = 1
  end
end
subsection Output options
  set output verbosity = 3
  set output vtk files = 0
end
"""


def rel(got, ref):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def jax_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
        mp.setenv("ADAFLO_FUSED_NEWTON", "0")
        mp.setattr(JMesh, "apply_axis_transform", lambda self, axis, fn: None)
        out = io.StringIO()
        problem = jpc.PeriodicChannelProblem(JParams.from_string(PRM), out=out)
        ns = problem.navier_stokes
        rec = {}
        advance = ns.advance_time_step

        def advance_recording():
            # the state as the application set it up, before its step
            rec["arrays0"] = state_arrays(ns)
            rec["counts"] = advance()
            return rec["counts"]

        ns.advance_time_step = advance_recording
        problem.run(n_steps=1)
    assert not problem.mesh.is_graded
    return dict(text=out.getvalue(), final=state_arrays(ns), **rec)


def _port_step(setup):
    before = dict(cm.plain_calls)
    out = io.StringIO()
    problem = tpc.PeriodicChannelProblem(TParams.from_string(PRM), out=out, device="cpu")
    problem.setup()
    setup(problem.navier_stokes)
    counts = problem.step()
    calls = {k: cm.plain_calls[k] - before[k] for k in before}
    return dict(text=out.getvalue(), problem=problem, counts=counts, calls=calls)


@pytest.fixture(scope="module")
def port_run():
    return _port_step(lambda ns: None)


def test_printed_output_matches_jax(jax_run, port_run):
    got = normalize_output(port_run["text"])
    expect = normalize_output(jax_run["text"])
    assert numdiff_lines(got, expect) == []
    assert " Number of degrees of freedom (velocity/pressure): 616 (544 + 72)." in got
    assert port_run["text"].count(" converged.") == 1


def test_counts_and_solution_match_jax(jax_run, port_run):
    ns = port_run["problem"].navier_stokes
    assert port_run["counts"] == tuple(jax_run["counts"])
    assert port_run["counts"][0] >= 3 and port_run["counts"][1] > 0
    assert rel(ns.solution[0], jax_run["final"]["solution_u"]) <= 1e-9
    assert rel(ns.solution[1], jax_run["final"]["solution_p"]) <= 1e-9


def test_periodic_setup_walls_and_kernel_entry(jax_run, port_run):
    ns = port_run["problem"].navier_stokes
    mine = state_arrays(ns)
    assert list(ns.mesh.periodic) == [True, False]
    for key in ("periodic", "constrained_u0", "constrained_u1", "constrained_p",
                "constrained_schur"):
        assert np.array_equal(mine[key], jax_run["final"][key]), key
    assert rel(mine["user_rhs_u"], jax_run["final"]["user_rhs_u"]) <= 1e-14
    assert not mine["user_rhs_p"].any() and not jax_run["final"]["user_rhs_p"].any()
    walls = ns.u_space.boundary_dofs(0)
    assert len(walls) == 2 * 16  # the y = +-1 rows of the 16 x 17 node lattice
    assert float(ns.solution[0][:, walls].abs().max()) == 0.0
    # the mat-vec runs K3 behind the lattice gather and scatter
    assert ns.operator.layout == "t"
    assert ns.operator.route(ns._last_lin) == "cells"
    assert port_run["calls"]["coupled_apply_cells_plain"] > 0
    assert port_run["calls"]["coupled_apply_plain"] == 0
    assert port_run["calls"]["coupled_apply_gather_plain"] == 0


def test_step_from_jax_state(jax_run):
    state = from_jax_state(jax_run["arrays0"], "cpu")
    run = _port_step(lambda ns: load_state(ns, state))
    ns = run["problem"].navier_stokes
    assert run["counts"] == tuple(jax_run["counts"])
    assert rel(ns.solution[0], jax_run["final"]["solution_u"]) <= 1e-9
    assert rel(ns.solution[1], jax_run["final"]["solution_p"]) <= 1e-9


def test_load_state_refuses_other_periodic_axes(jax_run):
    arrays = dict(jax_run["arrays0"])
    arrays["periodic"] = np.zeros_like(arrays["periodic"])
    problem = tpc.PeriodicChannelProblem(
        TParams.from_string(PRM), out=io.StringIO(), device="cpu"
    )
    problem.setup()
    with pytest.raises(ValueError, match="periodic"):
        load_state(problem.navier_stokes, from_jax_state(arrays, "cpu"))
