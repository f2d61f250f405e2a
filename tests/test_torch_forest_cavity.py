"""The adaptive loop on the forest, the port against the JAX package,
float64 on the CPU: the driven cavity of tests/test_forest_navier_stokes.py
(applications/drivencavity.py: 2 x 2 roots, 8 x 8 cells, Q2/Q1, stationary
Navier-Stokes, one adaptive round: a solve, the Kelly pressure indicators,
refine_and_coarsen_fixed_number, adapt_mesh with the solution carried
over, a solve on the new mesh, and one more adaptation), run once per
package for the module.

The same printed output, cells per round, flags and (Newton, Krylov)
counts; the test's own checks (two converged solves, more cells after the
round, the finest cells near the lid, hanging rows); the final state within
1e-10; and the JAX state after the adaptations carried into the port
(state.load_state), which refuses a solver whose forest has other cells,
and stepped on as the port's own state is."""

import io

import numpy as np
import pytest
import torch

from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.state import from_jax_state, load_state, state_arrays
from torch_forest_cases import fresh

torch.set_num_threads(2)

PRM = """
subsection Time stepping
  set end time = 1
  set step size = 1
end
subsection Navier-Stokes
  set physical type      = incompressible stationary
  set dimension          = 2
  set global refinements = 8
  set adaptive refinements = 1
  set velocity degree    = 2
  set viscosity          = 0.05
  subsection Solver
    set NL max iterations  = 15
    set NL tolerance       = 1.e-8
    set lin max iterations = 150
    set lin tolerance      = 1.e-4
  end
end
subsection Output options
  set output verbosity = 1
end
"""
TOL = 1e-10


def run(package):
    import importlib

    Params = JParams if package == "adaflo_tpu" else TParams
    par = Params.from_string(PRM)
    par.output_filename = ""
    mod = importlib.import_module(f"{package}.applications.drivencavity")
    out = io.StringIO()
    if package == "adaflo_tpu":
        fresh(None)  # the JAX forest's neighbor lookup renewed (F16)
        problem = mod.DrivenCavityProblem(par, out=out)
    else:
        problem = mod.DrivenCavityProblem(par, out=out, device="cpu")
    ns = problem.navier_stokes
    counts, flags = [], []
    advance, adapt = ns.advance_time_step, ns.adapt_mesh

    def counted():
        c = advance()
        counts.append((int(c[0]), int(c[1])))
        return c

    def recorded(f):
        flags.append(np.asarray(f).copy())
        if package == "adaflo_tpu":
            fresh(None)
        return adapt(f)

    ns.advance_time_step, ns.adapt_mesh = counted, recorded
    route0 = dict(tns.PLAIN_ROUTE_APPLIES)
    if package == "adaflo_tpu":
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
            mp.setenv("ADAFLO_FUSED_NEWTON", "0")
            problem.run()
    else:
        plain0 = dict(cm.plain_calls)
        problem.run()
        assert cm.plain_calls == plain0
    return dict(
        problem=problem, text=out.getvalue(), counts=counts, flags=flags,
        state=state_arrays(ns),
        route={k: v - route0[k] for k, v in tns.PLAIN_ROUTE_APPLIES.items()},
    )


@pytest.fixture(scope="module")
def jax_run():
    return run("adaflo_tpu")


@pytest.fixture(scope="module")
def port_run():
    return run("adaflo_tpu_torch")


def test_cavity_loop_matches_jax(jax_run, port_run):
    text = port_run["text"]
    assert text == jax_run["text"]
    assert port_run["counts"] == jax_run["counts"] and len(port_run["counts"]) == 2
    assert len(port_run["flags"]) == len(jax_run["flags"]) == 2
    for a, b in zip(port_run["flags"], jax_run["flags"]):
        assert np.array_equal(a, b) and (a == 1).any()
    # the JAX package's test's checks
    assert text.count("conv.]") == 2
    cells = [int(ln.split(":")[1].strip(" .")) for ln in text.splitlines()
             if "active cells" in ln]
    assert len(cells) == 2 and cells[1] > cells[0]
    ns = port_run["problem"].navier_stokes
    assert len(ns.u_space.hanging_slave) > 0
    fine = ns.mesh.cell_geometry()[0][ns.u_space.levels == ns.u_space.levels.max()]
    assert np.median(fine[:, 1]) > 0.5
    assert port_run["route"]["vmult"] > 0


def test_cavity_final_state_matches_jax(jax_run, port_run):
    """After the second adaptation: the same forest, constraint sets and
    carried-over solution vectors (1e-10 of the largest entry)."""
    mine, ref = port_run["state"], jax_run["state"]
    assert set(mine) == set(ref)
    scale = np.abs(ref["solution_u"]).max()
    for key in ref:
        if key.startswith(("constrained_", "forest_")) or key == "periodic":
            assert np.array_equal(mine[key], ref[key]), key
        elif key.startswith("solution"):
            assert np.abs(mine[key] - ref[key]).max() <= TOL * scale, key


def test_jax_state_after_adaptation_steps_in_the_port(jax_run, port_run):
    """The JAX solver's state after the adaptations, loaded into the port
    solver on the same forest, steps on as the port's own state does: the
    same counts and a solution within 1e-10. A port solver on another
    forest refuses it."""
    ns = port_run["problem"].navier_stokes
    own = state_arrays(ns)
    ns.time_stepping.restart()
    own_counts = ns.advance_time_step()
    own_u = ns.solution[0].clone()

    load_state(ns, from_jax_state(own, "cpu"))
    load_state(ns, from_jax_state(jax_run["state"], "cpu"))
    ns.time_stepping.restart()
    assert ns.advance_time_step() == own_counts
    scale = float(own_u.abs().max())
    assert float((ns.solution[0] - own_u).abs().max()) <= TOL * scale

    from adaflo_tpu_torch.applications.drivencavity import DrivenCavityProblem

    par = TParams.from_string(PRM)
    other = DrivenCavityProblem(par, out=io.StringIO(), device="cpu").navier_stokes
    other.setup_problem()
    with pytest.raises(ValueError, match="forest"):
        load_state(other, from_jax_state(jax_run["state"], "cpu"))
