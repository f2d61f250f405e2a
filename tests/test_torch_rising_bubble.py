"""The port's rising bubble (conservative level set, symmetry sides,
variable density and viscosity) against the JAX package, float64 on the
CPU.

- A smaller case, the same prm at `global refinements = 1` (10 x 20 cells)
  with 2 concentration subdivisions, 2 steps and `lin velocity
  preconditioner = ilu`, run by both packages: equal
  Newton and Krylov counts in every step, the printed output under
  numdiff_lines, the bubble statistics of every step to 1e-9 relative (an
  absolute floor of 1e-12: the x velocity of the symmetric bubble is
  round-off, about 1e-11), and the final velocity, pressure,
  concentration, curvature, density and viscosity and the maximal velocity
  to 1e-9 relative.
- The state carry: the JAX state after step 1, loaded into a port solver
  set up on the same case (state.from_jax_state, load_state), gives JAX's
  step 2: counts, statistics and fields as above.
The JAX side runs once per module on its einsum operator
(ADAFLO_PALLAS_MATVEC=0), with the step-by-step Newton loop
(ADAFLO_FUSED_NEWTON=0) and its unfused step (`_pre_newton_eligible`
patched to False on the instance): the fused pre-Newton program of later
steps is a dispatch fusion of the same arithmetic that the port does not
have. The velocity preconditioner setting only chooses between the
Chebyshev and the velocity GMG of a constant-coefficient block: with
variable coefficients both packages apply the Chebyshev either way, and
`ilu` spares the JAX side the compile of GMG levels it never reads (about
30 s on one core). The 3D comparison is test_torch_rising_bubble_3d.py,
the golden of the full-size short case test_torch_rising_bubble_golden.py."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

from adaflo_tpu.drivers import rising_bubble as jrb
from adaflo_tpu.functions import ZeroFunction as JZero
from adaflo_tpu_torch.drivers import rising_bubble as trb
from adaflo_tpu_torch.state import from_jax_state, load_state, state_arrays
from adaflo_tpu_torch.testing import normalize_output, numdiff_lines

torch.set_num_threads(2)

HERE = Path(__file__).parent
SHORT = HERE / "prms" / "rising_bubble_ls_short.prm"
SMALL = (
    SHORT.read_text()
    .replace("set global refinements   = 2", "set global refinements   = 1")
    .replace("set concentration subdivisions = 4", "set concentration subdivisions = 2")
    .replace("set end time         = 0.06", "set end time         = 0.04")
    .replace("  subsection Solver\n", "  subsection Solver\n    set lin velocity preconditioner = ilu\n")
)
assert "global refinements   = 1" in SMALL and "subdivisions = 2" in SMALL
assert "end time         = 0.04" in SMALL and "preconditioner = ilu" in SMALL


def rel(got, ref):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def stats_close(got, ref, tol=1e-9, floor=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return bool(np.all(np.abs(got - ref) <= np.maximum(tol * np.abs(ref), floor)))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    prm = tmp_path_factory.mktemp("rb") / "small.prm"
    prm.write_text(SMALL)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
        mp.setenv("ADAFLO_FUSED_NEWTON", "0")
        problem = jrb.MicroFluidicProblem(jrb.TwoPhaseParameters.from_file(str(prm)), out=out)
        s = problem.solver
        s._pre_newton_eligible = lambda: False
        s.set_no_slip_boundary(0)
        s.fix_pressure_constant(0)
        s.set_symmetry_boundary(2)
        s.setup_problem(JZero(2), jrb.initial_distance)
        stats = [s.compute_bubble_statistics(0)]
        counts, states = [], [state_arrays(s)]
        while not s.get_time_stepping().at_end():
            counts.append(tuple(int(x) for x in s.advance_time_step()))
            stats.append(s.compute_bubble_statistics())
            states.append(state_arrays(s))
        maxvel = s.get_maximal_velocity()
    return dict(text=out.getvalue(), stats=stats, counts=counts, states=states, maxvel=maxvel)


def _port_problem():
    out = io.StringIO()
    par = trb.TwoPhaseParameters.from_string(SMALL)
    problem = trb.MicroFluidicProblem(par, out=out, device="cpu")
    problem.setup()
    return problem, out


@pytest.fixture(scope="module")
def port_run():
    problem, out = _port_problem()
    counts = []
    while not problem.solver.get_time_stepping().at_end():
        counts.append(tuple(int(x) for x in problem.step()))
    return dict(text=out.getvalue(), stats=problem.solution_data, counts=counts,
                solver=problem.solver)


def test_counts_and_statistics_match_jax(jax_run, port_run):
    assert len(port_run["counts"]) == len(jax_run["counts"]) == 2
    assert port_run["counts"] == jax_run["counts"]
    assert numdiff_lines(normalize_output(port_run["text"]), normalize_output(jax_run["text"])) == []
    assert port_run["text"].count("Time step #") == 2
    assert port_run["text"].count("/ILU") == 2
    for got, ref in zip(port_run["stats"], jax_run["stats"]):
        assert stats_close(got, ref), (got, ref)


def test_final_fields_match_jax(jax_run, port_run):
    ref = jax_run["states"][-1]
    s = port_run["solver"]
    ns = s.navier_stokes
    assert rel(ns.solution[0], ref["solution_u"]) <= 1e-9
    assert rel(ns.solution[1], ref["solution_p"]) <= 1e-9
    assert rel(s.solution[0], ref["ls:solution_c"]) <= 1e-9
    assert rel(s.solution[1], ref["ls:solution_k"]) <= 1e-9
    assert rel(ns.coefficients.rho, ref["coefficients_rho"]) <= 1e-9
    assert rel(ns.coefficients.mu, ref["coefficients_mu"]) <= 1e-9
    assert abs(s.get_maximal_velocity() - jax_run["maxvel"]) <= 1e-9 * jax_run["maxvel"]


def test_step_from_jax_state(jax_run):
    problem, out = _port_problem()
    s = problem.solver
    carried = jax_run["states"][1]
    load_state(s, from_jax_state(carried, "cpu"))
    assert rel(s.solution[0], carried["ls:solution_c"]) == 0.0
    assert s.time_stepping.step_no() == 1
    counts = tuple(int(x) for x in problem.step())
    assert counts == jax_run["counts"][1]
    assert stats_close(problem.solution_data[-1], jax_run["stats"][2])
    ref = jax_run["states"][2]
    assert rel(s.navier_stokes.solution[0], ref["solution_u"]) <= 1e-9
    assert rel(s.navier_stokes.solution[1], ref["solution_p"]) <= 1e-9
    assert rel(s.solution[0], ref["ls:solution_c"]) <= 1e-9
    assert rel(s.evaluated_normal_q, ref["ls:evaluated_normal_q"]) <= 1e-9
