"""The port's Q3 rising bubble (rising_bubble_ls_q3_short: 2D, 10 x 20
cells, velocity degree 3, coupled Newton, conservative level set, symmetry
sides) against the JAX package, float64 on the CPU, over its first two
steps: the path of K1/K2's 2D Q3/Q2 instance in its variable-coefficient
mode (their plain versions on the CPU).

Both packages run the prm with `lin velocity preconditioner = ilu`: with
variable coefficients both apply the Chebyshev of the velocity block either
way, and `ilu` spares the JAX side the compile of velocity GMG levels that
it never reads (the golden with the prm as it is, "AMGl" in its labels, is
test_torch_lattice_goldens.py). The JAX side runs its einsum operator
(ADAFLO_PALLAS_MATVEC=0), the step-by-step Newton loop
(ADAFLO_FUSED_NEWTON=0) and its unfused step (`_pre_newton_eligible`
patched to False on the instance). Compared: the Newton and Krylov counts
of each step, the printed output under numdiff_lines, the bubble
statistics of every step to 1e-9 relative (an absolute floor of 1e-12),
and the velocity, pressure, concentration and curvature after each step
within 1e-10 of the largest entry of JAX's."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

from adaflo_tpu.drivers import rising_bubble as jrb
from adaflo_tpu.functions import ZeroFunction as JZero
from adaflo_tpu_torch.drivers import rising_bubble as trb
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.state import state_arrays
from adaflo_tpu_torch.testing import normalize_output, numdiff_lines

torch.set_num_threads(2)

HERE = Path(__file__).parent
Q3 = (
    (HERE / "prms" / "rising_bubble_ls_q3_short.prm").read_text()
    .replace("set end time         = 0.06", "set end time         = 0.04")
    .replace("  subsection Solver\n", "  subsection Solver\n    set lin velocity preconditioner = ilu\n")
)
assert "end time         = 0.04" in Q3 and "preconditioner = ilu" in Q3
FIELDS = ("solution_u", "solution_p", "ls:solution_c", "ls:solution_k")


def stats_close(got, ref, tol=1e-9, floor=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return bool(np.all(np.abs(got - ref) <= np.maximum(tol * np.abs(ref), floor)))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    prm = tmp_path_factory.mktemp("q3") / "q3.prm"
    prm.write_text(Q3)
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
        counts, states = [], []
        while not s.get_time_stepping().at_end():
            counts.append(tuple(int(x) for x in s.advance_time_step()))
            stats.append(s.compute_bubble_statistics())
            states.append(state_arrays(s))
    return dict(text=out.getvalue(), stats=stats, counts=counts, states=states)


@pytest.fixture(scope="module")
def port_run():
    out = io.StringIO()
    problem = trb.MicroFluidicProblem(trb.TwoPhaseParameters.from_string(Q3), out=out, device="cpu")
    problem.setup()
    plain0, route0 = dict(cm.plain_calls), dict(tns.PLAIN_ROUTE_APPLIES)
    counts, states = [], []
    while not problem.solver.get_time_stepping().at_end():
        counts.append(tuple(int(x) for x in problem.step()))
        states.append(state_arrays(problem.solver))
    return dict(
        text=out.getvalue(), stats=problem.solution_data, counts=counts, states=states,
        solver=problem.solver,
        plain={k: cm.plain_calls[k] - plain0[k] for k in plain0},
        plain_route={k: tns.PLAIN_ROUTE_APPLIES[k] - route0[k] for k in route0},
    )


def test_runs_the_q3_kernel_instance(port_run):
    op = port_run["solver"].navier_stokes.operator
    assert (op.cells.dim, op.cells.degree) == (2, 3)
    masks = op.cells.mask_u
    assert int(masks[0].sum()) != int(masks[1].sum())  # symmetry sides: x only
    # K1/K2's plain versions alone, in variable mode (the level set's rho, mu)
    assert port_run["plain"]["coupled_apply_plain"] > 0
    assert not any(v for k, v in port_run["plain"].items() if k != "coupled_apply_plain")
    assert not any(port_run["plain_route"].values())


def test_counts_output_and_statistics_match_jax(jax_run, port_run):
    assert len(port_run["counts"]) == len(jax_run["counts"]) == 2
    assert port_run["counts"] == jax_run["counts"]
    assert numdiff_lines(normalize_output(port_run["text"]), normalize_output(jax_run["text"])) == []
    assert "4643 (3782 + 861)" in port_run["text"]
    for got, ref in zip(port_run["stats"], jax_run["stats"]):
        assert stats_close(got, ref), (got, ref)


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
def test_state_matches_jax(jax_run, port_run, step):
    mine, ref = port_run["states"][step], jax_run["states"][step]
    for key in FIELDS:
        scale = np.abs(ref[key]).max()
        assert mine[key].shape == ref[key].shape, key
        assert np.abs(mine[key] - ref[key]).max() <= 1e-10 * scale, key
