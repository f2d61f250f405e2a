"""One coupled-Newton time step of tests/prms/beltrami_3d.prm at
global refinements = 1 (64 cells, 2,312 dofs): the JAX driver against the
port's driver on the CPU (device="cpu").

The JAX side runs once per module, on its einsum path
(ADAFLO_PALLAS_MATVEC=0) and with the step-by-step Newton loop
(ADAFLO_FUSED_NEWTON=0; it prints the same table as the fused loop and
compiles faster). Held: the printed output under the port's numdiff_lines,
the Newton iteration count, the preconditioner state of the step (1e-10
relative: power-iteration and Lanczos estimates after identical inputs),
and the final solution to 1e-9 relative, both from the port's own setup and
from the JAX state carried across with from_jax_state."""

import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaflo_tpu.drivers import beltrami as jb
from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu.utils.errors import interpolate as jinterpolate
from adaflo_tpu_torch.drivers import beltrami as tb
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.state import from_jax_state, load_state, state_arrays
from adaflo_tpu_torch.testing import normalize_output, numdiff_lines

torch.set_num_threads(2)

PRM = (
    (Path(__file__).parent / "prms" / "beltrami_3d.prm")
    .read_text()
    .replace("set global refinements = 3", "set global refinements = 1")
    .replace("set end time  = 1", "set end time  = 0.05")
)
assert "global refinements = 1" in PRM and "end time  = 0.05" in PRM


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
        # the state at t = 0 as the JAX driver sets it up, before its step
        start = jb.BeltramiProblem(JParams.from_string(PRM), out=io.StringIO())
        ns, nu = start.navier_stokes, start.nu
        ns.set_velocity_dirichlet_boundary(0, lambda x, t: jb.exact_u(nu, 3)(x, t))
        ns.fix_pressure_constant(0, lambda x, t: jb.exact_p(nu, 3)(x, t))
        ns.setup_problem()
        ns.solution[0] = jnp.asarray(jinterpolate(ns.u_space, jb.exact_u(nu, 3)))
        ns.solution[1] = jnp.asarray(jinterpolate(ns.p_space, jb.exact_p(nu, 3)))
        arrays0 = state_arrays(ns)
        out = io.StringIO()
        problem = jb.BeltramiProblem(JParams.from_string(PRM), out=out)
        problem.run()
    ns = problem.navier_stokes
    return dict(
        text=out.getvalue(), arrays0=arrays0, final=state_arrays(ns),
        prec=ns._prec_state,
    )


@pytest.fixture(scope="module")
def port_run():
    out = io.StringIO()
    problem = tb.BeltramiProblem(TParams.from_string(PRM), out=out, device="cpu")
    problem.run()
    return dict(text=out.getvalue(), ns=problem.navier_stokes)


def _newton_rows(text):
    return [ln for ln in text.splitlines() if ln.startswith("   ") and "e" in ln and "Resid" not in ln]


def test_printed_output_matches_jax(jax_run, port_run):
    got = normalize_output(port_run["text"])
    expect = normalize_output(jax_run["text"])
    assert numdiff_lines(got, expect) == []
    assert len(_newton_rows(port_run["text"])) == len(_newton_rows(jax_run["text"])) >= 3
    assert "converged." in port_run["text"]


def test_final_solution_matches_jax(jax_run, port_run):
    ns = port_run["ns"]
    assert rel(ns.solution[0], jax_run["final"]["solution_u"]) <= 1e-9
    assert rel(ns.solution[1], jax_run["final"]["solution_p"]) <= 1e-9


def test_preconditioner_state_matches_jax(jax_run, port_run):
    jst, tst = jax_run["prec"], port_run["ns"]._prec_state
    for name in ("u_diag", "poisson_diag", "mass_diag", "mass_diag_w"):
        assert rel(getattr(tst, name), getattr(jst, name)) <= 1e-10, name
    for name in ("u_lambda_max", "poisson_lambda_max", "u_cheb_growth"):
        assert rel(np.float64(getattr(tst, name)), getattr(jst, name)) <= 1e-10, name
    for tg, jg in zip(tst.u_gmg + (tst.p_gmg,), jst.u_gmg + (jst.p_gmg,)):
        for tl, jl in zip(tg.levels, jg.levels):
            assert rel(tl.diag, jl.diag) <= 1e-10
            assert rel(np.float64(tl.lmax), jl.lmax) <= 1e-10
        assert rel(tg.coarse_matrix, jg.coarse_matrix) <= 1e-10


def test_step_from_jax_state(jax_run):
    problem = tb.BeltramiProblem(TParams.from_string(PRM), out=io.StringIO(), device="cpu")
    problem.setup()
    ns = problem.navier_stokes
    load_state(ns, from_jax_state(jax_run["arrays0"], "cpu"))
    assert rel(ns.solution[0], jax_run["arrays0"]["solution_u"]) == 0.0
    newton, krylov = problem.step()
    assert newton >= 3 and krylov > 0
    assert rel(ns.solution[0], jax_run["final"]["solution_u"]) <= 1e-9
    assert rel(ns.solution[1], jax_run["final"]["solution_p"]) <= 1e-9
