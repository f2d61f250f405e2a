"""Augmented Taylor-Hood (FE_Q_DG0 pressure) on the lattice, the port's
Beltrami driver against the JAX package's on the same prm, float64 on the
CPU:

- beltrami_2d_augp_small (2D Taylor vortex, Q3/Q2+, 16 x 16 cells, coupled
  implicit Newton), its first step;
- beltrami_2d_augp_proj_small (the same with the projection scheme), two
  steps: the second reads the pressure extrapolation of the first.

Each: equal Newton and Krylov counts in every step, the printed output
under numdiff_lines (the goldens' tolerances, directly against JAX's
output: the golden compare of tests/golden is loose on small values,
ROADMAP F4), the constraint sets equal and every state vector within
1e-10 of the largest entry of the JAX solution
(torch_single_phase_cases.check_against_jax). The JAX side runs its einsum
operator and its step-by-step Newton loop (ADAFLO_PALLAS_MATVEC=0,
ADAFLO_FUSED_NEWTON=0). The goldens themselves are
test_torch_lattice_goldens.py."""

import importlib
import io

import pytest
import torch

from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.state import state_arrays
from torch_single_phase_cases import PRMS, JParams, TParams, check_against_jax

torch.set_num_threads(2)


def run(package, prm, steps):
    """The Beltrami driver of `package` on tests/prms/<prm>.prm for `steps`
    steps: dict(text, counts, state, problem, plain, plain_route). The
    driver's step is init_time_advance + evaluate_time_step, so the counts
    are taken around the latter."""
    Params = JParams if package == "adaflo_tpu" else TParams
    par = Params.from_file(str(PRMS / f"{prm}.prm"))
    par.end_time = par.start_time + steps * par.time_step_size_start
    mod = importlib.import_module(f"{package}.drivers.beltrami")
    out = io.StringIO()
    kw = {} if package == "adaflo_tpu" else {"device": "cpu"}
    problem = mod.BeltramiProblem(par, out=out, **kw)
    ns = problem.navier_stokes
    counts = []
    evaluate = ns.evaluate_time_step

    def counted():
        c = evaluate()
        counts.append((int(c[0]), int(c[1])))
        return c

    ns.evaluate_time_step = counted
    plain0, route0 = dict(cm.plain_calls), dict(tns.PLAIN_ROUTE_APPLIES)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
        mp.setenv("ADAFLO_FUSED_NEWTON", "0")
        problem.run()
    return dict(
        text=out.getvalue(), counts=counts, state=state_arrays(ns), problem=problem,
        plain={k: cm.plain_calls[k] - plain0[k] for k in plain0},
        plain_route={k: tns.PLAIN_ROUTE_APPLIES[k] - route0[k] for k in route0},
    )


@pytest.mark.parametrize(
    "prm, steps", [("beltrami_2d_augp_small", 1), ("beltrami_2d_augp_proj_small", 2)],
    ids=["newton", "projection"],
)
def test_matches_jax(prm, steps):
    jax_run = run("adaflo_tpu", prm, steps)
    port_run = run("adaflo_tpu_torch", prm, steps)
    check_against_jax(jax_run, port_run, steps)
    assert "Q3/Q2+ elements" in port_run["text"]
    ns = port_run["problem"].navier_stokes
    assert ns.n_dofs == (4802, 1345) and ns.solution[1].shape == (1345,)
    # the plain cell route alone: no Pallas table set in JAX, no kernel here
    assert not any(port_run["plain"].values())
    assert port_run["plain_route"]["velocity_vmult"] > 0
