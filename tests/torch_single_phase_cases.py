"""Shared runs of the test_torch_single_phase_*.py files: a single-phase
driver of the JAX package and its port on the same prm, a few steps each,
float64 on the CPU.

The JAX side runs its einsum operator (ADAFLO_PALLAS_MATVEC=0) and the
step-by-step Newton loop (ADAFLO_FUSED_NEWTON=0), the loop the port has;
each driver's `run` goes to `end time` = start + steps x step size. Each
run records the (Newton, Krylov) counts of every step, the printed text and
the final state (state.state_arrays)."""

import importlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import navier_stokes as tops
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.state import state_arrays
from adaflo_tpu_torch.testing import normalize_output, numdiff_lines

torch.set_num_threads(2)

PRMS = Path(__file__).parent / "prms"
CLASSES = {"couette": "CouetteProblem", "poiseuille": "ChannelProblem", "flow_1d": "ChannelFlow"}


def run(package, driver, prm, steps, **overrides):
    """Run `driver` of `package` ("adaflo_tpu" or "adaflo_tpu_torch") on
    tests/prms/<prm>.prm for `steps` steps; returns dict(text, counts,
    state, states (after each step), problem, plain, plain_route)."""
    Params = JParams if package == "adaflo_tpu" else TParams
    states = []
    par = Params.from_file(str(PRMS / f"{prm}.prm"))
    for key, val in overrides.items():
        setattr(par, key, val)
    par.end_time = par.start_time + steps * par.time_step_size_start
    mod = importlib.import_module(f"{package}.drivers.{driver}")
    out = io.StringIO()
    kw = {} if package == "adaflo_tpu" else {"device": "cpu"}
    problem = getattr(mod, CLASSES[driver])(par, out=out, **kw)
    ns = problem.navier_stokes
    counts = []
    advance = ns.advance_time_step

    def counted():
        c = advance()
        counts.append((int(c[0]), int(c[1])))
        states.append(state_arrays(ns))
        return c

    ns.advance_time_step = counted
    plain0 = dict(cm.plain_calls)
    route0 = dict(tops.PLAIN_ROUTE_APPLIES)
    if package == "adaflo_tpu":
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
            mp.setenv("ADAFLO_FUSED_NEWTON", "0")
            problem.run()
    else:
        problem.run()
    return dict(
        text=out.getvalue(), counts=counts, state=state_arrays(ns), states=states,
        problem=problem,
        plain={k: cm.plain_calls[k] - plain0[k] for k in plain0},
        plain_route={k: tops.PLAIN_ROUTE_APPLIES[k] - route0[k] for k in route0},
    )


def check_against_jax(jax_run, port_run, steps, tol=1e-10, updates=True):
    """The same printed output (the numdiff tolerances of the goldens), the
    same Newton and Krylov counts step for step and the same final state:
    the constraint sets equal, every vector within `tol` times the largest
    entry of the JAX solution (u and p: a vector that is zero in exact
    arithmetic, couette's pressure or the last Newton update, holds only
    rounding noise of the solution's size). updates=False leaves out the
    last update, where the two solves agree only to their linear tolerance."""
    assert len(port_run["counts"]) == len(jax_run["counts"]) == steps
    assert port_run["counts"] == jax_run["counts"]
    assert numdiff_lines(
        normalize_output(port_run["text"]), normalize_output(jax_run["text"])
    ) == []
    mine, ref = port_run["state"], jax_run["state"]
    scale = max(np.abs(ref["solution_u"]).max(), np.abs(ref["solution_p"]).max())
    for key in ref:
        if key.startswith("constrained_") or key == "periodic":
            assert np.array_equal(mine[key], ref[key]), key
        elif key.startswith("solution_update") and not updates:
            continue
        elif key.startswith(("solution", "user_rhs")):
            assert mine[key].shape == ref[key].shape, key
            assert np.abs(mine[key] - ref[key]).max() <= tol * scale, key


def kernel_route(port_run):
    """'kernel' when only the coupled cell apply's plain versions served the
    mat-vecs, 'einsum' when only the plain cell route did."""
    plain = {k: v for k, v in port_run["plain"].items() if v}
    route = {k: v for k, v in port_run["plain_route"].items() if v}
    if plain and not route:
        assert set(plain) == {"coupled_apply_plain"}
        return "kernel"
    if route and not plain:
        return "einsum"
    return f"mixed {plain} {route}"
