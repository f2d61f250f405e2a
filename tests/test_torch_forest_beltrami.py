"""The 2D Taylor vortex on the reference's locally refined forest
(drivers/beltrami.py: 4 x 4 roots, cells 2 and 3 refined before the last
global refinement, hanging nodes), the port against the JAX package and
the goldens, float64 on the CPU.

- beltrami_2d_small (280 cells, Q3/Q2, 3 coupled-Newton BDF-2 steps) runs
  once per package for the module: the same Newton and Krylov counts in
  every step, the states after the first step and at the end within 1e-10
  of the largest solution entry, the printed output line by line against
  the JAX driver's at a tight tolerance (ROADMAP.md F4: the golden compare
  is loose on iteration-scrubbed lines), and the golden;
- beltrami_2d_proj_small (the projection scheme) against its golden;
- the t = 0 anchors of the reference's 1048-cell Q4/Q3 mesh
  (beltrami_2d.output, tests/test_golden_ns.py): cells, dofs, the four
  error digits and the divergence; and that mesh's two steps of
  chip_smoke.py's full-width forest path, whose Newton and Krylov counts
  the card must repeat (chip_smoke.FOREST_COUNTS).

The JAX side runs its einsum operator and step-by-step Newton loop
(ADAFLO_PALLAS_MATVEC=0, ADAFLO_FUSED_NEWTON=0), as the port does; every
forest apply takes the port's plain cell route."""

import importlib
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.state import state_arrays
from adaflo_tpu_torch.testing import compare_with_golden
from torch_forest_cases import fresh

torch.set_num_threads(2)

HERE = Path(__file__).parent
TOL = 1e-10


def run(package, prm):
    """Run the Beltrami driver of `package` on tests/prms/<prm>.prm: the
    printed text, the (Newton, Krylov) counts and state of each step, the
    plain-version calls and plain-route applies."""
    Params = JParams if package == "adaflo_tpu" else TParams
    par = Params.from_file(str(HERE / "prms" / f"{prm}.prm"))
    mod = importlib.import_module(f"{package}.drivers.beltrami")
    out = io.StringIO()
    kw = {} if package == "adaflo_tpu" else {"device": "cpu"}
    if package == "adaflo_tpu":
        fresh(None)  # the JAX forest's neighbor lookup renewed (F16)
    problem = mod.BeltramiProblem(par, out=out, **kw)
    ns = problem.navier_stokes
    counts, states = [], []
    evaluate = ns.evaluate_time_step

    def counted():
        c = evaluate()
        counts.append((int(c[0]), int(c[1])))
        states.append(state_arrays(ns))
        return c

    ns.evaluate_time_step = counted
    plain0, route0 = dict(cm.plain_calls), dict(tns.PLAIN_ROUTE_APPLIES)
    if package == "adaflo_tpu":
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
            mp.setenv("ADAFLO_FUSED_NEWTON", "0")
            problem.run()
    else:
        problem.run()
    return dict(
        text=out.getvalue(), counts=counts, states=states,
        plain={k: v - plain0[k] for k, v in cm.plain_calls.items() if v > plain0[k]},
        route={k: v - route0[k] for k, v in tns.PLAIN_ROUTE_APPLIES.items()},
    )


@pytest.fixture(scope="module")
def jax_run():
    return run("adaflo_tpu", "beltrami_2d_small")


@pytest.fixture(scope="module")
def port_run():
    return run("adaflo_tpu_torch", "beltrami_2d_small")


def test_taylor_vortex_steps_match_jax(jax_run, port_run):
    """The same counts in each of the three steps; the hanging-node
    constraint sets, the forest's cells and the states after the first step
    and at the end equal within 1e-10 of the largest solution entry; the
    plain cell route served every apply, no kernel entry ran."""
    assert len(port_run["counts"]) == 3
    assert port_run["counts"] == jax_run["counts"]
    for mine, ref in ((port_run["states"][0], jax_run["states"][0]),
                      (port_run["states"][-1], jax_run["states"][-1])):
        assert ref["forest_levels"].max() == 3  # roots at level 0
        scale = max(np.abs(ref["solution_u"]).max(), np.abs(ref["solution_p"]).max())
        for key in ref:
            if key.startswith(("constrained_", "forest_")) or key == "periodic":
                assert np.array_equal(mine[key], ref[key]), key
            elif key.startswith(("solution", "user_rhs")):
                assert mine[key].shape == ref[key].shape, key
                assert np.abs(mine[key] - ref[key]).max() <= TOL * scale, key
    assert not port_run["plain"]
    assert port_run["route"]["vmult"] > 0 and port_run["route"]["velocity_vmult"] > 0


_NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def test_printed_output_matches_jax_line_by_line(jax_run, port_run):
    """Every line as the JAX driver prints it: the same words and
    iteration counts, every number within one unit of its last printed
    digit (relative 2e-3 at 4 digits), or both below 1e-12 (the round-off
    of a divergence that is zero in exact arithmetic)."""
    got, ref = port_run["text"].splitlines(), jax_run["text"].splitlines()
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert _NUM.sub("#", g) == _NUM.sub("#", r), (g, r)
        for a, b in zip(_NUM.findall(g), _NUM.findall(r)):
            x, y = float(a), float(b)
            assert x == y or abs(x - y) <= 2e-3 * max(abs(x), abs(y)) or (
                abs(x) < 1e-12 and abs(y) < 1e-12
            ), (g, r)


@pytest.mark.parametrize("golden", ["beltrami_2d_small", "beltrami_2d_proj_small"])
def test_forest_golden(golden, port_run):
    """The port's driver against tests/golden/<prm>.output with the port's
    compare_with_golden; the plain cell route alone."""
    r = port_run if golden == "beltrami_2d_small" else run("adaflo_tpu_torch", golden)
    compare_with_golden(r["text"], HERE / "golden" / f"{golden}.output")
    assert r["text"].count("Time step #") == 3
    assert not r["plain"] and r["route"]["velocity_vmult"] > 0


def test_reference_amr_mesh_t0_anchors():
    """The reference's 1048-cell mesh at global refinements = 4, velocity
    degree 4 (tests/test_golden_ns.py:229-289 for the JAX package): its
    cells and dofs, and the t = 0 interpolation errors to the reference's
    digits (9.507e-09 / 8.461e-12, relative 2.291e-08 / 9.877e-12,
    divergence below 1e-14)."""
    from adaflo_tpu_torch.drivers.beltrami import BeltramiProblem, exact_p, exact_u
    from adaflo_tpu_torch.utils.errors import (
        cell_divergence_norm,
        interpolate,
        l2_error,
        l2_norm,
    )

    par = TParams.from_string(
        "subsection Navier-Stokes\n  set dimension = 2\n  set global refinements = 4\n"
        "  set velocity degree = 4\nend\n"
    )
    prob = BeltramiProblem(par, out=io.StringIO(), device="cpu")
    ns = prob.navier_stokes
    ns.set_velocity_dirichlet_boundary(0, lambda x, t: exact_u(1.0, 2)(x, t))
    ns.fix_pressure_constant(0, lambda x, t: exact_p(1.0, 2)(x, t))
    ns.setup_problem()
    assert prob.mesh.n_cells == 1048
    assert ns.n_dofs == (34158, 9663)
    u = torch.tensor(interpolate(ns.u_space, exact_u(1.0, 2)))
    p = torch.tensor(interpolate(ns.p_space, exact_p(1.0, 2)))
    ep = l2_error(ns.p_space, p, exact_p(1.0, 2), 0.0, 6)
    eu = l2_error(ns.u_space, u, exact_u(1.0, 2), 0.0, 6, n_components=2)
    assert abs(ep - 9.507e-09) < 5e-13, ep
    assert abs(eu - 8.461e-12) < 5e-15, eu
    assert cell_divergence_norm(ns.u_space, u) < 1e-14
    assert abs(ep / l2_norm(ns.p_space, p, 4) - 2.291e-08) < 1e-11
    assert abs(eu / l2_norm(ns.u_space, u, 4, n_components=2) - 9.877e-12) < 5e-15


def test_reference_amr_mesh_steps_hold_chip_smoke_counts():
    """chip_smoke.py's full-width forest path (the 1048-cell mesh, Q4/Q3,
    beltrami_2d_small.prm's step size and tolerances, FOREST_STEPS steps)
    on the CPU: its (Newton, Krylov) counts are the ones the script holds
    the card to, and the plain cell route alone runs."""
    import importlib.util

    from adaflo_tpu_torch.drivers.beltrami import BeltramiProblem

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    problem = BeltramiProblem(smoke.forest_parameters(), out=io.StringIO(), device="cpu")
    problem.setup()
    plain0, route0 = dict(cm.plain_calls), dict(tns.PLAIN_ROUTE_APPLIES)
    counts = [tuple(int(c) for c in problem.step()) for _ in range(smoke.FOREST_STEPS)]
    assert counts == smoke.FOREST_COUNTS["beltrami_2d_1048"]
    assert cm.plain_calls == plain0
    assert tns.PLAIN_ROUTE_APPLIES["velocity_vmult"] > route0["velocity_vmult"]
