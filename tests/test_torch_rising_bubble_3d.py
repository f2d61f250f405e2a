"""The port's 3D rising bubble against the JAX package, float64 on the CPU:
tests/prms/rising_bubble_ls_3d_bench.prm with `global refinements = 0` on
a box of 4 cells a side built as the driver's flagship mesh (symmetry on
the four side faces, no-slip on the bottom and top, the pressure fixed),
3 steps. Held: equal Newton and Krylov counts in every step, the printed
output under numdiff_lines, the 3D bubble statistics (volume, surface area,
mean velocity, centre of mass, sphericity) of every step to 1e-9 relative
with an absolute floor of 1e-12 (the x and y velocities of the centred
bubble are round-off, about 1e-11), and the final fields to 1e-9 relative.

The JAX side compiles its whole unfused step once (about 150 s on one core
with a cold compile cache), so the test is marked slow. It runs on its
einsum operator (ADAFLO_PALLAS_MATVEC=0), with the step-by-step Newton loop
(ADAFLO_FUSED_NEWTON=0) and `_pre_newton_eligible` patched to False on the
instance. Run: ADAFLO_RUN_SLOW=1 python -m pytest -m slow
tests/test_torch_rising_bubble_3d.py"""

import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from adaflo_tpu.drivers import rising_bubble as jrb
from adaflo_tpu.functions import ZeroFunction as JZero
from adaflo_tpu.mesh.structured import StructuredMesh as JMesh
from adaflo_tpu.twophase.level_set_okz import LevelSetOKZSolver as JSolver
from adaflo_tpu_torch.drivers import rising_bubble as trb
from adaflo_tpu_torch.state import state_arrays
from adaflo_tpu_torch.testing import normalize_output, numdiff_lines

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        os.environ.get("ADAFLO_RUN_SLOW") is None, reason="set ADAFLO_RUN_SLOW=1"
    ),
]

torch.set_num_threads(2)

PRM = (
    (Path(__file__).parent / "prms" / "rising_bubble_ls_3d_bench.prm")
    .read_text()
    .replace("set global refinements   = 3", "set global refinements   = 0")
)
assert "global refinements   = 0" in PRM
N, STEPS = 4, 3


def rel(got, ref):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def stats_close(got, ref, tol=1e-9, floor=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    return bool(np.all(np.abs(got - ref) <= np.maximum(tol * np.abs(ref), floor)))


def test_rising_bubble_3d_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAFLO_PALLAS_MATVEC", "0")
    monkeypatch.setenv("ADAFLO_FUSED_NEWTON", "0")
    prm = tmp_path / "rb3.prm"
    prm.write_text(PRM)
    mesh = JMesh.subdivided_hyper_rectangle((N,) * 3, (0.0,) * 3, (1.0,) * 3)
    eps = 1e-14
    mesh.set_boundary_id(
        lambda c: (np.abs(c[:, 0] - 1) < eps) | (np.abs(c[:, 0]) < eps)
        | (np.abs(c[:, 1] - 1) < eps) | (np.abs(c[:, 1]) < eps),
        2,
    )
    jout = io.StringIO()
    js = JSolver(jrb.TwoPhaseParameters.from_file(str(prm)), mesh, out=jout)
    js._pre_newton_eligible = lambda: False
    js.set_no_slip_boundary(0)
    js.fix_pressure_constant(0)
    js.set_symmetry_boundary(2)
    js.setup_problem(JZero(3), jrb.initial_distance)
    jstats = [js.compute_bubble_statistics(0)]
    jcounts = []
    for _ in range(STEPS):
        jcounts.append(tuple(int(x) for x in js.advance_time_step()))
        jstats.append(js.compute_bubble_statistics())
    ref = state_arrays(js)

    tout = io.StringIO()
    problem = trb.MicroFluidicProblem(
        trb.TwoPhaseParameters.from_string(PRM), out=tout, device="cpu",
        mesh=trb.flagship_mesh_3d(N),
    )
    problem.setup()
    tcounts = [tuple(int(x) for x in problem.step()) for _ in range(STEPS)]

    assert tcounts == jcounts
    assert numdiff_lines(normalize_output(tout.getvalue()), normalize_output(jout.getvalue())) == []
    for got, want in zip(problem.solution_data, jstats):
        assert len(got) == 10 and stats_close(got, want), (got, want)
    s = problem.solver
    assert rel(s.navier_stokes.solution[0], ref["solution_u"]) <= 1e-9
    assert rel(s.navier_stokes.solution[1], ref["solution_p"]) <= 1e-9
    assert rel(s.solution[0], ref["ls:solution_c"]) <= 1e-9
