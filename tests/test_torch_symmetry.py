"""Symmetry boundaries in the port's Navier-Stokes solver against the JAX
package, float64 on the CPU.

- The constraint sets of a 3D box (3 x 2 x 4 cells) with symmetry on the
  four side faces and no-slip on the bottom and top: per velocity component
  the constrained dofs equal the JAX solver's, a symmetry side constrains
  only its normal component (so the sets differ by component), the coupled
  cell apply's masks carry the per-component sets, and the boundary values
  written at the start of a step agree (the symmetry dofs no Dirichlet
  function covers read zero in their normal component only).
- One coupled-Newton BDF-2 time step on a 2D 4 x 4 lattice with symmetry on
  the left and right sides, a moving lid (velocity Dirichlet) on the top,
  no-slip on the bottom and the pressure fixed: the printed residual table,
  the Newton count and the solution to 1e-9 relative. The JAX side runs its
  einsum operator (ADAFLO_PALLAS_MATVEC=0) and the step-by-step Newton loop
  (ADAFLO_FUSED_NEWTON=0)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaflo_tpu.mesh.structured import StructuredMesh as JMesh
from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu.solvers.navier_stokes_solver import NavierStokes as JNS
from adaflo_tpu_torch.mesh.structured import StructuredMesh as TMesh
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes as TNS
from adaflo_tpu_torch.testing import normalize_output, numdiff_lines

torch.set_num_threads(2)

PRM = """
subsection Navier-Stokes
  set dimension = {dim}
  set global refinements = 0
  set velocity degree = 2
  set viscosity = 0.02
  subsection Solver
    set NL max iterations = 10
    set NL tolerance = 1.e-9
    set lin max iterations = 60
    set lin tolerance = 1.e-4
  end
end
subsection Time stepping
  set scheme = bdf_2
  set end time = 0.05
  set step size = 0.05
end
subsection Output options
  set output verbosity = 2
end
"""


def rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _sides(c, eps=1e-14):
    return (
        (np.abs(c[:, 0] - 1) < eps) | (np.abs(c[:, 0]) < eps)
        | (np.abs(c[:, 1] - 1) < eps) | (np.abs(c[:, 1]) < eps)
    )


def _box(Params, Mesh, NS, **kw):
    par = Params.from_string(PRM.format(dim=3))
    mesh = Mesh.subdivided_hyper_rectangle((3, 2, 4), (0.0,) * 3, (1.0,) * 3)
    mesh.set_boundary_id(_sides, 2)
    ns = NS(par, mesh, out=io.StringIO(), **kw)
    ns.set_no_slip_boundary(0)
    ns.fix_pressure_constant(0)
    ns.set_symmetry_boundary(2)
    ns.setup_problem()
    return ns


def test_symmetry_constraint_sets(monkeypatch):
    monkeypatch.setenv("ADAFLO_PALLAS_MATVEC", "0")
    jns = _box(JParams, JMesh, JNS)
    tns = _box(TParams, TMesh, TNS, device="cpu")
    sets = []
    for c in range(3):
        jd = np.asarray(jns.constraints_u[c].constrained_dofs)
        td = np.asarray(tns.constraints_u[c].constrained_dofs)
        np.testing.assert_array_equal(td, jd)
        sets.append(set(td.tolist()))
    walls = set(tns.u_space.boundary_dofs(0).tolist())
    for c in range(3):
        # no-slip rows in every component, a symmetry side's rows only in
        # the component normal to it
        assert walls <= sets[c]
        for axis in range(3):
            side = set(tns.u_space.side_dofs(axis, 0).tolist())
            assert (side <= sets[c]) == (axis == c or axis == 2), (c, axis)
    assert sets[0] != sets[1] and sets[1] != sets[2]
    mask = tns.operator.cells
    for c in range(3):
        np.testing.assert_array_equal(
            np.flatnonzero(mask.mask_u[c].numpy()), sorted(sets[c])
        )
    np.testing.assert_array_equal(
        tns.constraints_schur.constrained_dofs, jns.constraints_schur.constrained_dofs
    )

    # boundary values written at the start of a step
    rng = np.random.default_rng(4)
    u = rng.standard_normal((3, tns.u_space.n_dofs))
    jns.solution[0] = jnp.asarray(u)
    tns.solution[0] = torch.tensor(u)
    jns.apply_boundary_conditions()
    tns.apply_boundary_conditions()
    got, ref = tns.solution[0].numpy(), np.asarray(jns.solution[0])
    np.testing.assert_array_equal(got, ref)
    side_x = tns.u_space.side_dofs(0, 1)
    assert np.all(got[0, side_x] == 0.0) and np.any(got[1, side_x] != 0.0)


def _lid(x, t):
    on_top = np.abs(x[:, 1] - 1.0) < 1e-12
    return np.stack([np.where(on_top, 1.0, 0.0), np.zeros(len(x))])


def _step(Params, Mesh, NS, **kw):
    par = Params.from_string(PRM.format(dim=2))
    mesh = Mesh.subdivided_hyper_rectangle((4, 4), (0.0, 0.0), (1.0, 1.0))
    mesh.set_boundary_id(lambda c: (np.abs(c[:, 0] - 1) < 1e-14) | (np.abs(c[:, 0]) < 1e-14), 2)
    mesh.set_side_boundary_id(1, 1, 1)
    out = io.StringIO()
    ns = NS(par, mesh, out=out, **kw)
    ns.set_no_slip_boundary(0)
    ns.set_velocity_dirichlet_boundary(1, _lid)
    ns.fix_pressure_constant(0)
    ns.set_symmetry_boundary(2)
    ns.setup_problem()
    ns.init_time_advance()
    counts = ns.evaluate_time_step()
    return out.getvalue(), ns, counts


@pytest.fixture(scope="module")
def newton_step():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
        mp.setenv("ADAFLO_FUSED_NEWTON", "0")
        jax_run = _step(JParams, JMesh, JNS)
    return jax_run, _step(TParams, TMesh, TNS, device="cpu")


def test_symmetry_newton_step(newton_step):
    (jtext, jns, jcounts), (ttext, tns, tcounts) = newton_step
    assert numdiff_lines(normalize_output(ttext), normalize_output(jtext)) == []
    assert int(tcounts[0]) == int(jcounts[0]) >= 2
    assert int(tcounts[1]) == int(jcounts[1]) > 0
    assert "converged." in ttext
    assert rel(tns.solution[0], jns.solution[0]) <= 1e-9
    assert rel(tns.solution[1], jns.solution[1]) <= 1e-9
    # the symmetry sides carry no normal velocity and a free tangential one
    u = tns.solution[0].numpy()
    left = tns.u_space.side_dofs(0, 0)
    interior = left[(tns.u_space.node_coords[left, 1] > 0) & (tns.u_space.node_coords[left, 1] < 1)]
    assert np.all(u[0, interior] == 0.0) and np.abs(u[1, interior]).max() > 1e-4
