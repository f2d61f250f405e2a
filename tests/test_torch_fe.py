"""Port FE layer against the JAX package: spaces, constraints, the
sum-factorized cell evaluator and the lattice gather/scatter
(adaflo_tpu_torch.fe / ops.tensor / ops.lattice), float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaflo_tpu.fe.constraints import Constraints as JConstraints
from adaflo_tpu.fe.space import ScalarSpace as JSpace
from adaflo_tpu.mesh.structured import StructuredMesh as JMesh
from adaflo_tpu.ops.lattice import LatticeOps as JLattice
from adaflo_tpu.ops.tensor import CellEvaluator as JEvaluator
from adaflo_tpu_torch.fe.constraints import Constraints as TConstraints
from adaflo_tpu_torch.fe.space import ScalarSpace as TSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh as TMesh
from adaflo_tpu_torch.ops.lattice import LatticeOps as TLattice
from adaflo_tpu_torch.ops.tensor import CellEvaluator as TEvaluator

torch.set_num_threads(2)

TOL = 1e-13  # relative, float64: same contractions in another order

CASES = [(2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3)]


def _meshes(dim, periodic_x=False):
    if dim == 2:
        args = ((4, 3), (0.0, 0.0), (1.0, 1.3))
    else:
        args = ((3, 4, 2), (0.0, 0.0, 0.0), (1.0, 1.3, 0.7))
    jm, tm = JMesh(*args), TMesh(*args)
    if periodic_x:
        jm.set_periodic(0)
        tm.set_periodic(0)
    return jm, tm


def _close(got, ref, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= tol * scale


@pytest.mark.parametrize("dim,degree", CASES)
def test_space_dofs_and_boundary(dim, degree):
    jm, tm = _meshes(dim)
    js, ts = JSpace(jm, degree), TSpace(tm, degree)
    assert ts.n_dofs == js.n_dofs and ts.n_local == js.n_local
    np.testing.assert_array_equal(ts.cell_dofs, js.cell_dofs)
    np.testing.assert_array_equal(ts.node_coords, js.node_coords)
    for bid in sorted(jm.all_boundary_ids()):
        np.testing.assert_array_equal(ts.boundary_dofs(bid), js.boundary_dofs(bid))


@pytest.mark.parametrize("hanging", [False, True])
def test_constraints_apply_equal(hanging):
    rng = np.random.default_rng(7)
    n = 60
    dirichlet = rng.choice(n, 9, replace=False)
    cons = []
    for C in (JConstraints, TConstraints):
        c = C(n)
        c.add_dirichlet(dirichlet)
        if hanging:
            # two-master rows, one chained through another slave, one row
            # whose master is a Dirichlet dof
            c.add_affine([50, 50, 51, 51, 52], [10, 11, 50, 12, int(dirichlet[0])],
                         [0.5, 0.5, 0.5, 0.5, 1.0])
        c.close()
        cons.append(c)
    jc, tc = cons
    np.testing.assert_array_equal(tc.constrained_dofs, jc.constrained_dofs)
    u = rng.standard_normal(n)
    src = rng.standard_normal(n)
    tu, ju = torch.tensor(u), jnp.asarray(u)
    # one compiled program per JAX method (eager dispatch compiles per op)
    for name in ("resolve", "condense", "distribute", "distribute_values"):
        _close(getattr(tc, name)(tu), jax.jit(getattr(jc, name))(ju))
    _close(
        tc.set_identity(tu, torch.tensor(src)),
        jax.jit(jc.set_identity)(ju, jnp.asarray(src)),
    )
    assert torch.equal(tu, torch.tensor(u))  # inputs are left untouched


@pytest.mark.parametrize("dim,degree", CASES)
def test_evaluator_values_gradients_integration(dim, degree):
    rng = np.random.default_rng(10 * dim + degree)
    h = (0.3, 0.45, 0.6)[:dim]
    n_q = degree + 1
    je = JEvaluator(dim, JSpace(_meshes(dim)[0], degree).basis, n_q, h)
    te = TEvaluator(dim, TSpace(_meshes(dim)[1], degree).basis, n_q, h)
    u = rng.standard_normal((5, dim, te.n_local))
    f = rng.standard_normal((5, dim, te.n_q))
    g = rng.standard_normal((5, dim, dim, te.n_q))
    tu, ju = torch.tensor(u), jnp.asarray(u)
    jit = jax.jit
    _close(te.values(tu), jit(je.values)(ju))
    _close(te.gradients(tu), jit(je.gradients)(ju))
    _close(te.integrate_values(torch.tensor(f)), jit(je.integrate_values)(jnp.asarray(f)))
    _close(
        te.integrate_gradients(torch.tensor(g)),
        jit(je.integrate_gradients)(jnp.asarray(g)),
    )
    np.testing.assert_allclose(te.jxw_np, np.asarray(je.jxw), rtol=1e-15)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dim,degree", CASES)
def test_lattice_gather_scatter(dim, degree, periodic):
    rng = np.random.default_rng(3 * dim + degree)
    jm, tm = _meshes(dim, periodic)
    js, ts = JSpace(jm, degree), TSpace(tm, degree)
    jl, tl = JLattice.for_space(js), TLattice.for_space(ts)
    u = rng.standard_normal(ts.n_dofs)
    r = rng.standard_normal((tm.n_cells, ts.n_local))
    # one compiled program per JAX function (eager dispatch compiles per op)
    jg, jgt = jax.jit(jl.gather), jax.jit(jl.gather_t)
    js_, jst = jax.jit(jl.scatter_add), jax.jit(jl.scatter_add_t)
    _close(tl.gather(torch.tensor(u)), jg(jnp.asarray(u)))
    _close(tl.gather_t(torch.tensor(u)), jgt(jnp.asarray(u)))
    _close(tl.scatter_add(torch.tensor(r)), js_(jnp.asarray(r)))
    _close(tl.scatter_add_t(torch.tensor(r.T.copy())), jst(jnp.asarray(r.T)))
    np.testing.assert_array_equal(tl.cell_dof_table(), ts.cell_dofs)
