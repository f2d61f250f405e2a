"""Port's operators on adaptive forests against the JAX package, float64 on
the CPU, 1e-12 relative to the largest entry of the reference: the
per-cell evaluator (VariableCellEvaluator), the index-map gather and
scatter (IndexMapOps, whose segment-sum scatter meets JAX's `.at[].add`),
the constrained Helmholtz operator (vmult, diagonal, rhs), one forest GMG
V-cycle in 2D and 3D, and the Navier-Stokes operator on a hanging-node
forest: residual, vmult, velocity_vmult and the two diagonals, on the plain
cell route ("einsum"). The JAX side runs each case as one compiled program
(ADAFLO_PALLAS_MATVEC=0: its forest path has no Pallas tables anyway)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaflo_tpu.fe.forest_space import ForestSpace as JSpace
from adaflo_tpu.ops import navier_stokes as jns
from adaflo_tpu.ops.forest_ops import ForestHelmholtzOperator as JHelmholtz
from adaflo_tpu.ops.lattice import IndexMapOps as JIndexMap
from adaflo_tpu.ops.tensor import VariableCellEvaluator as JVariable
from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu.solvers.forest_multigrid import ForestGMG as JGMG
from adaflo_tpu_torch.fe.forest_space import ForestSpace as TSpace
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.ops.forest_ops import ForestHelmholtzOperator as THelmholtz
from adaflo_tpu_torch.ops.lattice import IndexMapOps as TIndexMap
from adaflo_tpu_torch.ops.tensor import VariableCellEvaluator as TVariable
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.solvers.forest_multigrid import ForestGMG as TGMG
from torch_forest_cases import fresh, hanging_pair

torch.set_num_threads(2)

TOL = 1e-12


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def spaces(dim, degree):
    j, t = hanging_pair(dim)
    js, ts = JSpace(j, degree), TSpace(t, degree)
    assert len(ts.hanging_slave) and np.array_equal(js.cell_dofs, ts.cell_dofs)
    return js, ts


@pytest.mark.parametrize("dim", [2, 3])
def test_variable_evaluator_and_index_map(dim):
    """values, gradients and both integrations of the per-cell evaluator
    (a batch axis behind the cells too), and the index map's gather and
    scatter_add (also of a batch of vectors)."""
    js, ts = spaces(dim, 2)
    E, nl = ts.cell_dofs.shape
    jev = JVariable(dim, js.basis, 4, js.h_cells)
    tev = TVariable(dim, ts.basis, 4, ts.h_cells, device="cpu")
    rng = np.random.default_rng(dim)
    u = rng.standard_normal((E, 3, nl))
    f = rng.standard_normal((E, 3, tev.n_q))
    g = rng.standard_normal((E, 3, dim, tev.n_q))
    ref = jax.jit(lambda u, f, g: (jev.values(u), jev.gradients(u),
                                   jev.integrate_values(f), jev.integrate_gradients(g)))(
        jnp.asarray(u), jnp.asarray(f), jnp.asarray(g))
    got = (tev.values(torch.tensor(u)), tev.gradients(torch.tensor(u)),
           tev.integrate_values(torch.tensor(f)), tev.integrate_gradients(torch.tensor(g)))
    for a, b in zip(got, ref):
        close(a, b)
    close(torch.as_tensor(tev.quad_coords(ts)), jev.quad_coords(js))

    jl, tl = JIndexMap.for_space(js), TIndexMap.for_space(ts, "cpu")
    x = rng.standard_normal(ts.n_dofs)
    r = rng.standard_normal((E, nl))
    ref = jax.jit(lambda x, r: (jl.gather(x), jl.scatter_add(r)))(
        jnp.asarray(x), jnp.asarray(r))
    close(tl.gather(torch.tensor(x)), ref[0])
    close(tl.scatter_add(torch.tensor(r)), ref[1])
    # a batch of vectors through one gather and one scatter
    close(tl.gather(torch.tensor(np.stack([x, 2 * x]))), np.stack([ref[0], 2 * ref[0]]))
    close(tl.scatter_add(torch.tensor(np.stack([r, 2 * r]))), np.stack([ref[1], 2 * ref[1]]))


@pytest.mark.parametrize("dim", [2, 3])
def test_helmholtz_operator(dim):
    """alpha M + beta K with Dirichlet sides and the hanging rows: vmult,
    diagonal and the condensed rhs."""
    js, ts = spaces(dim, 2)
    jc = js.make_constraints(js.all_boundary_dofs())
    tc = ts.make_constraints(ts.all_boundary_dofs())
    jop, top = JHelmholtz(js, jc), THelmholtz(ts, tc, device="cpu")
    rng = np.random.default_rng(10 + dim)
    u = rng.standard_normal(ts.n_dofs)
    f = rng.standard_normal((ts.n_cells, top.ev.n_q))
    ref = jax.jit(lambda u, f: (jop.vmult(u, 0.7, 1.3), jop.diagonal(0.7, 1.3), jop.rhs(f)))(
        jnp.asarray(u), jnp.asarray(f))
    got = (top.vmult(torch.tensor(u), 0.7, 1.3), top.diagonal(0.7, 1.3),
           top.rhs(torch.tensor(f)))
    for a, b in zip(got, ref):
        close(a, b)


@pytest.mark.parametrize("dim", [2, 3])
def test_forest_gmg_vmult(dim):
    """One V-cycle of the forest GMG (several levels: min_coarse_nodes low),
    2D as a velocity component's (Dirichlet sides, per-cell alpha and
    beta), 3D as the pressure Poisson's (no sides, a pinned dof, alpha 0):
    the hierarchy's sizes, the level diagonals and the vmult."""
    degree = 2 if dim == 2 else 1
    js, ts = spaces(dim, degree)
    sides = [(0, 0), (1, 1)] if dim == 2 else []
    pin = None if dim == 2 else np.array([0.25, -0.5, 0.25])
    kw = dict(pin_position=pin, min_coarse_nodes=10)
    jg = JGMG(js, sides, js.n_dofs_padded, **kw)
    tg = TGMG(ts, sides, ts.n_dofs_padded, device="cpu", **kw)
    assert len(tg.levels) == len(jg.levels) >= 2
    for a, b in zip(jg.levels, tg.levels):
        assert a.space.n_dofs == b.space.n_dofs and np.array_equal(a.mask, b.con.dirichlet_dofs)
    rng = np.random.default_rng(20 + dim)
    E = ts.n_cells
    alpha = rng.uniform(0.5, 2.0, E) if dim == 2 else 0.0
    beta = rng.uniform(0.5, 2.0, E) if dim == 2 else 1.3
    b = rng.standard_normal(ts.n_dofs)
    jarg = (lambda x: jnp.asarray(x)) if dim == 2 else jnp.float64
    targ = (lambda x: torch.tensor(x)) if dim == 2 else float

    def jrun(alpha, beta, b):
        st = jg.compute(alpha, beta)
        return [s.diag for s in st.levels], jg.vmult(st, b)

    jdiag, jx = jax.jit(jrun)(jarg(alpha), jarg(beta), jnp.asarray(b))
    st = tg.compute(targ(alpha), targ(beta))
    for a, ref in zip([s.diag for s in st.levels], jdiag):
        close(a, ref)
    close(tg.vmult(st, torch.tensor(b)), jx)


NS_PRM = """
subsection Navier-Stokes
  set dimension = {dim}
  set velocity degree = {degree}
  set viscosity = 0.05
  set damping = 0.2
  subsection Solver
    set tau grad div = 0.3
  end
end
"""


@pytest.mark.parametrize("dim, degree", [(2, 2), (2, 3), (3, 2)])
def test_navier_stokes_operator_on_the_forest(dim, degree):
    """The coupled Newton operator on a hanging-node forest (Dirichlet
    velocity sides, the hanging rows in velocity and pressure, the pressure
    fix): residual, vmult, velocity_vmult, the velocity block's and the
    pressure Poisson's diagonals; its route is the plain cell route and no
    kernel entry runs."""
    j, t = hanging_pair(dim)
    ops = []
    for Params, Space, ns, extra in ((JParams, JSpace, jns, {}),
                                     (TParams, TSpace, tns, {"device": "cpu"})):
        mesh = fresh(j) if ns is jns else t
        us, ps = Space(mesh, degree), Space(mesh, degree - 1)
        cu = [us.make_constraints(us.all_boundary_dofs()) for _ in range(dim)]
        cp = ps.make_constraints()
        op = ns.NavierStokesOperator(Params.from_string(NS_PRM.format(dim=dim, degree=degree)),
                                     us, ps, cu, cp, **extra)
        op.enable_pressure_fix()
        ops.append(op)
    jop, top = ops
    assert not top.kernel_configuration() and top.cells is None
    rng = np.random.default_rng(30 * dim + degree)
    n_u, n_p = top.u_space.n_dofs, top.p_space.n_dofs
    vec = {k: rng.standard_normal(s) for k, s in (
        ("u", (dim, n_u)), ("p", n_p), ("uo", (dim, n_u)), ("uoo", (dim, n_u)),
        ("du", (dim, n_u)), ("dp", n_p))}
    tw = (1.5 / 0.05, -2.0 / 0.05, 0.5 / 0.05, 1.0)
    jtw = jns.TimeWeights(*(jnp.float64(w) for w in tw))
    ttw = tns.TimeWeights(*tw)

    def jrun(u, p, uo, uoo, du, dp):
        ru, rp, lin = jop.residual_assemble(u, p, uo, uoo, jtw)
        vu, vp = jop.vmult(du, dp, jtw, lin)
        return (ru, rp, lin.val, lin.grad, vu, vp, jop.velocity_vmult(du, jtw, lin),
                jop.velocity_block_diagonal(jtw, lin), jop.pressure_poisson_diagonal(0.7))

    ref = jax.jit(jrun)(*(jnp.asarray(vec[k]) for k in ("u", "p", "uo", "uoo", "du", "dp")))
    tv = {k: torch.tensor(v) for k, v in vec.items()}
    ru, rp, lin = top.residual_assemble(tv["u"], tv["p"], tv["uo"], tv["uoo"], ttw)
    assert top.route(lin) == "einsum"
    before, plain = dict(tns.PLAIN_ROUTE_APPLIES), dict(cm.plain_calls)
    vu, vp = top.vmult(tv["du"], tv["dp"], ttw, lin)
    vv = top.velocity_vmult(tv["du"], ttw, lin)
    assert tns.PLAIN_ROUTE_APPLIES["vmult"] == before["vmult"] + 1
    assert tns.PLAIN_ROUTE_APPLIES["velocity_vmult"] == before["velocity_vmult"] + 1
    assert cm.plain_calls == plain
    got = (ru, rp, lin.val, lin.grad, vu, vp, vv,
           top.velocity_block_diagonal(ttw, lin), top.pressure_poisson_diagonal(0.7))
    for a, b in zip(got, ref):
        close(a, b)
