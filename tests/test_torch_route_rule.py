"""The route rule of the port's Navier-Stokes operator, on the CPU.

vmult and velocity_vmult run an entry of the coupled cell apply (the CUDA
kernel K1-K4, or its plain version for CPU tensors) where the JAX operator
builds its Pallas tables for a reason of the model: the coupled implicit
Newton linearization of the time-dependent incompressible equations in 2D
and 3D, at velocity degree 2 or 3, without augmented Taylor-Hood elements.
Every other configuration runs the plain cell route ("einsum"), chosen by
the configuration alone and counted in PLAIN_ROUTE_APPLIES; it is never
what runs when the card is missing, which the operator refuses. The JAX
operator's rule is read with ADAFLO_PALLAS_MATVEC=1, which builds its
tables wherever its eligibility holds (none is built in these tests)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaflo_tpu.fe.constraints import Constraints as JConstraints
from adaflo_tpu.fe.space import ScalarSpace as JSpace
from adaflo_tpu.mesh.structured import StructuredMesh as JMesh
from adaflo_tpu.ops import navier_stokes as jns
from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu_torch.fe.constraints import Constraints
from adaflo_tpu_torch.fe.space import ScalarSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import navier_stokes as tops
from adaflo_tpu_torch.parameters import FlowParameters

torch.set_num_threads(2)

PRM = """
subsection Navier-Stokes
  set physical type = {ptype}
  set dimension = {dim}
  set velocity degree = {degree}
  set augmented Taylor-Hood elements = {augmented}
  subsection Solver
    set linearization scheme = {lin}
  end
end
"""
OTHER = [
    ("coupled implicit Picard", "incompressible"),
    ("coupled velocity semi-implicit", "incompressible"),
    ("coupled velocity explicit", "incompressible"),
    ("projection", "incompressible"),
    ("coupled implicit Newton", "stokes"),
    ("coupled implicit Newton", "incompressible stationary"),
]
NEWTON = ("coupled implicit Newton", "incompressible")
KERNEL_ROUTES = {"nodal", "gather", "cells", "qfields"}
TW = tops.TimeWeights(15.0, -20.0, 5.0, 1.0)


def operator(dim, degree, lin, ptype, periodic=False, device="cpu", layout=None,
             augmented=False, package="port"):
    """The port's operator (or with package="jax" the JAX package's) on a
    (3, 2[, 2])-cell lattice, Dirichlet rows on boundary 0 for velocity
    component 0."""
    Params, Mesh, Space, Cons = (
        (FlowParameters, StructuredMesh, ScalarSpace, Constraints) if package == "port"
        else (JParams, JMesh, JSpace, JConstraints)
    )
    par = Params.from_string(PRM.format(
        dim=dim, degree=degree, lin=lin, ptype=ptype, augmented=int(augmented)))
    mesh = Mesh((3, 2, 2)[:dim], (0.0,) * dim, (1.0, 0.7, 0.9)[:dim])
    if periodic:
        mesh.set_periodic(0)
    us, ps = Space(mesh, degree), Space(mesh, degree - 1)
    cu = [Cons(us.n_dofs) for _ in range(dim)]
    cu[0].add_dirichlet(us.boundary_dofs(0))
    cp = Cons(ps.n_dofs)
    for c in cu + [cp]:
        c.close()
    if package == "jax":
        return jns.NavierStokesOperator(par, us, ps, cu, cp)
    return tops.NavierStokesOperator(par, us, ps, cu, cp, device=device, layout=layout)


def jax_has_tables(*args, **kw):
    """Whether the JAX operator of this configuration builds its Pallas
    tables where it may (ADAFLO_PALLAS_MATVEC=1)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFLO_PALLAS_MATVEC", "1")
        return operator(*args, **kw, package="jax")._pallas_tables is not None


def state(op, seed):
    rng = np.random.default_rng(seed)
    n_u, n_p = op.u_space.n_dofs, op.n_p_padded
    u, uo, uoo, du = (torch.tensor(rng.standard_normal((op.dim, n_u))) for _ in range(4))
    p, dp = (torch.tensor(rng.standard_normal(n_p)) for _ in range(2))
    _, _, lin = op.residual_assemble(u, p, uo, uoo, TW, tops.Coefficients(), (2.0, -1.0))
    return lin, du, dp


@pytest.mark.parametrize(
    "dim, degree, periodic, layout, route",
    [
        (3, 2, False, None, "nodal"), (2, 2, False, None, "nodal"),
        (3, 3, False, None, "nodal"), (2, 3, False, None, "nodal"),
        (3, 2, True, None, "cells"),
        (2, 2, True, None, "cells"), (3, 2, False, "pi", "gather"),
        (3, 2, False, "t", "cells"), (2, 2, False, "n", "cells"),
    ],
)
def test_newton_selects_a_kernel_entry(dim, degree, periodic, layout, route):
    op = operator(dim, degree, *NEWTON, periodic=periodic, layout=layout)
    assert op.kernel_configuration() and op.cells is not None
    lin, du, dp = state(op, dim + degree)
    assert op.route(lin) == route in KERNEL_ROUTES
    assert op.route(lin._replace(dofs=None)) in KERNEL_ROUTES
    before = dict(tops.PLAIN_ROUTE_APPLIES)
    plain = sum(cm.plain_calls.values())
    op.vmult(du, dp, TW, lin)
    op.velocity_vmult(du, TW, lin)
    assert tops.PLAIN_ROUTE_APPLIES == before
    assert sum(cm.plain_calls.values()) == plain + 2


@pytest.mark.parametrize(
    "dim, config",
    [(dim, c) for dim in (1, 2, 3) for c in OTHER] + [(1, NEWTON)],
    ids=lambda x: "-".join(w.split()[-1] for w in x) if isinstance(x, tuple) else f"{x}d",
)
def test_other_configurations_select_the_plain_route(dim, config):
    op = operator(dim, 2, *config)
    assert not op.kernel_configuration() and op.cells is None
    lin, du, dp = state(op, 7 * dim)
    assert op.route(lin) == "einsum"
    before = dict(tops.PLAIN_ROUTE_APPLIES)
    plain = dict(cm.plain_calls)
    ru, rp = op.vmult(du, dp, TW, lin)
    rv = op.velocity_vmult(du, TW, lin)
    assert tops.PLAIN_ROUTE_APPLIES["vmult"] == before["vmult"] + 1
    assert tops.PLAIN_ROUTE_APPLIES["velocity_vmult"] == before["velocity_vmult"] + 1
    assert cm.plain_calls == plain
    assert torch.isfinite(ru).all() and torch.isfinite(rp).all() and torch.isfinite(rv).all()
    # identity rows on the constrained velocity dofs
    dofs = op.constraints_u[0].constrained_dofs
    assert torch.equal(ru[0, dofs], du[0, dofs]) and torch.equal(rv[0, dofs], du[0, dofs])


def test_route_follows_the_configuration_at_each_apply():
    """The initial Stokes solve switches a Newton solver's physical type for
    its duration: its applies take the plain route, and the kernel entry
    comes back with the type."""
    op = operator(2, 2, *NEWTON)
    lin, du, dp = state(op, 3)
    par = op.parameters
    saved = par.physical_type
    par.physical_type = type(saved)("stokes")
    try:
        assert op.route(None) == "einsum"
        op.vmult(du, dp, TW, None)
    finally:
        par.physical_type = saved
    assert op.route(lin) == "nodal"
    with pytest.raises(ValueError, match="Newton linearization"):
        op.route(None)


def test_two_dimensional_q3_newton_has_no_kernel_and_raises():
    """Kept under its name: 2D Q3/Q2 coupled Newton used to raise for want
    of a kernel instance; it now has K1/K2's 2D Q3/Q2 instance, routes
    "nodal" and on the CPU runs the plain version."""
    op = operator(2, 3, *NEWTON)
    assert op.kernel_configuration() and (op.cells.dim, op.cells.degree) == (2, 3)
    lin, du, dp = state(op, 23)
    assert op.route(lin) == "nodal"
    before = dict(tops.PLAIN_ROUTE_APPLIES)
    plain = cm.plain_calls["coupled_apply_plain"]
    op.vmult(du, dp, TW, lin)
    op.velocity_vmult(du, TW, lin)
    assert cm.plain_calls["coupled_apply_plain"] == plain + 2
    assert tops.PLAIN_ROUTE_APPLIES == before


@pytest.mark.parametrize("dim", [2, 3], ids=["2d", "3d"])
def test_degree_four_newton_routes_einsum_as_jax_does(dim):
    """Velocity degree 4 has no Pallas table set in the JAX package: its
    coupled Newton operator builds and runs the einsum branch, and so does
    the port's, with the same vmult and velocity_vmult (1e-12 relative)."""
    assert not jax_has_tables(dim, 4, *NEWTON)
    op = operator(dim, 4, *NEWTON)
    assert not op.kernel_configuration() and op.cells is None
    lin, du, dp = state(op, 40 + dim)
    assert op.route(lin) == "einsum"
    before = dict(tops.PLAIN_ROUTE_APPLIES)
    ru, rp = op.vmult(du, dp, TW, lin)
    rv = op.velocity_vmult(du, TW, lin)
    assert tops.PLAIN_ROUTE_APPLIES["vmult"] == before["vmult"] + 1
    assert tops.PLAIN_ROUTE_APPLIES["velocity_vmult"] == before["velocity_vmult"] + 1
    jop = operator(dim, 4, *NEWTON, package="jax")
    rng = np.random.default_rng(40 + dim)
    n_u, n_p = op.u_space.n_dofs, op.n_p_padded
    u, uo, uoo, du_np = (rng.standard_normal((dim, n_u)) for _ in range(4))
    p, dp_np = (rng.standard_normal(n_p) for _ in range(2))
    jtw = jns.TimeWeights(*(jnp.float64(w) for w in TW))
    _, _, jlin = jop.residual_assemble(*(jnp.asarray(a) for a in (u, p, uo, uoo)), jtw)
    jru, jrp = jop.vmult(jnp.asarray(du_np), jnp.asarray(dp_np), jtw, jlin)
    jrv = jop.velocity_vmult(jnp.asarray(du_np), jtw, jlin)
    for got, ref in ((ru, jru), (rp, jrp), (rv, jrv)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("dim", [2, 3], ids=["2d", "3d"])
def test_augmented_newton_routes_einsum_as_jax_does(dim):
    """Augmented Taylor-Hood elements have no Pallas table set in the JAX
    package: coupled Newton on them runs the plain cell route, over the
    pressure vector [Q dofs | cell constants]."""
    assert not jax_has_tables(dim, 2, *NEWTON, augmented=True)
    op = operator(dim, 2, *NEWTON, augmented=True)
    assert not op.kernel_configuration() and op.cells is None
    assert op.n_p_padded == op.p_space.n_dofs + op.u_space.mesh.n_cells
    lin, du, dp = state(op, 50 + dim)
    assert op.route(lin) == "einsum"
    before = dict(tops.PLAIN_ROUTE_APPLIES)
    plain = dict(cm.plain_calls)
    ru, rp = op.vmult(du, dp, TW, lin)
    rv = op.velocity_vmult(du, TW, lin)
    assert tops.PLAIN_ROUTE_APPLIES["vmult"] == before["vmult"] + 1
    assert tops.PLAIN_ROUTE_APPLIES["velocity_vmult"] == before["velocity_vmult"] + 1
    assert cm.plain_calls == plain
    assert rp.shape == dp.shape and torch.isfinite(rp).all() and torch.isfinite(rv).all()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without CUDA")
@pytest.mark.parametrize("config", [NEWTON, OTHER[3]], ids=["newton", "projection"])
def test_the_card_is_refused_without_cuda(config):
    with pytest.raises(RuntimeError, match="CUDA device"):
        operator(2, 2, *config, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        operator(2, 2, *config, device=None)


def forest_operator(dim, package, augmented=False):
    """Coupled Newton Q2/Q1 on a hanging-node forest (torch_forest_cases),
    Dirichlet rows on every side and the hanging rows, in the port (on the
    CPU) or the JAX package."""
    from adaflo_tpu.fe.forest_space import ForestSpace as JForestSpace
    from adaflo_tpu_torch.fe.forest_space import ForestSpace
    from torch_forest_cases import hanging_pair

    j, t = hanging_pair(dim)
    Params, mesh, Space = (
        (FlowParameters, t, ForestSpace) if package == "port" else (JParams, j, JForestSpace)
    )
    par = Params.from_string(PRM.format(
        dim=dim, degree=2, lin=NEWTON[0], ptype=NEWTON[1], augmented=int(augmented)))
    us, ps = Space(mesh, 2), Space(mesh, 1)
    cu = [us.make_constraints(us.all_boundary_dofs()) for _ in range(dim)]
    cp = ps.make_constraints()
    if package == "jax":
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ADAFLO_PALLAS_MATVEC", "1")
            return jns.NavierStokesOperator(par, us, ps, cu, cp)
    return tops.NavierStokesOperator(par, us, ps, cu, cp, device="cpu")


@pytest.mark.parametrize("dim", [2, 3], ids=["2d", "3d"])
def test_forest_newton_routes_einsum_as_jax_does(dim):
    """Adaptive forests have no Pallas table set in the JAX package (its
    eligibility starts with `not self.is_forest`, even where
    ADAFLO_PALLAS_MATVEC=1 forces it elsewhere): coupled Newton Q2/Q1 on a
    hanging-node forest runs the plain cell route in the port, counted in
    PLAIN_ROUTE_APPLIES, and no kernel entry; augmented Taylor-Hood on a
    forest is not ported and raises, naming its queue item."""
    assert forest_operator(dim, "jax")._pallas_tables is None
    op = forest_operator(dim, "port")
    assert op.u_space.is_forest and not op.kernel_configuration() and op.cells is None
    lin, du, dp = state(op, 60 + dim)
    assert op.route(lin) == "einsum"
    before, plain = dict(tops.PLAIN_ROUTE_APPLIES), dict(cm.plain_calls)
    ru, rp = op.vmult(du, dp, TW, lin)
    rv = op.velocity_vmult(du, TW, lin)
    assert tops.PLAIN_ROUTE_APPLIES["vmult"] == before["vmult"] + 1
    assert tops.PLAIN_ROUTE_APPLIES["velocity_vmult"] == before["velocity_vmult"] + 1
    assert cm.plain_calls == plain
    assert torch.isfinite(ru).all() and torch.isfinite(rp).all() and torch.isfinite(rv).all()
    with pytest.raises(NotImplementedError, match="12b"):
        forest_operator(dim, "port", augmented=True)
