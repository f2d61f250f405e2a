"""The route rule of the port's Navier-Stokes operator, on the CPU.

vmult and velocity_vmult run an entry of the coupled cell apply (the CUDA
kernel K1-K4, or its plain version for CPU tensors) where the JAX operator
builds its Pallas tables for a reason of the model: the coupled implicit
Newton linearization of the time-dependent incompressible equations in 2D
and 3D. Every other configuration runs the plain cell route ("einsum"),
chosen by the configuration alone and counted in PLAIN_ROUTE_APPLIES; it
is never what runs when the card is missing, which the operator refuses."""

import numpy as np
import pytest
import torch

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


def operator(dim, degree, lin, ptype, periodic=False, device="cpu", layout=None):
    par = FlowParameters.from_string(PRM.format(dim=dim, degree=degree, lin=lin, ptype=ptype))
    mesh = StructuredMesh((3, 2, 2)[:dim], (0.0,) * dim, (1.0, 0.7, 0.9)[:dim])
    if periodic:
        mesh.set_periodic(0)
    us, ps = ScalarSpace(mesh, degree), ScalarSpace(mesh, degree - 1)
    cu = [Constraints(us.n_dofs) for _ in range(dim)]
    cu[0].add_dirichlet(us.boundary_dofs(0))
    cp = Constraints(ps.n_dofs)
    for c in cu + [cp]:
        c.close()
    return tops.NavierStokesOperator(par, us, ps, cu, cp, device=device, layout=layout)


def state(op, seed):
    rng = np.random.default_rng(seed)
    n_u, n_p = op.u_space.n_dofs, op.p_space.n_dofs
    u, uo, uoo, du = (torch.tensor(rng.standard_normal((op.dim, n_u))) for _ in range(4))
    p, dp = (torch.tensor(rng.standard_normal(n_p)) for _ in range(2))
    _, _, lin = op.residual_assemble(u, p, uo, uoo, TW, tops.Coefficients(), (2.0, -1.0))
    return lin, du, dp


@pytest.mark.parametrize(
    "dim, degree, periodic, layout, route",
    [
        (3, 2, False, None, "nodal"), (2, 2, False, None, "nodal"),
        (3, 3, False, None, "nodal"), (3, 2, True, None, "cells"),
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
    with pytest.raises(NotImplementedError, match="no kernel for dim=2, degree=3"):
        operator(2, 3, *NEWTON)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without CUDA")
@pytest.mark.parametrize("config", [NEWTON, OTHER[3]], ids=["newton", "projection"])
def test_the_card_is_refused_without_cuda(config):
    with pytest.raises(RuntimeError, match="CUDA device"):
        operator(2, 2, *config, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        operator(2, 2, *config, device=None)
