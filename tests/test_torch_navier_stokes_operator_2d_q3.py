"""The port's NavierStokesOperator and its coupled cell apply's plain version
against the JAX einsum operator: 2D Q3/Q2, the table set of the Q3 rising
bubble (K1/K2's 2D Q3/Q2 instance).

- The shared cases of torch_operator_cases.py (unconstrained, Dirichlet
  rows with a constrained pressure row and the pressure fix, and the
  periodic channel pattern), every check of the other table sets.
- The rising bubble's constraint pattern on a 4 x 6 lattice: symmetry sides
  (x = 0 and x = 1: the x component alone constrained) and no-slip bottom
  and top (both components), so that the velocity masks differ by
  component; vmult and velocity_vmult with variable rho, mu and damping
  (the operator's "nodal" route, K1/K2's plain versions on the CPU) against
  the JAX operator's einsum vmult and velocity_vmult, 1e-12 relative.

The JAX side runs with ADAFLO_PALLAS_MATVEC=0 and never calls vmult_pr
(the reference's F1: its variable-coefficient table cache is keyed by
id())."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaflo_tpu.fe.constraints import Constraints as JConstraints
from adaflo_tpu.fe.space import ScalarSpace as JSpace
from adaflo_tpu.mesh.structured import StructuredMesh as JMesh
from adaflo_tpu.ops import navier_stokes as jns
from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu_torch.fe.constraints import Constraints as TConstraints
from adaflo_tpu_torch.fe.space import ScalarSpace as TSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh as TMesh
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from torch_operator_cases import (
    MODES,
    PRM,
    build_cases,
    case_keys,
    check_plain_version_mode,
    check_residual_assemble,
    check_velocity_vmult_and_diagonals,
    check_vmult,
    check_vmult_layout,
    close,
)

torch.set_num_threads(2)

KEYS, IDS = case_keys(2, 3)


@pytest.fixture(scope="module")
def cases():
    return build_cases(KEYS)


@pytest.fixture
def case(request, cases):
    return cases[request.param]


@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_residual_assemble(case):
    check_residual_assemble(case)


@pytest.mark.parametrize("variable", [False, True], ids=["const", "variable"])
@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_vmult(case, variable):
    check_vmult(case, variable)


@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_velocity_vmult_and_diagonals(case):
    check_velocity_vmult_and_diagonals(case)


@pytest.mark.parametrize("lin_kind", ["dofs", "qfields"])
@pytest.mark.parametrize("layout", ["pr", "t", "n", "pe", "pi"])
@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_vmult_layouts(case, layout, lin_kind):
    check_vmult_layout(case, layout, lin_kind)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_plain_version_modes(case, mode):
    check_plain_version_mode(case, mode)


@pytest.fixture(scope="module")
def symmetric():
    """The 4 x 6 lattice of [0, 1] x [0, 1.5] with the bubble's masks, both
    packages, random u, p, u*, old velocities, du, dp and coefficients
    (numpy seed); the JAX references as one compiled program."""
    dim, degree = 2, 3
    text = PRM.format(dim=dim, degree=degree)
    rng = np.random.default_rng(23)
    built = []
    for Params, Mesh, Space, Cons, ns in (
        (JParams, JMesh, JSpace, JConstraints, jns),
        (TParams, TMesh, TSpace, TConstraints, tns),
    ):
        mesh = Mesh((4, 6), (0.0, 0.0), (1.0, 1.5))
        us, ps = Space(mesh, degree), Space(mesh, degree - 1)
        cu = [Cons(us.n_dofs) for _ in range(dim)]
        for end in (0, 1):
            # symmetry on the x sides: the normal (x) component alone
            cu[0].add_dirichlet(us.side_dofs(0, end))
            # no slip on the bottom and the top: both components
            for c in cu:
                c.add_dirichlet(us.side_dofs(1, end))
        cp = Cons(ps.n_dofs)
        cp.add_dirichlet([0])
        for c in cu + [cp]:
            c.close()
        extra = {} if ns is jns else {"device": "cpu"}
        built.append(ns.NavierStokesOperator(Params.from_string(text), us, ps, cu, cp, **extra))
    jop, top = built
    n_u, n_p, E, n_q = us.n_dofs, ps.n_dofs, mesh.n_cells, top.n_q
    vec = {
        "u": rng.standard_normal((dim, n_u)), "p": rng.standard_normal(n_p),
        "uo": rng.standard_normal((dim, n_u)), "uoo": rng.standard_normal((dim, n_u)),
        "du": rng.standard_normal((dim, n_u)), "dp": rng.standard_normal(n_p),
        "rho": rng.uniform(0.1, 1.0, (E, n_q)), "mu": rng.uniform(0.001, 0.01, (E, n_q)),
        "damping": rng.uniform(-0.3, 0.3, (E, n_q)),
    }
    tw = (1.5 / 0.02, -2.0 / 0.02, 0.5 / 0.02, 1.0)
    jtw = jns.TimeWeights(*(jnp.float64(w) for w in tw))

    def references(u, p, uo, uoo, du, dp, rho, mu, damping):
        _, _, lin = jop.residual_assemble(u, p, uo, uoo, jtw)
        co = jns.Coefficients(rho, mu, damping)
        return dict(vmult=jop.vmult(du, dp, jtw, lin, co),
                    velocity=jop.velocity_vmult(du, jtw, lin, co))

    keys = ("u", "p", "uo", "uoo", "du", "dp", "rho", "mu", "damping")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
        ref = jax.jit(references)(*(jnp.asarray(vec[k]) for k in keys))
    t = {k: torch.tensor(v) for k, v in vec.items()}
    ttw = tns.TimeWeights(*tw)
    lin = top.residual_assemble(t["u"], t["p"], t["uo"], t["uoo"], ttw)[2]
    co = tns.Coefficients(t["rho"], t["mu"], t["damping"])
    return dict(top=top, t=t, tw=ttw, lin=lin, co=co,
                ref=jax.tree_util.tree_map(np.asarray, ref))


def test_symmetry_masks_differ_by_component(symmetric):
    top = symmetric["top"]
    assert top.kernel_configuration() and top.cells.degree == 3 and top.cells.dim == 2
    masks = top.cells.mask_u
    assert int(masks[0].sum()) > int(masks[1].sum()) > 0
    assert top.route(symmetric["lin"], symmetric["co"]) == "nodal"


def test_variable_vmult_with_symmetry_masks(symmetric):
    s = symmetric
    before = dict(cm.plain_calls)
    route = dict(tns.PLAIN_ROUTE_APPLIES)
    ru, rp = s["top"].vmult(s["t"]["du"], s["t"]["dp"], s["tw"], s["lin"], s["co"])
    assert cm.plain_calls["coupled_apply_plain"] == before["coupled_apply_plain"] + 1
    assert tns.PLAIN_ROUTE_APPLIES == route
    close(ru, s["ref"]["vmult"][0])
    close(rp, s["ref"]["vmult"][1])


def test_variable_velocity_vmult_with_symmetry_masks(symmetric):
    s = symmetric
    before = dict(cm.plain_calls)
    rv = s["top"].velocity_vmult(s["t"]["du"], s["tw"], s["lin"], s["co"])
    assert cm.plain_calls["coupled_apply_plain"] == before["coupled_apply_plain"] + 1
    close(rv, s["ref"]["velocity"])
