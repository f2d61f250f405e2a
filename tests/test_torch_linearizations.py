"""The port's Navier-Stokes operator and preconditioner in every
linearization and physical type, against the JAX package, float64 on the
CPU.

The case is the Poiseuille channel of drivers/poiseuille.py cut small: the
2D channel in 8 x 2 cells and the 3D one in 8 x 2 x 2, no-slip walls, the
symmetry plane y = 0, and open boundaries with normal flux at x = -2 and
x = 2 (their tangential velocity constrained, their pressure dofs in the
Schur constraints). Both packages' NavierStokes solvers build the spaces and
constraints; on random (numpy-seeded) u, p, old velocities and increments:

- residual_assemble (with the extrapolation factors of BDF-2), the frozen
  linearization, vmult and velocity_vmult for the coupled implicit Newton,
  Picard, semi-implicit, explicit and projection linearizations of the
  time-dependent equations and for the Stokes and the stationary types; the
  JAX operator runs its einsum path (ADAFLO_PALLAS_MATVEC=0), its references
  one compiled program per case; 1e-12 relative to the largest entry;
- which route ran: the coupled cell apply's plain version (K1/K2's, on the
  CPU) for coupled Newton, the plain cell route ("einsum") for every other
  configuration, counted in PLAIN_ROUTE_APPLIES;
- the stationary type's Kay-Loghin-Wathen preconditioner apply and its
  mu-weighted pressure Laplacian, and the projection scheme's fractional
  step (momentum GMRES, pressure Poisson CG, rotational update), 1e-12.

The route rule (every other configuration on the plain route, coupled
Newton on a kernel entry, the card refused without CUDA) is
test_torch_route_rule.py."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaflo_tpu.mesh.structured import StructuredMesh as JMesh
from adaflo_tpu.ops import navier_stokes as jops
from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu.solvers.navier_stokes_solver import NavierStokes as JNS
from adaflo_tpu_torch.mesh.structured import StructuredMesh as TMesh
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import navier_stokes as tops
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes as TNS

torch.set_num_threads(2)

TOL = 1e-12
PRM = """
subsection Navier-Stokes
  set physical type = {ptype}
  set dimension = {dim}
  set global refinements = 1
  set velocity degree = 2
  set viscosity = 0.5
  set damping = 0.1
  subsection Solver
    set linearization scheme = {lin}
    set NL tolerance = 1.e-9
    set lin max iterations = 60
    set lin tolerance = 1.e-4
    set tau grad div = 0.2
  end
end
subsection Time stepping
  set step size = 0.1
end
subsection Output options
  set output verbosity = 0
end
"""
CONFIGS = [
    ("coupled implicit Newton", "incompressible"),
    ("coupled implicit Picard", "incompressible"),
    ("coupled velocity semi-implicit", "incompressible"),
    ("coupled velocity explicit", "incompressible"),
    ("projection", "incompressible"),
    ("coupled implicit Newton", "stokes"),
    ("coupled implicit Newton", "incompressible stationary"),
]
EXTRAPOLATION = (2.0, -1.0)
TW = (1.5 / 0.1, -2.0 / 0.1, 0.5 / 0.1, 1.0)


def rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def channel(Params, Mesh, NS, dim, lin, ptype, **kw):
    """The solver on the small channel, set up (spaces, constraints,
    operator, preconditioner)."""
    par = Params.from_string(PRM.format(dim=dim, lin=lin, ptype=ptype))
    mesh = Mesh.subdivided_hyper_rectangle(
        (4,) + (1,) * (dim - 1), (-2.0,) + (-1.0,) * (dim - 1), (2.0,) + (0.0,) * (dim - 1)
    )
    mesh.set_boundary_id(lambda c: np.abs(c[:, 0] - 2) < 1e-13, 1)
    mesh.set_boundary_id(lambda c: np.abs(c[:, 0] + 2) < 1e-13, 2)
    mesh.set_boundary_id(lambda c: np.abs(c[:, 1]) < 1e-13, 3)
    ns = NS(par, mesh, out=io.StringIO(), **kw)
    ns.set_no_slip_boundary(0)
    ns.set_symmetry_boundary(3)
    ns.set_open_boundary_with_normal_flux(1, lambda x, t: 2 - x[:, 0])
    ns.set_open_boundary_with_normal_flux(2, lambda x, t: 2 - x[:, 0])
    ns.setup_problem()
    return ns


class Case:
    def __init__(self, dim, lin, ptype):
        self.dim, self.lin, self.ptype = dim, lin, ptype
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
            self.jns = channel(JParams, JMesh, JNS, dim, lin, ptype)
        self.tns = channel(TParams, TMesh, TNS, dim, lin, ptype, device="cpu")
        n_u, n_p = self.tns.u_space.n_dofs, self.tns.p_space.n_dofs
        rng = np.random.default_rng(17 * dim + CONFIGS.index((lin, ptype)))
        vec = lambda *s: rng.standard_normal(s)
        self.np = dict(
            u=vec(dim, n_u), p=vec(n_p), uo=vec(dim, n_u), uoo=vec(dim, n_u),
            du=vec(dim, n_u), dp=vec(n_p),
        )
        self.t = {k: torch.tensor(v) for k, v in self.np.items()}
        self.ref = jax.jit(self._references)(
            *(jnp.asarray(self.np[k]) for k in ("u", "p", "uo", "uoo", "du", "dp"))
        )

    def _references(self, u, p, uo, uoo, du, dp):
        jop = self.jns.operator
        tw = jops.TimeWeights(*(jnp.float64(w) for w in TW))
        ex = tuple(jnp.float64(f) for f in EXTRAPOLATION)
        ru, rp, lin = jop.residual_assemble(u, p, uo, uoo, tw, jops.Coefficients(), ex)
        out = dict(ru=ru, rp=rp, vmult=jop.vmult(du, dp, tw, lin),
                   velocity=jop.velocity_vmult(du, tw, lin))
        if lin is not None:
            out.update(val=lin.val, div=lin.div)
            if lin.grad is not None:
                out["grad"] = lin.grad
        return out

    def port(self):
        t, top = self.t, self.tns.operator
        tw = tops.TimeWeights(*TW)
        ru, rp, lin = top.residual_assemble(
            t["u"], t["p"], t["uo"], t["uoo"], tw, tops.Coefficients(), EXTRAPOLATION
        )
        return ru, rp, lin, top.vmult(t["du"], t["dp"], tw, lin), top.velocity_vmult(t["du"], tw, lin)


_CASES = {}


def get_case(*key):
    """The Case of (dim, linearization, type), built once per module."""
    if key not in _CASES:
        _CASES[key] = Case(*key)
    return _CASES[key]


@pytest.fixture(scope="module", params=[(d, *c) for d in (2, 3) for c in CONFIGS],
                ids=lambda p: f"{p[0]}d-{p[1].split()[-1]}-{p[2].split()[-1]}")
def case(request):
    return get_case(*request.param)


def test_operator_terms(case):
    counts0 = dict(tops.PLAIN_ROUTE_APPLIES)
    plain0 = cm.plain_calls["coupled_apply_plain"]
    ru, rp, lin, (vu, vp), velocity = case.port()
    ref = case.ref
    assert rel(ru, ref["ru"]) <= TOL
    assert rel(rp, ref["rp"]) <= TOL if case.lin != "projection" else not rp.any()
    if case.ptype == "stokes":
        assert lin is None and "val" not in ref
    else:
        assert rel(lin.val, ref["val"]) <= TOL and rel(lin.div, ref["div"]) <= TOL
        assert (lin.grad is None) == ("grad" not in ref)
        if lin.grad is not None:
            assert rel(lin.grad, ref["grad"]) <= TOL
    assert rel(vu, ref["vmult"][0]) <= TOL and rel(vp, ref["vmult"][1]) <= TOL
    assert rel(velocity, ref["velocity"]) <= TOL
    # the open sides' velocity rows constrain the tangential components
    # only, the symmetry plane the normal one
    tns = case.tns
    walls = set(tns.u_space.boundary_dofs(0).tolist())
    side = set(tns.u_space.boundary_dofs(1).tolist()) - walls
    sym = set(tns.u_space.boundary_dofs(3).tolist()) - walls
    con = [set(c.constrained_dofs.tolist()) for c in tns.constraints_u]
    assert side and all(side <= con[c] for c in range(1, case.dim))
    assert sym <= con[1] and not (side | sym) & con[0]
    assert set(tns.constraints_schur.constrained_dofs.tolist()) == set(
        tns.p_space.boundary_dofs(1).tolist() + tns.p_space.boundary_dofs(2).tolist()
    )
    # which route ran
    newton = case.lin == "coupled implicit Newton" and case.ptype == "incompressible"
    route = tns.operator.route(lin)
    applied = {k: tops.PLAIN_ROUTE_APPLIES[k] - counts0[k] for k in counts0}
    if newton:
        assert route == "nodal"
        assert cm.plain_calls["coupled_apply_plain"] - plain0 == 2
        assert applied == {"vmult": 0, "velocity_vmult": 0}
    else:
        assert route == "einsum"
        assert cm.plain_calls["coupled_apply_plain"] == plain0
        assert applied == {"vmult": 1, "velocity_vmult": 1}


def _prec_refs(jns_solver, lin, rhs_u, rhs_p, sol_u, kind):
    prec = jns_solver.preconditioner
    par = jns_solver.parameters
    tw = jops.TimeWeights(*(jnp.float64(w) for w in TW))
    st = prec.compute(tw, lin, jops.Coefficients())
    if kind == "stationary":
        du, dp = prec.apply(st, (rhs_u, rhs_p), tw, False, False)
        return dict(du=du, dp=dp, convdiff=jns_solver.operator.pressure_convdiff_vmult(
            rhs_p, st.coeffs, prec.constraints_schur))
    du, dp, phi, it, res = prec.solve_projection_system(
        st, sol_u, rhs_u, tw, jnp.float64(par.tol_nl_iteration),
        jnp.float64(par.tol_lin_iteration), par.time_step_size_start,
        jns_solver.constraints_u, jns_solver.constraints_schur, lin,
    )
    return dict(du=du, dp=dp, phi=phi, it=it, res=res)


@pytest.mark.parametrize("kind", ["stationary", "projection"])
def test_preconditioner_variants(kind):
    lin_name, ptype = (
        ("coupled implicit Newton", "incompressible stationary") if kind == "stationary"
        else ("projection", "incompressible")
    )
    c = get_case(2, lin_name, ptype)
    rng = np.random.default_rng(5)
    n_u, n_p = c.tns.u_space.n_dofs, c.tns.p_space.n_dofs
    rhs_u, rhs_p = rng.standard_normal((2, n_u)), rng.standard_normal(n_p)
    sol_u = rng.standard_normal((2, n_u))

    def jref(u, p, uo, uoo, ru, rp, su):
        tw = jops.TimeWeights(*(jnp.float64(w) for w in TW))
        ex = tuple(jnp.float64(f) for f in EXTRAPOLATION)
        _, _, lin = c.jns.operator.residual_assemble(u, p, uo, uoo, tw, jops.Coefficients(), ex)
        return _prec_refs(c.jns, lin, ru, rp, su, kind)

    ref = jax.jit(jref)(*(jnp.asarray(c.np[k]) for k in ("u", "p", "uo", "uoo")),
                        jnp.asarray(rhs_u), jnp.asarray(rhs_p), jnp.asarray(sol_u))
    _, _, lin, _, _ = c.port()
    tns = c.tns
    prec, par = tns.preconditioner, tns.parameters
    tw = tops.TimeWeights(*TW)
    st = prec.compute(tw, lin, tops.Coefficients())
    ru, rp, su = (torch.tensor(x) for x in (rhs_u, rhs_p, sol_u))
    if kind == "stationary":
        assert st.inv_rho_weight == 1.0 and st.mass_coefficient == 1.0
        du, dp = prec.apply(st, (ru, rp), tw, False, False)
        conv = tns.operator.pressure_convdiff_vmult(rp, st.coeffs, prec.constraints_schur)
        assert rel(conv, ref["convdiff"]) <= TOL
    else:
        assert st.mass_coefficient == 1.0
        du, dp, phi, it, res = prec.solve_projection_system(
            st, su, ru, tw, par.tol_nl_iteration, par.tol_lin_iteration,
            par.time_step_size_start, tns.constraints_u, tns.constraints_schur, lin,
        )
        assert int(it) == int(ref["it"]) > 0
        assert rel(phi, ref["phi"]) <= TOL
        assert abs(float(res) - float(ref["res"])) <= 1e-6 * float(ref["res"])
    assert rel(du, ref["du"]) <= TOL and rel(dp, ref["dp"]) <= TOL
