"""The port's block preconditioner with variable (two-phase) coefficients
against the JAX package, float64 on the CPU.

On a 2D 32 x 24 lattice (two GMG levels for the pressure, three for
the velocity) with per-component velocity constraints (no-slip at
the bottom and top, symmetry on the left and right: the sides constrain only
the x component) and the pressure-fix dof, with numpy-seeded per-q-point
density and viscosity of a two-phase pair (rho in [0.1, 1], mu in [0.001,
0.01]):
- `_cells_to_subcells` upsamples like the JAX function;
- the preconditioner state: velocity-block diagonal and lambda_max, the
  pressure Poisson diagonal and lambda_max with the per-q 1/rho, the lumped
  pressure mass weighted per cell by 1/(mu + tau_gd) at the centre q-point,
  the GMG levels of both blocks with their per-subcell coefficients (1e-10
  relative: power iterations after identical inputs);
- one apply, cheap and with inner solves, to 1e-10 relative: the velocity
  block takes the Chebyshev of the true operator (not the GMG) with
  variable coefficients, as the JAX package does.
The JAX side runs eagerly, op by op (compiling `compute` and `apply` as
whole programs takes longer than running them at this size), on its einsum
operator (ADAFLO_PALLAS_MATVEC=0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaflo_tpu.fe.constraints import Constraints as JConstraints
from adaflo_tpu.fe.space import ScalarSpace as JSpace
from adaflo_tpu.mesh.structured import StructuredMesh as JMesh
from adaflo_tpu.ops import navier_stokes as jns
from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu.solvers import preconditioner as jpc
from adaflo_tpu_torch.fe.constraints import Constraints as TConstraints
from adaflo_tpu_torch.fe.space import ScalarSpace as TSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh as TMesh
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.solvers import preconditioner as tpc

torch.set_num_threads(2)

PRM = """
subsection Two phase
  set density              = 1.
  set density difference   = -0.9
  set viscosity            = 0.01
  set viscosity difference = -0.009
end
subsection Navier-Stokes
  set dimension = 2
  subsection Solver
    set tau grad div = 0.2
  end
end
"""
TW = (1.5 / 0.02, -2.0 / 0.02, 0.5 / 0.02, 1.0)


def rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _setup(Params, Mesh, Space, Cons, ns, **kw):
    par = Params.from_string(PRM)
    mesh = Mesh((32, 24), (0.0, 0.0), (1.0, 2.0))
    mesh.set_side_boundary_id(0, 0, 2)
    mesh.set_side_boundary_id(0, 1, 2)
    us, ps = Space(mesh, 2), Space(mesh, 1)
    cu = [Cons(us.n_dofs) for _ in range(2)]
    for c in cu:
        c.add_dirichlet(us.boundary_dofs(0))
    cu[0].add_dirichlet(us.boundary_dofs(2))
    for c in cu:
        c.close()
    cp = Cons(ps.n_dofs)
    cp.close()
    cs = Cons(ps.n_dofs)
    cs.add_dirichlet(ps.boundary_dofs(0)[:1])
    cs.close()
    op = ns.NavierStokesOperator(par, us, ps, cu, cp, **kw)
    return par, op, cs


@pytest.fixture(scope="module")
def case():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
        jpar, jop, jcs = _setup(JParams, JMesh, JSpace, JConstraints, jns)
        tpar, top, tcs = _setup(TParams, TMesh, TSpace, TConstraints, tns, device="cpu")
        jprec = jpc.NavierStokesPreconditioner(jpar, jop, jcs)
        tprec = tpc.NavierStokesPreconditioner(tpar, top, tcs)
        rng = np.random.default_rng(21)
        E, n_q = top.u_space.mesh.n_cells, top.n_q
        f = dict(
            u=rng.standard_normal((2, top.u_space.n_dofs)),
            p=rng.standard_normal(top.p_space.n_dofs),
            rho=rng.uniform(0.1, 1.0, (E, n_q)),
            mu=rng.uniform(0.001, 0.01, (E, n_q)),
            r_u=rng.standard_normal((2, top.u_space.n_dofs)),
            r_p=rng.standard_normal(top.p_space.n_dofs),
        )
        jf = {k: jnp.asarray(v) for k, v in f.items()}
        tf = {k: torch.tensor(v) for k, v in f.items()}
        jtw = jns.TimeWeights(*(jnp.float64(w) for w in TW))
        ttw = tns.TimeWeights(*TW)
        jco = jns.Coefficients(jf["rho"], jf["mu"], None)
        tco = tns.Coefficients(tf["rho"], tf["mu"], None)

        def jcompute(u, p, co):
            lin = jop.residual_assemble(u, p, u, u, jtw, co)[2]
            return jprec.compute(jtw, lin, co)

        jst = jcompute(jf["u"], jf["p"], jco)

        def japply(st, r_u, r_p, do_inner):
            return jprec.apply(st, (r_u, r_p), jtw, do_inner, False)

        jout = {
            inner: japply(jst, jf["r_u"], jf["r_p"], do_inner=inner) for inner in (False, True)
        }
        tlin = top.residual_assemble(tf["u"], tf["p"], tf["u"], tf["u"], ttw, tco)[2]
        tst = tprec.compute(ttw, tlin, tco)
        tout = {
            inner: tprec.apply(tst, (tf["r_u"], tf["r_p"]), ttw, inner, False)
            for inner in (False, True)
        }
    return dict(jst=jst, tst=tst, jout=jout, tout=tout, top=top)


def test_cells_to_subcells():
    rng = np.random.default_rng(2)
    for shape, deg in (((3, 4), 2), ((2, 3, 2), 2), ((3, 2), 1)):
        x = rng.standard_normal(int(np.prod(shape)))
        ref = jpc._cells_to_subcells(jnp.asarray(x), shape, deg)
        got = tpc._cells_to_subcells(torch.tensor(x), shape, deg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_variable_state(case):
    jst, tst = case["jst"], case["tst"]
    for name in ("u_diag", "poisson_diag", "mass_diag", "mass_diag_w", "mass_coefficient"):
        assert rel(getattr(tst, name), getattr(jst, name)) <= 1e-10, name
    assert tst.mass_coefficient.shape == (case["top"].u_space.mesh.n_cells,)
    for name in ("u_lambda_max", "poisson_lambda_max", "u_cheb_growth", "inv_rho_weight"):
        assert rel(np.float64(getattr(tst, name)), getattr(jst, name)) <= 1e-10, name
    tg, jg = tst.p_gmg, jst.p_gmg
    assert len(tg.levels) == len(jg.levels) >= 2
    for tl, jl in zip(tg.levels, jg.levels):
        for name in ("alpha", "beta", "diag"):
            assert rel(getattr(tl, name), getattr(jl, name)) <= 1e-10, name
        assert rel(np.float64(tl.lmax), jl.lmax) <= 1e-10
    assert rel(tg.coarse_matrix, jg.coarse_matrix) <= 1e-10
    # per-subcell 1/rho on the finest level; the velocity V-cycle is not
    # applied with variable coefficients, so its levels are not built
    assert tg.levels[0].beta.shape == (32 * 24,)
    assert tst.u_gmg is None


@pytest.mark.parametrize("inner", [False, True])
def test_variable_apply(case, inner):
    (tdu, tdp), (jdu, jdp) = case["tout"][inner], case["jout"][inner]
    assert rel(tdu, jdu) <= 1e-10
    assert rel(tdp, jdp) <= 1e-10
