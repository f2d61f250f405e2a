"""The port's Krylov solvers, lattice multigrid and block preconditioner
against the JAX package, float64 on the CPU.

- CG, BiCGStab, GMRES(10) and FGMRES(10) on fixed dense operators (numpy
  seed): the same iteration counts at each tolerance of a sequence (the
  residual history) and the same residuals and solutions to 1e-8 relative,
  residuals with a floor of 1e-14 ||b|| (the solvers sum in another order,
  and the difference grows with the iteration count from roundoff; the
  nonsymmetric operator is mild enough that BiCGStab does not amplify it);
- one apply of the block preconditioner on the same state, to 1e-10
  relative (its multigrid's coarse CG stops at a 1e-10 reduction).
The JAX side is jitted, one program per function. The lattice multigrid's
own test is test_torch_solvers_multigrid.py.
"""

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
from adaflo_tpu.solvers import krylov as jk
from adaflo_tpu.solvers import multigrid as jmg
from adaflo_tpu.solvers import preconditioner as jpc
from adaflo_tpu_torch.fe.constraints import Constraints as TConstraints
from adaflo_tpu_torch.fe.space import ScalarSpace as TSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh as TMesh
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.solvers import krylov as tk
from adaflo_tpu_torch.solvers import preconditioner as tpc

torch.set_num_threads(2)


def rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


# ---------------------------------------------------------------- Krylov
N = 80
_rng = np.random.default_rng(42)
_Q, _ = np.linalg.qr(_rng.standard_normal((N, N)))
SPD = _Q @ np.diag(np.linspace(1.0, 300.0, N)) @ _Q.T
_S = _rng.standard_normal((N, N))
NONSYM = SPD + 3.0 * (_S - _S.T)
B = _rng.standard_normal(N)
TOLS = [1e-2, 1e-5, 1e-8, 1e-11]

SOLVERS = {
    # name: (operator, solver call (module, A, M, b, tol))
    "cg": (SPD, lambda m, A, M, b, tol: m.cg(A, b, None, tol, 300, M=M)),
    "bicgstab": (NONSYM, lambda m, A, M, b, tol: m.bicgstab(A, b, None, tol, 300, M=M)),
    "gmres": (NONSYM, lambda m, A, M, b, tol: m.gmres(A, b, None, tol, 300, restart=10, M=M)),
    "fgmres": (NONSYM, lambda m, A, M, b, tol: m.fgmres(A, b, None, tol, 300, restart=10, M=M)),
}


@pytest.mark.parametrize("name", list(SOLVERS))
def test_krylov_iterations_and_residual_history(name):
    mat, call = SOLVERS[name]
    dinv = 1.0 / np.diag(mat)
    jA, jd, jb = jnp.asarray(mat), jnp.asarray(dinv), jnp.asarray(B)
    tA, td, tb = torch.tensor(mat), torch.tensor(dinv), torch.tensor(B)
    jsolve = jax.jit(
        lambda b, tol: call(jk, lambda x: jA @ x, lambda r: jd * r, b, tol)
    )
    bnorm = float(np.linalg.norm(B))
    for tol in TOLS:
        ref = jsolve(jb, jnp.float64(tol * bnorm))
        got = call(tk, lambda x: tA @ x, lambda r: td * r, tb, tol * bnorm)
        assert got.iterations == int(ref.iterations) > 0, tol
        assert got.converged == bool(ref.converged)
        # relative 1e-8, with a floor for residuals near roundoff
        floor = 1e-14 * bnorm
        assert abs(got.residual - float(ref.residual)) <= 1e-8 * float(ref.residual) + floor
        assert rel(got.x, ref.x) <= 1e-8


# ---------------------------------------------------------------- block preconditioner
PRM = """
subsection Navier-Stokes
  set dimension = 2
  set viscosity = 0.05
end
"""


def _ns_setup(Params, Mesh, Space, Cons, ns, **kw):
    par = Params.from_string(PRM)
    mesh = Mesh((16, 16), (-1.0, -1.0), (1.0, 1.0))
    us, ps = Space(mesh, 2), Space(mesh, 1)
    cu = [Cons(us.n_dofs) for _ in range(2)]
    for c in cu:
        c.add_dirichlet(us.boundary_dofs(0))
        c.close()
    cp = Cons(ps.n_dofs)
    cp.close()
    cs = Cons(ps.n_dofs)
    cs.add_dirichlet(ps.boundary_dofs(0)[:1])
    cs.close()
    op = ns.NavierStokesOperator(par, us, ps, cu, cp, **kw)
    return par, op, cs


def _to_jax_state(st: tpc.PrecState, jlin):
    """The port's preconditioner state as the JAX package's PrecState."""
    j = lambda t: jnp.asarray(t.numpy()) if torch.is_tensor(t) else jnp.float64(t)

    def gmg(s):
        levels = tuple(
            jmg.LevelState(j(l.alpha), j(l.beta), j(l.diag), j(l.lmax)) for l in s.levels
        )
        return jmg.GMGState(levels, None if s.coarse_matrix is None else j(s.coarse_matrix))

    return jpc.PrecState(
        j(st.u_diag), j(st.u_lambda_max), j(st.poisson_diag),
        j(st.poisson_lambda_max), j(st.mass_diag), j(st.mass_diag_w),
        j(st.inv_rho_weight), j(st.mass_coefficient), jlin, jns.Coefficients(),
        tuple(gmg(s) for s in st.u_gmg), gmg(st.p_gmg), j(st.u_cheb_growth),
    )


def test_preconditioner_apply(monkeypatch):
    monkeypatch.setenv("ADAFLO_PALLAS_MATVEC", "0")
    jpar, jop, jcs = _ns_setup(JParams, JMesh, JSpace, JConstraints, jns)
    tpar, top, tcs = _ns_setup(TParams, TMesh, TSpace, TConstraints, tns, device="cpu")
    jprec = jpc.NavierStokesPreconditioner(jpar, jop, jcs)
    tprec = tpc.NavierStokesPreconditioner(tpar, top, tcs)
    rng = np.random.default_rng(11)
    u = rng.standard_normal((2, top.u_space.n_dofs))
    p = rng.standard_normal(top.p_space.n_dofs)
    r_u = rng.standard_normal(u.shape)
    r_p = rng.standard_normal(p.shape)
    tw = (1.5 / 0.05, -2.0 / 0.05, 0.5 / 0.05, 1.0)
    jtw = jns.TimeWeights(*(jnp.float64(w) for w in tw))
    ttw = tns.TimeWeights(*tw)
    tu, tp = torch.tensor(u), torch.tensor(p)
    tlin = top.residual_assemble(tu, tp, tu, tu, ttw)[2]
    st = tprec.compute(ttw, tlin, tns.Coefficients())
    assert st.u_gmg is not None and st.p_gmg is not None

    def japply(u, p, r_u, r_p, jst_parts):
        jlin = jop.residual_assemble(u, p, u, u, jtw)[2]
        jst = jst_parts._replace(lin=jlin)
        return jprec.apply(jst, (r_u, r_p), jtw, False, False)

    jst = _to_jax_state(st, None)
    ju = jnp.asarray(u)
    jdu, jdp = jax.jit(japply)(ju, jnp.asarray(p), jnp.asarray(r_u), jnp.asarray(r_p), jst)
    tdu, tdp = tprec.apply(st, (torch.tensor(r_u), torch.tensor(r_p)), ttw, False, False)
    assert rel(tdu, jdu) <= 1e-10
    assert rel(tdp, jdp) <= 1e-10
