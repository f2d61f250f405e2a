"""Shared cases and checks of the test_torch_navier_stokes_operator*.py
files: the port's NavierStokesOperator and the plain version of its coupled
cell apply against the JAX package's einsum operator, float64 on the CPU.

A table set (3D Q2/Q1 on the (3, 4, 2) mesh of test_pallas_matvec.py, 2D
Q2/Q1, 3D Q3/Q2) is built unconstrained and with Dirichlet velocity rows,
one constrained pressure row and the pressure-fix projection. The JAX
operator runs with ADAFLO_PALLAS_MATVEC=0 (its einsum path); its references
are one compiled program per case. Tolerance: 1e-12 relative to the largest
entry of the reference, the bar of test_pallas_matvec.py. One file per table
set keeps each file's JAX compile time small."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from concurrent.futures import ThreadPoolExecutor

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

torch.set_num_threads(2)

TOL = 1e-12
PRM = """
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


class Case:
    """One configuration built in both packages with the same random inputs.
    The JAX references are traced here and compiled by `build_cases`."""

    def __init__(self, dim, degree, constrained):
        text = PRM.format(dim=dim, degree=degree)
        if dim == 3:
            args = ((3, 4, 2), (0.0, 0.0, 0.0), (1.0, 1.3, 0.7))
        else:
            args = ((4, 3), (0.0, 0.0), (1.0, 1.3))
        self.ops = []
        for Params, Mesh, Space, Cons, ns in (
            (JParams, JMesh, JSpace, JConstraints, jns),
            (TParams, TMesh, TSpace, TConstraints, tns),
        ):
            mesh = Mesh(*args)
            us, ps = Space(mesh, degree), Space(mesh, degree - 1)
            cu = [Cons(us.n_dofs) for _ in range(dim)]
            cp = Cons(ps.n_dofs)
            if constrained:
                for c in cu:
                    c.add_dirichlet(us.boundary_dofs(0))
                cp.add_dirichlet([3])
            for c in cu + [cp]:
                c.close()
            extra = {} if ns is jns else {"device": "cpu"}
            op = ns.NavierStokesOperator(Params.from_string(text), us, ps, cu, cp, **extra)
            if constrained:
                if ns is jns:
                    # compile the two heavy steps of the JAX setup as programs
                    # (eager dispatch compiles op by op)
                    op._scatter_p_plain = jax.jit(op._scatter_p_plain)
                    op.ev_p_low.integrate_values = jax.jit(op.ev_p_low.integrate_values)
                op.enable_pressure_fix()
            self.ops.append(op)
        self.jop, self.top = self.ops
        self.dim, self.E = dim, mesh.n_cells
        self.n_u, self.n_p = us.n_dofs, ps.n_dofs
        self.n_q = self.top.n_q
        rng = np.random.default_rng(100 * dim + 10 * degree + constrained)
        vec = lambda *s: rng.standard_normal(s)
        self.np = dict(
            u=vec(dim, self.n_u), p=vec(self.n_p), uo=vec(dim, self.n_u),
            uoo=vec(dim, self.n_u), du=vec(dim, self.n_u), dp=vec(self.n_p),
            rho=rng.uniform(0.5, 2.0, (self.E, self.n_q)),
            mu=rng.uniform(0.01, 0.1, (self.E, self.n_q)),
            damping=rng.uniform(-0.3, 0.3, (self.E, self.n_q)),
        )
        self.t = {k: torch.tensor(v) for k, v in self.np.items()}
        tw = (1.5 / 0.05, -2.0 / 0.05, 0.5 / 0.05, 1.0)
        self.jtw = jns.TimeWeights(*(jnp.float64(w) for w in tw))
        self.ttw = tns.TimeWeights(*tw)
        t = self.t
        self.tres = self.top.residual_assemble(t["u"], t["p"], t["uo"], t["uoo"], self.ttw)
        self.args = tuple(jnp.asarray(self.np[k]) for k in self._KEYS)
        self.lowered = jax.jit(self._references).lower(*self.args)

    _KEYS = ("u", "p", "uo", "uoo", "du", "dp", "rho", "mu", "damping")

    def _references(self, u, p, uo, uoo, du, dp, rho, mu, damping):
        """Every JAX quantity the tests compare with, as one program. The
        cell-apply results are taken without the pressure-fix projection
        ("raw"); the tests apply the JAX operator's projection to them."""
        jop, tw = self.jop, self.jtw
        ru, rp, lin = jop.residual_assemble(u, p, uo, uoo, tw)
        co = jns.Coefficients(rho, mu, damping)
        saved, jop.pressure_fix_mode = jop.pressure_fix_mode, None
        try:
            raw = jop.vmult(du, dp, tw, lin)
            raw_var = jop.vmult(du, dp, tw, lin, co)
        finally:
            jop.pressure_fix_mode = saved
        cp = jop.constraints_p
        return dict(
            ru=ru, rp=rp, val=lin.val, grad=lin.grad, div=lin.div,
            raw=raw, raw_var=raw_var,
            velocity=jop.velocity_vmult(du, tw, lin),
            velocity_diag=jop.velocity_block_diagonal(tw, lin),
            poisson_diag=jop.pressure_poisson_diagonal(jnp.float64(0.7), cp),
            poisson=jop.pressure_poisson_vmult(dp, jnp.float64(0.7)),
            mass=jop.pressure_mass_vmult(dp, jnp.float64(1.7)),
            lumped=jop.pressure_lumped_mass(),
            divergence=jop.divergence_vmult_add(dp, du),
        )

    def project(self, rp):
        """The JAX operator's pressure-average projection, in numpy."""
        if self.jop.pressure_fix_mode is None:
            return rp
        mode, weights, inv = (np.asarray(x) for x in self.jop.pressure_fix_mode)
        return rp - (weights @ rp) * inv * mode

    def coeffs(self):
        t = self.t
        return tns.Coefficients(t["rho"], t["mu"], t["damping"])


def case_keys(dim, degree):
    keys = [(dim, degree, False), (dim, degree, True)]
    ids = [f"{dim}d-q{degree}-{'con' if c else 'free'}" for _, _, c in keys]
    return keys, ids


def build_cases(keys):
    """The configurations of one table set; their JAX reference programs
    compile concurrently (XLA compiles outside the interpreter lock)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
        built = {key: Case(*key) for key in keys}
    with ThreadPoolExecutor(max_workers=len(built)) as pool:
        compiled = dict(zip(built, pool.map(lambda c: c.lowered.compile(), built.values())))
    for key, c in built.items():
        c.ref = jax.tree_util.tree_map(np.asarray, compiled[key](*c.args))
        c.lowered = None
    return built


def close(got, ref, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, err


def check_residual_assemble(case):
    tru, trp, tlin = case.tres
    ref = case.ref
    close(tru, ref["ru"])
    close(trp, ref["rp"])
    close(tlin.val, ref["val"])
    close(tlin.grad, ref["grad"])
    close(tlin.div, ref["div"])


def check_vmult(case, variable):
    tco = case.coeffs() if variable else tns.Coefficients()
    tru, trp = case.top.vmult(case.t["du"], case.t["dp"], case.ttw, case.tres[2], tco)
    jru, jrp = case.ref["raw_var" if variable else "raw"]
    close(tru, jru)
    close(trp, case.project(jrp))


def check_velocity_vmult_and_diagonals(case):
    top, t, ref = case.top, case.t, case.ref
    close(top.velocity_vmult(t["du"], case.ttw, case.tres[2]), ref["velocity"])
    close(top.velocity_block_diagonal(case.ttw, case.tres[2]), ref["velocity_diag"])
    close(top.pressure_poisson_diagonal(0.7, top.constraints_p), ref["poisson_diag"])
    close(top.pressure_poisson_vmult(t["dp"], 0.7), ref["poisson"])
    close(top.pressure_mass_vmult(t["dp"], 1.7), ref["mass"])
    close(top.pressure_lumped_mass(), ref["lumped"])
    close(top.divergence_vmult_add(t["dp"], t["du"]), ref["divergence"])


MODES = ["ids", "condense", "scale-norm", "variable", "velocity"]


def check_plain_version_mode(case, mode):
    """coupled_apply_plain in each mode against the JAX einsum vmult taken
    without the pressure-fix projection (which vmult applies after the
    cell apply)."""
    top, t = case.top, case.t
    sc = top._apply_scalars(case.ttw)
    u_star = case.tres[2].u
    if mode == "velocity":
        got = cm.coupled_apply_plain(
            t["du"], None, u_star, top.cells, sc, velocity_only=True
        )
        close(got, case.ref["velocity"])
        return
    jru, jrp = (np.array(x) for x in case.ref["raw_var" if mode == "variable" else "raw"])
    kw = dict(identity=mode != "condense")
    if mode == "variable":
        co = case.coeffs()
        kw["coeffs"] = (co.rho, co.mu, co.damping)
    if mode == "scale-norm":
        kw.update(scale=0.37, want_norm=True)
    out = cm.coupled_apply_plain(t["du"], t["dp"], u_star, top.cells, sc, **kw)
    if mode == "condense":
        for c in range(case.dim):
            jru[c, case.jop.constraints_u[c].constrained_dofs] = 0.0
        jrp[case.jop.constraints_p.constrained_dofs] = 0.0
    if mode == "scale-norm":
        jru, jrp = 0.37 * jru, 0.37 * jrp
        close(out[2], (jru**2).sum() + (jrp**2).sum())
    close(out[0], jru)
    close(out[1], jrp)
