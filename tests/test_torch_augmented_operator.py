"""Augmented Taylor-Hood (FE_Q_DG0 pressure) on the lattice: the port's
operator terms, its preconditioner's pieces and its pressure error against
the JAX package, float64 on the CPU, 1e-12 relative to the largest entry of
the reference.

Two configurations, the table sets of the augmented goldens: 2D Q3/Q2+ on a
4 x 3 lattice (beltrami_2d_augp_small's elements) and 3D Q2/Q1+ on a 3 x 2 x
2 lattice (beltrami_3d_augp_small's), each with Dirichlet velocity rows on
every side, the pressure fix (two constant modes: the Q part and the cell
constants) and one Schur-complement constraint. Compared, on random vectors
(numpy seed): the residual and vmult with their rows of the cell constants
(constant and per-q-point coefficients), the pressure mass (scalar and
per-cell coefficient) with its projection of the constants' mode, the
lumped mass with the cell volumes, the pressure Poisson apply with the
constants' interior-penalty graph Laplacian and its diagonal with
dg0_diagonal, the divergence row, the pressure fix's modes and the
pressure-average projection, the Schur complement's Poisson preconditioner
(a V-cycle on the Q part, Jacobi on the constants) and its projected
pressure-mass CG, and utils.errors.l2_error_augmented_pressure. The JAX
references are one compiled program per configuration
(ADAFLO_PALLAS_MATVEC=0, which the augmented operator ignores: it builds
no Pallas tables)."""

from types import SimpleNamespace

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
from adaflo_tpu.solvers import preconditioner as jpc
from adaflo_tpu.utils.errors import l2_error_augmented_pressure as j_l2_aug
from adaflo_tpu_torch.fe.constraints import Constraints as TConstraints
from adaflo_tpu_torch.fe.space import ScalarSpace as TSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh as TMesh
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.parameters import FlowParameters as TParams
from adaflo_tpu_torch.solvers import preconditioner as tpc
from adaflo_tpu_torch.utils.errors import l2_error_augmented_pressure as t_l2_aug

torch.set_num_threads(2)

TOL = 1e-12
PRM = """
subsection Navier-Stokes
  set dimension = {dim}
  set velocity degree = {degree}
  set augmented Taylor-Hood elements = 1
  set viscosity = 0.05
  subsection Solver
    set tau grad div = 0.3
    set lin velocity preconditioner = ilu
  end
end
"""
CONFIGS = {"2d-q3": (2, 3, (4, 3), (1.0, 1.3)), "3d-q2": (3, 2, (3, 2, 2), (1.0, 1.3, 0.7))}
INV_RHO_WEIGHT = 0.7


def exact_p(x, t):
    return np.sin(2.0 * x[:, 0]) + x[:, 1] ** 2 + 0.3 * t


class Augmented:
    """One configuration in both packages, the same random inputs; the JAX
    references as one compiled program."""

    def __init__(self, dim, degree, shape, hi):
        text = PRM.format(dim=dim, degree=degree)
        built = []
        for Params, Mesh, Space, Cons, ns, pc in (
            (JParams, JMesh, JSpace, JConstraints, jns, jpc),
            (TParams, TMesh, TSpace, TConstraints, tns, tpc),
        ):
            mesh = Mesh(shape, (0.0,) * dim, hi)
            us, ps = Space(mesh, degree), Space(mesh, degree - 1)
            cu = [Cons(us.n_dofs) for _ in range(dim)]
            for c in cu:
                c.add_dirichlet(us.boundary_dofs(0))
            cp, cs = Cons(ps.n_dofs), Cons(ps.n_dofs)
            cs.add_dirichlet([2])
            for c in cu + [cp, cs]:
                c.close()
            par = Params.from_string(text)
            extra = {} if ns is jns else {"device": "cpu"}
            op = ns.NavierStokesOperator(par, us, ps, cu, cp, **extra)
            op.enable_pressure_fix()
            built.append((op, pc.NavierStokesPreconditioner(par, op, cs), cs))
        (self.jop, self.jprec, self.jcs), (self.top, self.tprec, self.tcs) = built
        self.dim, self.E = dim, mesh.n_cells
        top = self.top
        n_u, n_p, n_q = us.n_dofs, top.n_p_padded, top.n_q
        rng = np.random.default_rng(10 * dim + degree)
        vec = lambda *s: rng.standard_normal(s)
        self.np = dict(
            u=vec(dim, n_u), p=vec(n_p), uo=vec(dim, n_u), uoo=vec(dim, n_u),
            du=vec(dim, n_u), dp=vec(n_p),
            rho=rng.uniform(0.5, 2.0, (self.E, n_q)),
            mu=rng.uniform(0.01, 0.1, (self.E, n_q)),
            damping=rng.uniform(-0.3, 0.3, (self.E, n_q)),
            cell_coef=rng.uniform(0.5, 2.0, self.E),
        )
        self.t = {k: torch.tensor(v) for k, v in self.np.items()}
        tw = (1.5 / 0.05, -2.0 / 0.05, 0.5 / 0.05, 1.0)
        self.jtw = jns.TimeWeights(*(jnp.float64(w) for w in tw))
        self.ttw = tns.TimeWeights(*tw)
        self.jgmg = self.jprec.p_gmg_geom.compute(jnp.float64(0.0), jnp.float64(INV_RHO_WEIGHT))
        keys = tuple(self.np)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ADAFLO_PALLAS_MATVEC", "0")
            ref = jax.jit(self._references)(*(jnp.asarray(self.np[k]) for k in keys))
        self.ref = jax.tree_util.tree_map(np.asarray, ref)

    def _references(self, u, p, uo, uoo, du, dp, rho, mu, damping, cell_coef):
        jop, tw, cs = self.jop, self.jtw, self.jcs
        ru, rp, lin = jop.residual_assemble(u, p, uo, uoo, tw)
        co = jns.Coefficients(rho, mu, damping)
        st = SimpleNamespace(
            p_gmg=self.jgmg, inv_rho_weight=jnp.float64(INV_RHO_WEIGHT),
            mass_coefficient=jnp.float64(1.7),
            mass_diag_w=jop.pressure_lumped_mass() * 1.7,
        )
        return dict(
            ru=ru, rp=rp, vmult=jop.vmult(du, dp, tw, lin), vmult_var=jop.vmult(du, dp, tw, lin, co),
            velocity=jop.velocity_vmult(du, tw, lin),
            mass=jop.pressure_mass_vmult(dp, jnp.float64(1.7)),
            mass_cell=jop.pressure_mass_vmult(dp, cell_coef, constraints=cs),
            lumped=jop.pressure_lumped_mass(), lumped_cell=jop.pressure_lumped_mass(cell_coef),
            poisson=jop.pressure_poisson_vmult(dp, jnp.float64(INV_RHO_WEIGHT), constraints=cs),
            poisson_rho=jop.pressure_poisson_vmult(
                dp, jnp.float64(INV_RHO_WEIGHT), jns.Coefficients(rho=rho), cs),
            poisson_diag=jop.pressure_poisson_diagonal(jnp.float64(INV_RHO_WEIGHT), cs),
            dg0_diagonal=jop.dg0_diagonal(),
            divergence=jop.divergence_vmult_add(dp, du),
            projected=jop.apply_pressure_average_projection(dp),
            schur_poisson=self.jprec._poisson_gmg_apply(st, dp),
            mass_solve=self.jprec.solve_pressure_mass(st, dp),
        )


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def aug(request):
    return Augmented(*CONFIGS[request.param])


def close(got, ref, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, err


def test_pressure_vector_and_modes(aug):
    top, jop = aug.top, aug.jop
    assert (top.n_p_q, top.n_p_total, top.n_p_padded) == (jop.n_p_q, jop.n_p_total, jop.n_p_padded)
    assert top.n_p_total == top.p_space.n_dofs + aug.E
    for mine, ref in ((top.pressure_fix_mode, jop.pressure_fix_mode),
                      (top.pressure_dg0_mode, jop.pressure_dg0_mode)):
        close(mine[0], ref[0])
        close(mine[1], ref[1])
        assert abs(mine[2] - float(ref[2])) <= TOL * abs(float(ref[2]))
    close(top.apply_pressure_average_projection(aug.t["dp"]), aug.ref["projected"])


def test_residual_assemble(aug):
    t = aug.t
    ru, rp, _ = aug.top.residual_assemble(t["u"], t["p"], t["uo"], t["uoo"], aug.ttw)
    close(ru, aug.ref["ru"])
    close(rp, aug.ref["rp"])


@pytest.mark.parametrize("variable", [False, True], ids=["const", "variable"])
def test_vmult(aug, variable):
    t, top = aug.t, aug.top
    lin = top.residual_assemble(t["u"], t["p"], t["uo"], t["uoo"], aug.ttw)[2]
    co = tns.Coefficients(t["rho"], t["mu"], t["damping"]) if variable else tns.Coefficients()
    assert top.route(lin, co) == "einsum"
    ru, rp = top.vmult(t["du"], t["dp"], aug.ttw, lin, co)
    jru, jrp = aug.ref["vmult_var" if variable else "vmult"]
    close(ru, jru)
    close(rp, jrp)
    if not variable:
        close(top.velocity_vmult(t["du"], aug.ttw, lin), aug.ref["velocity"])


def test_pressure_mass_and_lumped_mass(aug):
    t, top = aug.t, aug.top
    close(top.pressure_mass_vmult(t["dp"], 1.7), aug.ref["mass"])
    close(top.pressure_mass_vmult(t["dp"], t["cell_coef"], constraints=aug.tcs),
          aug.ref["mass_cell"])
    close(top.pressure_lumped_mass(), aug.ref["lumped"])
    close(top.pressure_lumped_mass(t["cell_coef"]), aug.ref["lumped_cell"])


def test_pressure_poisson_and_diagonals(aug):
    t, top = aug.t, aug.top
    close(top.pressure_poisson_vmult(t["dp"], INV_RHO_WEIGHT, constraints=aug.tcs),
          aug.ref["poisson"])
    close(top.pressure_poisson_vmult(
        t["dp"], INV_RHO_WEIGHT, tns.Coefficients(rho=t["rho"]), aug.tcs), aug.ref["poisson_rho"])
    close(top.pressure_poisson_diagonal(INV_RHO_WEIGHT, aug.tcs), aug.ref["poisson_diag"])
    close(top.dg0_diagonal(), aug.ref["dg0_diagonal"])
    close(top.divergence_vmult_add(t["dp"], t["du"]), aug.ref["divergence"])


def test_schur_poisson_and_mass_solve(aug):
    top, prec = aug.top, aug.tprec
    st = SimpleNamespace(
        p_gmg=prec.p_gmg_geom.compute(0.0, INV_RHO_WEIGHT), inv_rho_weight=INV_RHO_WEIGHT,
        mass_coefficient=1.7, mass_diag_w=top.pressure_lumped_mass() * 1.7,
    )
    close(prec._poisson_gmg_apply(st, aug.t["dp"]), aug.ref["schur_poisson"])
    close(prec.solve_pressure_mass(st, aug.t["dp"]), aug.ref["mass_solve"])


def test_l2_error_augmented_pressure(aug):
    for t in (0.0, 0.4):
        for n_q in (None, aug.top.p_space.degree + 2):
            got = t_l2_aug(aug.top, aug.t["p"], exact_p, t, n_q)
            ref = j_l2_aug(aug.jop, jnp.asarray(aug.np["p"]), exact_p, t, n_q)
            assert abs(got - ref) <= TOL * abs(ref), (got, ref)
