"""The port's level-set operators (adaflo_tpu_torch/ops/level_set.py)
against the JAX package's LevelSetOperators, float64 on the CPU.

Each method of the lattice branch runs in both packages on the same
numpy-seeded fields: the lumped mass, the projection diagonal, the advection
rhs (with its frozen convection) and vmult, the normal rhs, the projection
vmult (block and scalar), the curvature rhs, the reinitialization rhs (the
first compression step, a later one and a diffusion step) and vmult, and
the surface-tension force with its per-q-point density and viscosity, the
heaviside gradient taken on the pressure's support points and on the level
set. Cases: a 2D lattice with the iso-Q1 concentration in 4 subdivisions
and 3D lattices in 1 and 2 subdivisions, a few cells a side, with inflow
(Dirichlet) concentration rows on one side; the advection also with the
convection stabilization on. Tolerance: 1e-12 relative to the largest entry
of the JAX result. The JAX side runs eagerly (no compile)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaflo_tpu.fe.constraints import Constraints as JConstraints
from adaflo_tpu.fe.space import ScalarSpace as JSpace
from adaflo_tpu.mesh.structured import StructuredMesh as JMesh
from adaflo_tpu.ops import level_set as jls
from adaflo_tpu.ops import navier_stokes as jns
from adaflo_tpu.parameters import FlowParameters as JParams
from adaflo_tpu_torch.fe.constraints import Constraints as TConstraints
from adaflo_tpu_torch.fe.space import ScalarSpace as TSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh as TMesh
from adaflo_tpu_torch.ops import level_set as tls
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.parameters import FlowParameters as TParams

torch.set_num_threads(2)

TOL = 1e-12
PRM = """
subsection Two phase
  set density              = 1.
  set density difference   = -0.9
  set viscosity            = 0.01
  set viscosity difference = -0.009
  set surface tension      = 0.0245
  set epsilon              = 1.5
  set gravity              = 0.98
  set concentration subdivisions = {sub}
  set grad pressure compatible = {gpc}
  set convection stabilization = {stab}
end
subsection Navier-Stokes
  set dimension = {dim}
  set velocity degree = 2
end
"""

# (dim, subdivisions, cells per axis)
CASES = {
    "2d_sub4": (2, 4, (3, 4)),
    "3d_sub1": (3, 1, (3, 2, 4)),
    "3d_sub2": (3, 2, (2, 3, 2)),
}


def rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def build(key, stab=0, gpc=1):
    dim, sub, cells = CASES[key]
    text = PRM.format(dim=dim, sub=sub, stab=stab, gpc=gpc)
    sides = {}
    for pkg, Params, Mesh, Space, Cons, ls in (
        ("jax", JParams, JMesh, JSpace, JConstraints, jls),
        ("torch", TParams, TMesh, TSpace, TConstraints, tls),
    ):
        par = Params.from_string(text)
        mesh = Mesh.subdivided_hyper_rectangle(cells, (0.0,) * dim, (1.0,) * (dim - 1) + (1.5,))
        mesh.set_side_boundary_id(0, 0, 3)
        lsp = Space(mesh, sub, "iso_q1")
        usp, psp = Space(mesh, 2), Space(mesh, 1)
        con = Cons(lsp.n_dofs)
        con.add_dirichlet(lsp.boundary_dofs(3))
        con.close()
        free = []
        for _ in range(2):
            c = Cons(lsp.n_dofs)
            c.close()
            free.append(c)
        h = float(np.max(mesh.h))
        eps = par.epsilon / sub * h
        args = (par, lsp, usp, psp, con, free[0], free[1], eps, h, float(np.min(mesh.h)))
        kw = {} if pkg == "jax" else dict(device="cpu")
        sides[pkg] = ls.LevelSetOperators(*args, **kw)
    return sides


def fields(ops, seed):
    rng = np.random.default_rng(seed)
    n_ls = ops.ls_space.n_dofs
    n_u = ops.u_space.n_dofs
    dim = ops.dim
    f = dict(
        c=np.tanh(rng.standard_normal(n_ls)),
        c_old=np.tanh(rng.standard_normal(n_ls)),
        c_old_old=np.tanh(rng.standard_normal(n_ls)),
        u=rng.standard_normal((dim, n_u)),
        u_old=rng.standard_normal((dim, n_u)),
        u_old_old=rng.standard_normal((dim, n_u)),
        nv=rng.standard_normal((dim, n_ls)),
        dc=rng.standard_normal(n_ls),
        kappa=rng.standard_normal(n_ls),
        heaviside=rng.uniform(0.0, 1.0, n_ls),
        en=rng.standard_normal((ops.ls_space.mesh.n_cells, dim, ops.n_q)),
    )
    return f


TW = (1.5 / 0.02, -2.0 / 0.02, 0.5 / 0.02, 1.0)


def both(sides, seed):
    f = fields(sides["jax"], seed)
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    tf = {k: torch.tensor(v) for k, v in f.items()}
    jtw = jns.TimeWeights(*(jnp.float64(w) for w in TW))
    ttw = tns.TimeWeights(*TW)
    return (sides["jax"], jf, jtw), (sides["torch"], tf, ttw)


def check(name, got, ref):
    assert rel(got, ref) <= TOL, (name, rel(got, ref))


@pytest.mark.parametrize("key", sorted(CASES))
def test_mass_and_diagonals(key):
    sides = build(key)
    j, t = sides["jax"], sides["torch"]
    check("lumped_mass", t.lumped_mass(), j.lumped_mass())
    check("projection_diagonal", t.projection_diagonal(), j.projection_diagonal())
    np.testing.assert_array_equal(t.interp_ls_to_p.numpy(), np.asarray(j.interp_ls_to_p))


@pytest.mark.parametrize("stab", [0, 1])
@pytest.mark.parametrize("key", sorted(CASES))
def test_advection(key, stab):
    (j, jf, jtw), (t, tf, ttw) = both(build(key, stab=stab), seed=3)
    args = ("c", "c_old", "c_old_old", "u", "u_old", "u_old_old")
    jr, jconv, jnu = j.advection_rhs(*(jf[a] for a in args), jtw, True, 0.02)
    tr, tconv, tnu = t.advection_rhs(*(tf[a] for a in args), ttw, True, 0.02)
    check("advection_rhs", tr, jr)
    check("evaluated_convection", tconv, jconv)
    assert (tnu is None) == (jnu is None) == (not stab)
    if stab:
        check("nu_art", tnu, jnu)
    jr2 = j.advection_rhs(*(jf[a] for a in args), jtw, False, 0.02)[0]
    check("advection_rhs(bdf1)", t.advection_rhs(*(tf[a] for a in args), ttw, False, 0.02)[0], jr2)
    mass_j, mass_t = j.lumped_mass(), t.lumped_mass()
    check(
        "advection_vmult",
        t.advection_vmult(tf["dc"], tconv, ttw, mass_t, tnu),
        j.advection_vmult(jf["dc"], jconv, jtw, mass_j, jnu),
    )


@pytest.mark.parametrize("key", sorted(CASES))
def test_normal_projection_curvature(key):
    (j, jf, _), (t, tf, _) = both(build(key), seed=5)
    check("normal_rhs", t.normal_rhs(tf["c"]), j.normal_rhs(jf["c"]))
    check("projection_vmult_block", t.projection_vmult_block(tf["nv"]),
          j.projection_vmult_block(jf["nv"]))
    check("projection_vmult_scalar", t.projection_vmult_scalar(tf["kappa"]),
          j.projection_vmult_scalar(jf["kappa"]))
    # a few normals below the 1e-2 cut-off of the normalization
    jnv = jf["nv"].at[:, :3].multiply(1e-3)
    tnv = tf["nv"].clone()
    tnv[:, :3] *= 1e-3
    check("curvature_rhs", t.curvature_rhs(tnv), j.curvature_rhs(jnv))


@pytest.mark.parametrize("key", sorted(CASES))
def test_reinitialization(key):
    (j, jf, _), (t, tf, _) = both(build(key), seed=7)
    mass_j, mass_t = j.lumped_mass(), t.lumped_mass()
    for first, diffuse in ((True, False), (False, False), (False, True)):
        jr, jen = j.reinit_rhs(jf["c"], jf["nv"], first, jf["en"], diffuse)
        tr, ten = t.reinit_rhs(tf["c"], tf["nv"], first, tf["en"], diffuse)
        label = f"first={first} diffuse={diffuse}"
        check("reinit_rhs " + label, tr, jr)
        check("evaluated_normal " + label, ten, jen)
        check(
            "reinit_vmult " + label,
            t.reinit_vmult(tf["dc"], ten, 37.5, diffuse, mass_t),
            j.reinit_vmult(jf["dc"], jen, 37.5, diffuse, mass_j),
        )


@pytest.mark.parametrize("gpc", [1, 0])
@pytest.mark.parametrize("key", sorted(CASES))
def test_force_and_coefficients(key, gpc):
    (j, jf, _), (t, tf, _) = both(build(key, gpc=gpc), seed=9)
    ju, jrho, jmu = j.compute_force(jf["heaviside"], jf["kappa"])
    tu, trho, tmu = t.compute_force(tf["heaviside"], tf["kappa"])
    check("user_rhs_u", tu, ju)
    check("rho_q", trho, jrho)
    check("mu_q", tmu, jmu)
    assert trho.shape == (t.ls_space.mesh.n_cells, 3 ** t.dim)
