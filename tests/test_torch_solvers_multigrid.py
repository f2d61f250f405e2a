"""One LatticeGMG V-cycle and its level data (adaflo_tpu_torch.solvers.
multigrid) against the JAX package, float64 on the CPU: level diagonals and
coarse matrix to 1e-13 relative, Lanczos lambda_max to 1e-12, the V-cycle to
1e-10 (its coarse CG stops at a 1e-10 reduction). A file of its own: the JAX
program's compile takes most of its time."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from adaflo_tpu.solvers import multigrid as jmg
from adaflo_tpu_torch.solvers import multigrid as tmg

torch.set_num_threads(2)


def rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_lattice_gmg_vcycle():
    nodes = (33, 33)
    h = np.array([1.0 / 16, 1.0 / 16])
    lat = np.arange(33 * 33).reshape(33, 33)
    dirichlet = np.unique(np.concatenate([lat[0], lat[-1], lat[:, 0], lat[:, -1]]))
    jg = jmg.LatticeGMG(nodes, h, dirichlet, 33 * 33 + 3)
    tg = tmg.LatticeGMG(nodes, h, dirichlet, 33 * 33 + 3, device="cpu")
    assert len(tg.levels) == len(jg.levels) == 2
    b = np.random.default_rng(5).standard_normal(33 * 33 + 3)

    def jrun(b):
        st = jg.compute(jnp.float64(30.0), jnp.float64(0.05))
        return st, jg.vmult(st, b)

    jst, jx = jax.jit(jrun)(jnp.asarray(b))
    tst = tg.compute(30.0, 0.05)
    for jl, tl in zip(jst.levels, tst.levels):
        assert rel(tl.diag, jl.diag) <= 1e-13
        assert abs(tl.lmax - float(jl.lmax)) <= 1e-12 * float(jl.lmax)
    assert rel(tst.coarse_matrix, jst.coarse_matrix) <= 1e-13
    assert rel(tg.vmult(tst, torch.tensor(b)), jx) <= 1e-10
