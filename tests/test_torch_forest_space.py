"""Port's adaptive forest against the JAX package on the host: the native
forest (cells, face neighbors, adapt under seeded random flags, coarsened,
the 2:1 balance cases), the hanging-node Q_k spaces (dof numbering, node
coordinates, hanging rows, constraints; degrees 1-4 in 2D and 3D), the
point location and solution transfer, the Kelly indicators and the fixed
number marking; and the static check that the port names nothing of the
JAX package. Integer tables exactly equal, the floating-point ones at
1e-12 relative."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from adaflo_tpu.fe import forest_estimate as j_est
from adaflo_tpu.fe.forest_space import ForestSpace as JSpace
from adaflo_tpu.fe.forest_transfer import ForestFunction as JFunction
from adaflo_tpu.fe.forest_transfer import transfer_solution as j_transfer
from adaflo_tpu_torch.fe import forest_estimate as t_est
from adaflo_tpu_torch.fe.forest_space import ForestSpace as TSpace
from adaflo_tpu_torch.fe.forest_transfer import ForestFunction as TFunction
from adaflo_tpu_torch.fe.forest_transfer import transfer_solution as t_transfer
from adaflo_tpu_torch.mesh.forest import ForestMesh as TForest
from torch_forest_cases import adapt_both, forest_pair, fresh

TOL = 1e-12
ROOT = Path(__file__).resolve().parents[1]



_pair = forest_pair
_adapt_both = adapt_both
_fresh = fresh


def _random_pair(dim, seed, rounds=2, p_refine=0.3, p_coarsen=0.0, refine=1):
    j, t = _pair(dim, refine=refine)
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        u = rng.random(j.n_cells)
        flags = np.where(u < p_refine, 1, np.where(u > 1 - p_coarsen, -1, 0))
        _adapt_both(j, t, flags.astype(np.int8))
    return j, t


def _same_cells(j, t):
    for a, b in zip(j.cells(), t.cells()):
        assert np.array_equal(a, b)
    assert j.max_level == t.max_level


def _same_neighbors(j, t, dim):
    for i in range(j.n_cells):
        for axis in range(dim):
            for side in (0, 1):
                nj, rj = j.face_neighbors(i, axis, side)
                nt, rt = t.face_neighbors(i, axis, side)
                assert np.array_equal(nj, nt) and rj == rt, (i, axis, side)


@pytest.mark.parametrize("dim", [2, 3])
def test_forest_adapt_neighbors_coarsened(dim):
    """Seeded random refine and coarsen flags, three rounds: the same cells
    in Morton order after each, the same face neighbors of every cell and
    side, the same clone and next-coarser forest."""
    j, t = _pair(dim, refine=2 if dim == 2 else 1)
    rng = np.random.default_rng(7 + dim)
    for _ in range(3):
        u = rng.random(j.n_cells)
        flags = np.where(u < 0.2, 1, np.where(u > 0.6, -1, 0)).astype(np.int8)
        _adapt_both(j, t, flags)
        _same_cells(j, t)
    _same_neighbors(_fresh(j), t, dim)
    _same_cells(j.clone(), t.clone())
    jc, tc = j.coarsened(), t.coarsened()
    _same_cells(jc, tc)
    for a, b in zip(j.cell_geometry(), t.cell_geometry()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dim", [2, 3])
def test_forest_balance(dim):
    """tests/test_forest.py's balance case (a cell refined twice forces its
    neighbors to split), in 2D and 3D: the same cells, no face neighbors
    more than one level apart, the volume kept."""
    j, t = _pair(dim, roots=2, refine=1)
    flags = np.zeros(j.n_cells, np.int8)
    flags[0] = 1
    _adapt_both(j, t, flags)
    centers, _ = t.cell_geometry()
    flags = np.zeros(t.n_cells, np.int8)
    flags[np.argmin(centers.sum(axis=1))] = 1
    _adapt_both(j, t, flags)
    _same_cells(j, t)
    _, levels, _ = t.cells()
    for i in range(t.n_cells):
        for axis in range(dim):
            for side in (0, 1):
                for k in t.face_neighbors(i, axis, side)[0]:
                    assert abs(int(levels[i]) - int(levels[k])) <= 1
    assert np.isclose(t.cell_geometry()[1].prod(axis=1).sum(), np.prod(t.lengths))


SPACE_CASES = [(2, 1), (2, 2), (2, 3), (2, 4), (3, 1), (3, 2), (3, 3), (3, 4)]


@pytest.mark.parametrize("dim, degree", SPACE_CASES)
def test_forest_space(dim, degree):
    """The hanging-node Q_k space: dof numbering, node coordinates, levels,
    extents, side dofs and the hanging rows exactly equal; the closed
    constraints (3D: edge chains resolved) too."""
    j, t = _random_pair(dim, seed=degree, rounds=2 if dim == 2 else 1, p_refine=0.35)
    js, ts = JSpace(_fresh(j), degree), TSpace(t, degree)
    assert len(ts.hanging_slave) > 0
    for key in ("cell_dofs", "node_coords", "levels", "h_cells", "cell_origin",
                "hanging_slave", "hanging_master", "hanging_weight"):
        assert np.array_equal(getattr(js, key), getattr(ts, key)), key
    assert js.n_dofs == ts.n_dofs
    for a in range(dim):
        for s in (0, 1):
            assert np.array_equal(js.side_dofs(a, s), ts.side_dofs(a, s))
    jc = js.make_constraints(js.side_dofs(0, 0))
    tc = ts.make_constraints(ts.side_dofs(0, 0))
    for key in ("slave", "master", "weight", "vslave", "vmaster", "vweight",
                "constrained_dofs", "dirichlet_dofs"):
        assert np.array_equal(getattr(jc, key), getattr(tc, key)), key


@pytest.mark.parametrize("dim", [2, 3])
def test_forest_transfer_and_estimate(dim):
    """ForestFunction.locate/evaluate at seeded points, transfer_solution
    across a refine-and-coarsen adaptation and the Kelly indicators at
    1e-12, the flags of refine_and_coarsen_fixed_number (with a level cap)
    exactly equal."""
    degree = 2
    j, t = _random_pair(dim, seed=11, rounds=1, p_refine=0.3)
    js, ts = JSpace(_fresh(j), degree), TSpace(t, degree)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, js.n_dofs))
    con = js.make_constraints()
    u = np.stack([np.asarray(con.distribute_values(jnp.asarray(v))) for v in u])
    jf, tf = JFunction(js), TFunction(ts)
    pts = t.origin + rng.random((200, dim)) * t.lengths
    assert np.array_equal(jf.locate(pts), tf.locate(pts))
    ref = jf.evaluate(u, pts)
    assert np.abs(tf.evaluate(u, pts) - ref).max() <= TOL * np.abs(ref).max()

    eta_j = j_est.kelly_indicator(_fresh(js), u[0], degree + 2)
    eta_t = t_est.kelly_indicator(ts, u[0], degree + 2)
    assert np.abs(eta_t - eta_j).max() <= TOL * np.abs(eta_j).max()
    fj = j_est.refine_and_coarsen_fixed_number(js, eta_j, 0.2, 0.3, max_level=2)
    ft = t_est.refine_and_coarsen_fixed_number(ts, eta_t, 0.2, 0.3, max_level=2)
    assert np.array_equal(fj, ft) and (ft == 1).any() and (ft == -1).any()

    _adapt_both(j, t, ft)
    _same_cells(j, t)
    js2, ts2 = JSpace(_fresh(j), degree), TSpace(t, degree)
    ref = j_transfer(jf, js2, u)
    got = t_transfer(tf, ts2, u)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_forest_neighbor_lookup_follows_each_state():
    """The port's neighbor lookup is renewed for every forest state: after
    an adaptation that keeps the cell count (one cell refined, one sibling
    group coarsened), every query on the adapted forest, made before any
    other forest is queried, gives the neighbors of a forest built afresh
    with the same cells."""
    t = TForest((2, 2), (0.0, 0.0), (1.0, 1.0))
    t.refine_global(1)
    before = t.face_neighbors(5, 0, 0)
    flags = np.zeros(t.n_cells, np.int8)
    flags[0] = 1  # the lower-left root's first child
    flags[12:16] = -1  # the upper-right root's children
    assert t.adapt(flags) == 16

    def table(forest):
        return [
            forest.face_neighbors(i, axis, side)
            for i in range(forest.n_cells) for axis in (0, 1) for side in (0, 1)
        ]

    got = table(t)
    ref = table(t.clone())
    assert len(got) == len(ref)
    for (a, ra), (b, rb) in zip(got, ref):
        assert np.array_equal(a, b) and ra == rb
    assert got[4 * 5][0].tolist() != before[0].tolist()  # cell 5's -x side changed


def test_port_names_nothing_of_the_jax_package():
    """No module or source of adaflo_tpu_torch imports JAX or names the JAX
    package's modules (adaflo_tpu.<module>) or its native forest
    (adaflo_tpu/native): the port keeps its own copies."""
    pkg = ROOT / "adaflo_tpu_torch"
    bad = re.compile(r"\badaflo_tpu\.(?!_)|adaflo_tpu/native|^\s*(import|from)\s+jax\b", re.M)
    found = {}
    files = [f for ext in ("py", "cc", "cu", "cuh") for f in pkg.rglob(f"*.{ext}")]
    assert any(f.name == "forest.cc" for f in files)
    for f in files:
        hits = bad.findall(f.read_text())
        if hits:
            found[str(f.relative_to(ROOT))] = hits
    assert not found, found
