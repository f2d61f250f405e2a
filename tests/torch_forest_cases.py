"""Shared forests of the test_torch_forest_*.py files: the same adaptive
forest built in the JAX package and in the port, and the renewal of the JAX
forest's face-neighbor cache.

The JAX package's native forest caches its face-neighbor lookup by the
forest's address and cell count (adaflo_tpu/native/forest.cc,
forest_face_neighbors), which a forest adapted to the same count, or a new
one at a freed forest's address, repeats: its queries then read the old
cells (ROADMAP.md, F16). A query on a forest of another address and count
before a JAX forest's first query after a change renews the cache
(`fresh`); the port keys its cache by a generation number."""

import numpy as np

from adaflo_tpu.mesh.forest import ForestMesh as JForest
from adaflo_tpu_torch.mesh.forest import ForestMesh as TForest

_OTHER = JForest((1, 1, 1), (0.0,) * 3, (1.0,) * 3)


def fresh(j):
    """`j` (a JAX forest or space), the neighbor lookup renewed."""
    _OTHER.face_neighbors(0, 0, 0)
    return j


def forest_pair(dim, roots=2, refine=1, lengths=(1.0, 1.5, 0.75), origin=-0.5):
    args = ((roots,) * dim, (origin,) * dim, lengths[:dim])
    j, t = JForest(*args), TForest(*args)
    j.refine_global(refine)
    t.refine_global(refine)
    return j, t


def adapt_both(j, t, flags):
    flags = np.asarray(flags, np.int8)
    assert j.adapt(flags) == t.adapt(flags)


def hanging_pair(dim, cells=(0, 3, 5)):
    """2 x 2 (x 2) roots refined once, then `cells` refined: a forest with
    hanging nodes on every level jump."""
    j, t = forest_pair(dim)
    flags = np.zeros(j.n_cells, np.int8)
    flags[list(cells)] = 1
    adapt_both(j, t, flags)
    return fresh(j), t
