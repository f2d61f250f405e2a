"""Adaptive Morton forest mesh.

PyTorch port's counterpart of ``adaflo_tpu/mesh/forest.py``: the Python face
of the native C++ forest (``adaflo_tpu_torch/native/forest.cc``, the
counterpart of p4est, SURVEY.md section 2.3): a forest of quad/octrees over
a structured root grid, refine/coarsen with full 2:1 balance, Morton
enumeration of the active cells and face-neighbor queries across levels.
The hanging-node spaces, the index-map operator path and the solution
transfer build on these queries; the mesh itself lives on the host.

The shared library is built with g++ at first use into
``build/adaflo_tpu_torch/`` under the repository root, as
``libforest_<hash>.so``, the hash that of the source (ops/build.source_tag),
so that an edited source is built anew and an unchanged one once.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from adaflo_tpu_torch.ops.build import BUILD_DIR, source_tag

SOURCE = Path(__file__).resolve().parents[1] / "native" / "forest.cc"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """The library of this source, built when no library of its hash exists
    (into a file of this process, then renamed, so that processes started
    together do not read a half-written library)."""
    so = BUILD_DIR / f"libforest_{source_tag(SOURCE)}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build {SOURCE.name}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
    return so


def _load():
    lib = ctypes.CDLL(str(library_path()))
    lib.forest_create.restype = ctypes.c_void_p
    lib.forest_create.argtypes = [ctypes.c_int] * 4
    lib.forest_destroy.argtypes = [ctypes.c_void_p]
    lib.forest_n_cells.restype = ctypes.c_int64
    lib.forest_n_cells.argtypes = [ctypes.c_void_p]
    lib.forest_max_level.restype = ctypes.c_int
    lib.forest_max_level.argtypes = [ctypes.c_void_p]
    lib.forest_get_cells.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.forest_adapt.restype = ctypes.c_int64
    lib.forest_adapt.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int8)]
    lib.forest_face_neighbors.restype = ctypes.c_int
    lib.forest_face_neighbors.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


_LIB = None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class ForestMesh:
    """Adaptive forest over a structured root grid on a hyper-rectangle."""

    def __init__(self, n_roots, origin, lengths) -> None:
        global _LIB
        if _LIB is None:
            _LIB = _load()
        self.dim = len(n_roots)
        self.n_roots = tuple(int(n) for n in n_roots)
        self.origin = np.asarray(origin, dtype=np.float64)
        self.lengths = np.asarray(lengths, dtype=np.float64)
        nz = self.n_roots[2] if self.dim == 3 else 1
        self._h = _LIB.forest_create(self.dim, self.n_roots[0], self.n_roots[1], nz)
        # boundary ids per (axis, side), one per whole side; the default id
        # 0 covers the whole boundary like GridGenerator's default
        self._boundary_ids = {(a, s): 0 for a in range(self.dim) for s in (0, 1)}

    def set_boundary_id(self, axis: int, side: int, bid: int) -> None:
        self._boundary_ids[(axis, side)] = bid

    def boundary_ids(self, axis: int, side: int):
        return np.array([self._boundary_ids[(axis, side)]])

    def sides_with_boundary_id(self, bid: int):
        return [k for k, v in self._boundary_ids.items() if v == bid]

    @property
    def cell_diameter(self) -> float:
        """Diameter of the smallest (finest-level) cell."""
        _, h = self.cell_geometry()
        return float(np.linalg.norm(h, axis=1).min())

    def set_periodic(self, axis: int) -> None:
        raise NotImplementedError(
            "periodicity on adaptive forests is not supported; use "
            "StructuredMesh for periodic directions"
        )

    def __del__(self):
        if getattr(self, "_h", None) and _LIB is not None:
            _LIB.forest_destroy(self._h)
            self._h = None

    @property
    def n_cells(self) -> int:
        return int(_LIB.forest_n_cells(self._h))

    @property
    def max_level(self) -> int:
        return int(_LIB.forest_max_level(self._h))

    def cells(self):
        """(roots (E,3), levels (E,), anchors (E,3)) in Morton order."""
        E = self.n_cells
        roots = np.zeros(3 * E, dtype=np.int32)
        levels = np.zeros(E, dtype=np.int32)
        anchors = np.zeros(3 * E, dtype=np.int64)
        _LIB.forest_get_cells(
            self._h, _ptr(roots, ctypes.c_int32), _ptr(levels, ctypes.c_int32),
            _ptr(anchors, ctypes.c_int64),
        )
        return roots.reshape(E, 3), levels, anchors.reshape(E, 3)

    def adapt(self, flags: np.ndarray) -> int:
        """flags: +1 refine, -1 coarsen (sibling groups), 0 keep. Applies
        2:1 balance; returns the new cell count."""
        flags = np.ascontiguousarray(flags, dtype=np.int8)
        assert len(flags) == self.n_cells
        return int(_LIB.forest_adapt(self._h, _ptr(flags, ctypes.c_int8)))

    def refine_global(self, times: int = 1) -> None:
        for _ in range(times):
            self.adapt(np.ones(self.n_cells, dtype=np.int8))

    def face_neighbors(self, i: int, axis: int, side: int):
        """(indices, relation): relation 0 same level, -1 coarser, +1 finer;
        empty indices = domain boundary."""
        out = np.zeros(4, dtype=np.int32)
        rel = np.zeros(1, dtype=np.int32)
        n = _LIB.forest_face_neighbors(
            self._h, i, axis, side, _ptr(out, ctypes.c_int32), _ptr(rel, ctypes.c_int32)
        )
        return out[:n].copy(), int(rel[0])

    def clone(self) -> "ForestMesh":
        """An identical forest, rebuilt by refinement from the roots (adapt
        mutates in place; the GMG hierarchy coarsens a copy)."""
        other = ForestMesh(self.n_roots, self.origin, self.lengths)
        other._boundary_ids = dict(self._boundary_ids)
        roots, levels, anchors = self.cells()
        target = {
            (tuple(r), int(l), tuple(a)) for r, l, a in zip(roots, levels, anchors)
        }
        # refine every cell that is a strict ancestor of a target cell
        while True:
            o_roots, o_levels, o_anchors = other.cells()
            flags = np.array(
                [
                    (tuple(r), int(l), tuple(a)) not in target
                    for r, l, a in zip(o_roots, o_levels, o_anchors)
                ],
                dtype=np.int8,
            )
            if not flags.any():
                return other
            other.adapt(flags)

    def coarsened(self) -> "ForestMesh":
        """One global-coarsening step: merge every complete sibling group
        (deal.II MGTransferGlobalCoarsening's next-coarser mesh)."""
        other = self.clone()
        other.adapt(np.full(other.n_cells, -1, dtype=np.int8))
        return other

    def cell_geometry(self):
        """(centers (E, dim), extents (E, dim)) in physical coordinates."""
        roots, levels, anchors = self.cells()
        h_root = self.lengths / np.asarray(self.n_roots)
        h = h_root[None, :] / (2.0 ** levels)[:, None]
        centers = (
            self.origin[None, :]
            + roots[:, : self.dim] * h_root[None, :]
            + (anchors[:, : self.dim] + 0.5) * h
        )
        return centers, h
