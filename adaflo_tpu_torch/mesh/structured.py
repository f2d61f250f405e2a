"""Structured hyper-rectangle meshes with boundary-id bookkeeping.

TPU-native counterpart of deal.II's GridGenerator::subdivided_hyper_rectangle
plus parallel::distributed::Triangulation for the uniform-mesh configurations
of the reference test suite (e.g. tests/poiseuille.cc:224-252).
Cells live on a regular lattice; all geometry is captured by per-axis spacings,
so device kernels only ever see scalars/sizes — no coordinate arrays on the
hot path. Adaptive (forest-of-octree) meshes are layered on top separately.

Cell ordering is lexicographic with x fastest; this is the batching axis of
every device kernel (the analog of the reference's VectorizedArray cell
batching, navier_stokes_matrix.h:264-283).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np


class StructuredMesh:
    def __init__(
        self,
        n_cells_axis: tuple[int, ...],
        origin: tuple[float, ...],
        lengths: tuple[float, ...],
    ) -> None:
        self.dim = len(n_cells_axis)
        assert self.dim in (1, 2, 3)
        self.n_cells_axis = tuple(int(n) for n in n_cells_axis)
        self.origin = np.asarray(origin, dtype=np.float64)
        self.lengths = np.asarray(lengths, dtype=np.float64)
        assert len(self.origin) == self.dim and len(self.lengths) == self.dim
        self.periodic = [False] * self.dim
        # boundary ids: one int array per side (axis, end) shaped like the
        # face grid (cells grid without that axis); default id 0
        self._boundary_ids: Dict[Tuple[int, int], np.ndarray] = {}
        self._init_boundary_arrays()

    # ------------------------------------------------------------------
    @classmethod
    def hyper_cube(cls, dim: int, left: float, right: float) -> "StructuredMesh":
        return cls((1,) * dim, (left,) * dim, (right - left,) * dim)

    @classmethod
    def subdivided_hyper_rectangle(
        cls,
        subdivisions: tuple[int, ...],
        bottom_left: tuple[float, ...],
        top_right: tuple[float, ...],
    ) -> "StructuredMesh":
        lengths = tuple(t - b for b, t in zip(bottom_left, top_right))
        return cls(tuple(subdivisions), tuple(bottom_left), lengths)

    # ------------------------------------------------------------------
    def _face_grid_shape(self, axis: int) -> tuple[int, ...]:
        return tuple(n for a, n in enumerate(self.n_cells_axis) if a != axis)

    def _init_boundary_arrays(self) -> None:
        old = self._boundary_ids
        self._boundary_ids = {}
        for axis in range(self.dim):
            for end in (0, 1):
                shape = self._face_grid_shape(axis)
                arr = np.zeros(shape, dtype=np.int32)
                if (axis, end) in old:
                    # propagate ids under refinement (each face splits 2^(d-1))
                    prev = old[(axis, end)]
                    for a in range(prev.ndim):
                        prev = np.repeat(prev, shape[a] // prev.shape[a], axis=a)
                    arr[...] = prev
                self._boundary_ids[(axis, end)] = arr

    @property
    def h(self) -> np.ndarray:
        """Uniform cell extent per axis (graded meshes expose per-axis node
        arrays instead — see axis_nodes/cell_widths)."""
        assert not self.is_graded, (
            "uniform h undefined on a graded mesh; use cell_widths()"
        )
        return self.lengths / np.asarray(self.n_cells_axis, dtype=np.float64)

    @property
    def is_graded(self) -> bool:
        return getattr(self, "_axis_nodes", None) is not None

    def apply_axis_transform(self, axis: int, fn) -> None:
        """Monotone coordinate map along one axis (GridTools::transform for
        tensor-product gradings, e.g. the periodic channel's tanh wall
        clustering, periodic_channel.cc:242-246). Apply after all
        refinement."""
        if getattr(self, "_axis_nodes", None) is None:
            self._axis_nodes = [None] * self.dim
        uniform = self.origin[axis] + (
            self.lengths[axis]
            / self.n_cells_axis[axis]
            * np.arange(self.n_cells_axis[axis] + 1)
        )
        nodes = np.asarray([float(fn(x)) for x in uniform])
        assert (np.diff(nodes) > 0).all(), "grading must be monotone"
        self._axis_nodes[axis] = nodes

    def axis_nodes(self, axis: int) -> np.ndarray:
        """Cell-boundary coordinates along an axis (graded or uniform)."""
        if self.is_graded and self._axis_nodes[axis] is not None:
            return self._axis_nodes[axis]
        return np.linspace(
            self.origin[axis],
            self.origin[axis] + self.lengths[axis],
            self.n_cells_axis[axis] + 1,
        )

    def cell_widths(self) -> np.ndarray:
        """(n_cells, dim) per-cell extents, cells lexicographic x fastest."""
        per_axis = [np.diff(self.axis_nodes(a)) for a in range(self.dim)]
        out = np.empty((self.n_cells, self.dim))
        for a in range(self.dim):
            shape = [1] * self.dim
            shape[self.dim - 1 - a] = -1
            out[:, a] = np.broadcast_to(
                per_axis[a].reshape(shape), tuple(reversed(self.n_cells_axis))
            ).reshape(-1)
        return out

    def cell_origins(self) -> np.ndarray:
        """(n_cells, dim) lower-corner coordinates (lexicographic)."""
        per_axis = [self.axis_nodes(a)[:-1] for a in range(self.dim)]
        out = np.empty((self.n_cells, self.dim))
        for a in range(self.dim):
            shape = [1] * self.dim
            shape[self.dim - 1 - a] = -1
            out[:, a] = np.broadcast_to(
                per_axis[a].reshape(shape), tuple(reversed(self.n_cells_axis))
            ).reshape(-1)
        return out

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.n_cells_axis))

    @property
    def cell_diameter(self) -> float:
        if self.is_graded:
            return float(np.linalg.norm(self.cell_widths(), axis=1).min())
        return float(np.linalg.norm(self.h))

    def refine_global(self, times: int = 1) -> None:
        if times <= 0:
            return
        assert not self.is_graded, "refine before applying axis gradings"
        for _ in range(times):
            self.n_cells_axis = tuple(2 * n for n in self.n_cells_axis)
            self._init_boundary_arrays()

    def set_periodic(self, axis: int) -> None:
        self.periodic[axis] = True

    # ------------------------------------------------------------------
    def face_centers(self, axis: int, end: int) -> np.ndarray:
        """Centers of the boundary faces of side (axis, end), shape
        (n_faces, dim) in face-grid lexicographic order (first remaining axis
        fastest)."""
        h = self.h
        axes = [a for a in range(self.dim) if a != axis]
        grids = []
        for a in axes:
            grids.append(
                self.origin[a] + h[a] * (np.arange(self.n_cells_axis[a]) + 0.5)
            )
        coord_fixed = self.origin[axis] + (self.lengths[axis] if end else 0.0)
        if not axes:
            pts = np.array([[coord_fixed]])
            return pts
        mesh = np.meshgrid(*grids, indexing="ij")
        n_faces = mesh[0].size
        out = np.empty((n_faces, self.dim))
        out[:, axis] = coord_fixed
        for i, a in enumerate(axes):
            # face-grid arrays are indexed [first_remaining_axis, ...]; we
            # flatten in C order to match _boundary_ids flattening
            out[:, a] = mesh[i].reshape(-1)
        return out

    def set_boundary_id(
        self, predicate: Callable[[np.ndarray], np.ndarray], boundary_id: int
    ) -> None:
        """Assign `boundary_id` to every boundary face whose center satisfies
        `predicate` (vectorized over an (n_faces, dim) array)."""
        for (axis, end), ids in self._boundary_ids.items():
            centers = self.face_centers(axis, end)
            mask = np.asarray(predicate(centers), dtype=bool).reshape(ids.shape)
            ids[mask] = boundary_id

    def set_side_boundary_id(self, axis: int, end: int, boundary_id: int) -> None:
        self._boundary_ids[(axis, end)][...] = boundary_id

    def boundary_ids(self, axis: int, end: int) -> np.ndarray:
        return self._boundary_ids[(axis, end)]

    def all_boundary_ids(self) -> set[int]:
        ids: set[int] = set()
        for axis in range(self.dim):
            if self.periodic[axis]:
                continue
            for end in (0, 1):
                ids |= set(np.unique(self._boundary_ids[(axis, end)]).tolist())
        return ids

    # ------------------------------------------------------------------
    def cell_index(self, cell_coords: np.ndarray) -> np.ndarray:
        """Lexicographic cell index (x fastest) from per-axis integer coords."""
        idx = np.asarray(cell_coords[..., 0])
        stride = 1
        for a in range(1, self.dim):
            stride *= self.n_cells_axis[a - 1]
            idx = idx + stride * cell_coords[..., a]
        return idx
