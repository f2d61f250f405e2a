"""Scalar Q_k finite-element spaces on structured meshes.

TPU-native counterpart of deal.II's DoFHandler + FE_Q / FE_Q_iso_Q1: global
dofs live on a tensor lattice; the only per-cell data device kernels need is
the (n_cells, n_local) gather/scatter index map. Local dof ordering is
lexicographic with x fastest, so a local vector reshapes to (.., ny, nx) in C
order with axes (z, y, x).

The reference counterpart builds FESystem/DoFHandler and AffineConstraints
(source/navier_stokes.cc:92-106, 228-360); here constraints
are separate (see adaflo_tpu_torch.fe.constraints).
"""

from __future__ import annotations

from functools import cached_property
from typing import List

import numpy as np

from adaflo_tpu_torch.fe.basis import LagrangeBasis1D, basis
from adaflo_tpu_torch.mesh.structured import StructuredMesh


class ScalarSpace:
    def __init__(
        self,
        mesh: StructuredMesh,
        degree: int,
        support: str = "gauss_lobatto",
    ) -> None:
        self.mesh = mesh
        self.degree = degree
        self.basis: LagrangeBasis1D = basis(degree, support)
        self.dim = mesh.dim
        self.n_1d = degree + 1
        self.n_local = self.n_1d**self.dim
        # nodes per axis (periodic axes wrap)
        self.n_nodes_axis = tuple(
            mesh.n_cells_axis[a] * degree + (0 if mesh.periodic[a] else 1)
            for a in range(self.dim)
        )
        self.n_dofs = int(np.prod(self.n_nodes_axis))
        # device vectors may be padded to a multiple (multi-chip sharding
        # needs sizes divisible by the device count; padding entries stay 0)
        self.n_dofs_padded = self.n_dofs

    def set_padding(self, multiple: int) -> None:
        self.n_dofs_padded = -(-self.n_dofs // multiple) * multiple

    # ------------------------------------------------------------------
    @cached_property
    def cell_dofs(self) -> np.ndarray:
        """(n_cells, n_local) int32 gather map, cells and local dofs both in
        lexicographic (x fastest) order."""
        mesh, deg = self.mesh, self.degree
        per_axis: List[np.ndarray] = []
        for a in range(self.dim):
            cells = np.arange(mesh.n_cells_axis[a])[:, None]
            local = np.arange(deg + 1)[None, :]
            g = cells * deg + local
            if mesh.periodic[a]:
                g = g % self.n_nodes_axis[a]
            per_axis.append(g)  # (n_cells_a, n_1d)

        # combine axes: global = gx + nx*(gy + ny*gz)
        if self.dim == 1:
            out = per_axis[0]
        elif self.dim == 2:
            nx = self.n_nodes_axis[0]
            gx = per_axis[0][None, :, None, :]  # (1, cx, 1, ix)
            gy = per_axis[1][:, None, :, None]  # (cy, 1, iy, 1)
            out = (gx + nx * gy).reshape(mesh.n_cells, self.n_local)
        else:
            nx, ny = self.n_nodes_axis[0], self.n_nodes_axis[1]
            gx = per_axis[0][None, None, :, None, None, :]
            gy = per_axis[1][None, :, None, None, :, None]
            gz = per_axis[2][:, None, None, :, None, None]
            out = (gx + nx * (gy + ny * gz)).reshape(mesh.n_cells, self.n_local)
        return np.ascontiguousarray(out.astype(np.int32))

    # ------------------------------------------------------------------
    def axis_node_coords(self, a: int) -> np.ndarray:
        """Physical coordinates of the lattice nodes along axis a."""
        mesh, deg = self.mesh, self.degree
        n = self.n_nodes_axis[a]
        m = np.arange(n)
        cell = m // deg
        loc = m % deg
        if getattr(mesh, "is_graded", False):
            nodes = mesh.axis_nodes(a)
            cell = np.minimum(cell, mesh.n_cells_axis[a] - 1)
            widths = np.diff(nodes)
            x = nodes[cell] + widths[cell] * self.basis.nodes[loc]
            # the last lattice node of a non-periodic axis is the far end
            if not mesh.periodic[a] and n == mesh.n_cells_axis[a] * deg + 1:
                x[-1] = nodes[-1]
            return x
        x = mesh.origin[a] + mesh.h[a] * (cell + self.basis.nodes[loc])
        return x

    @cached_property
    def node_coords(self) -> np.ndarray:
        """(n_dofs, dim) coordinates of all dofs (lattice lexicographic)."""
        axes = [self.axis_node_coords(a) for a in range(self.dim)]
        grids = np.meshgrid(*axes[::-1], indexing="ij")  # (z, y, x) order
        out = np.empty((self.n_dofs, self.dim))
        for a in range(self.dim):
            out[:, a] = grids[self.dim - 1 - a].reshape(-1)
        return out

    # ------------------------------------------------------------------
    def _node_face_incidence(self, a: int) -> np.ndarray:
        """(n_nodes_a, n_cells_a) boolean: node touches cell along axis a."""
        deg = self.degree
        n_nodes = self.n_nodes_axis[a]
        n_cells = self.mesh.n_cells_axis[a]
        T = np.zeros((n_nodes, n_cells), dtype=np.int64)
        for c in range(n_cells):
            lo = c * deg
            hi = min(lo + deg, n_nodes - 1)
            T[lo : hi + 1, c] = 1
            if self.mesh.periodic[a]:
                T[(np.arange(lo, lo + deg + 1)) % n_nodes, c] = 1
        return T

    def _lattice_to_flat(self, per_axis_indices: List[np.ndarray]) -> np.ndarray:
        """Flat dof indices from per-axis lattice index arrays (broadcast)."""
        idx = per_axis_indices[0]
        stride = 1
        for a in range(1, self.dim):
            stride *= self.n_nodes_axis[a - 1]
            idx = idx + stride * per_axis_indices[a]
        return idx

    def boundary_dofs(self, boundary_id: int) -> np.ndarray:
        """Sorted unique dof indices lying on boundary faces with the id."""
        found: List[np.ndarray] = []
        for axis in range(self.dim):
            if self.mesh.periodic[axis]:
                continue
            for end in (0, 1):
                ids = self.mesh.boundary_ids(axis, end)
                F = (ids == boundary_id).astype(np.int64)
                if not F.any():
                    continue
                rem_axes = [a for a in range(self.dim) if a != axis]
                # node mask over remaining axes via incidence contraction
                if self.dim == 1:
                    mask = np.array(True)
                elif self.dim == 2:
                    T = self._node_face_incidence(rem_axes[0])
                    mask = (T @ F) > 0
                else:
                    T1 = self._node_face_incidence(rem_axes[0])
                    T2 = self._node_face_incidence(rem_axes[1])
                    # two GEMMs, not a naive 4-index einsum: the default
                    # einsum path is O(nodes^2 * faces^2) and took minutes
                    # already at 4097^2 nodes
                    mask = (T1 @ F @ T2.T) > 0
                fixed = 0 if end == 0 else self.n_nodes_axis[axis] - 1
                if self.dim == 1:
                    found.append(np.array([fixed] if mask else [], dtype=np.int64))
                    continue
                # build per-axis index arrays for masked nodes
                sel = np.argwhere(mask)  # (n_sel, dim-1) in rem_axes order
                per_axis = [None] * self.dim
                per_axis[axis] = np.full(len(sel), fixed, dtype=np.int64)
                for i, a in enumerate(rem_axes):
                    per_axis[a] = sel[:, i]
                found.append(self._lattice_to_flat(per_axis))
        if not found:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(found))

    def side_dofs(self, axis: int, end: int) -> np.ndarray:
        """All dofs on one full side of the box (lattice order)."""
        per_axis: List[np.ndarray] = []
        shapes = []
        for a in range(self.dim):
            if a == axis:
                per_axis.append(
                    np.array([0 if end == 0 else self.n_nodes_axis[a] - 1])
                )
                shapes.append(1)
            else:
                per_axis.append(np.arange(self.n_nodes_axis[a]))
                shapes.append(self.n_nodes_axis[a])
        # broadcast to full lattice of the side, axes ordered (z, y, x)
        grids = np.meshgrid(*per_axis[::-1], indexing="ij")
        flat = [grids[self.dim - 1 - a].reshape(-1) for a in range(self.dim)]
        return self._lattice_to_flat(flat)

    # ------------------------------------------------------------------
    def boundary_face_quadrature(self, boundary_id: int, n_q_1d: int):
        """Surface-integral data for boundary faces with the id: a list of
        (axis, end, face_dofs, qcoords, V_face, jxw_face) with
          face_dofs (n_faces, n_fd), qcoords (n_faces, n_qf, dim),
          V_face (n_qf, n_fd), jxw_face (n_qf,).
        Orderings of face dofs and face quad points are both lexicographic in
        the remaining axes with the lowest axis fastest (matching
        boundary_faces)."""
        from adaflo_tpu_torch.fe.basis import gauss_quadrature

        q1, w1 = gauss_quadrature(n_q_1d)
        Vq, _ = self.basis.tabulate(q1)
        mesh, deg = self.mesh, self.degree
        out = []
        for axis, end, face_dofs in self.boundary_faces(boundary_id):
            rem_axes = [a for a in range(self.dim) if a != axis]
            # tensor-product face basis / weights (lowest axis fastest)
            V_face = np.ones((1, 1))
            jxw = np.ones(1)
            for a in reversed(rem_axes):
                V_face = np.kron(V_face, Vq) if V_face.size > 1 else Vq.copy()
                jxw = np.kron(jxw, w1 * mesh.h[a]) if jxw.size > 1 else w1 * mesh.h[a]
            if len(rem_axes) == 2:
                a_lo, a_hi = rem_axes
                V_face = np.kron(Vq, Vq)  # (q_hi q_lo, i_hi i_lo)
                jxw = np.kron(w1 * mesh.h[a_hi], w1 * mesh.h[a_lo])
            # quad coordinates: derive the per-face cell indices from the
            # first dof of each face (corner node)
            corner = self.node_coords[face_dofs[:, 0]]  # (n_faces, dim)
            n_qf = len(jxw)
            qcoords = np.empty((len(face_dofs), n_qf, self.dim))
            qcoords[..., axis] = corner[:, None, axis]
            if len(rem_axes) == 0:
                pass  # 1D: the face is a point; V_face = [[1]], jxw = [1]
            elif len(rem_axes) == 1:
                a = rem_axes[0]
                qcoords[..., a] = corner[:, None, a] + mesh.h[a] * q1[None, :]
            else:
                a_lo, a_hi = rem_axes
                Qlo = np.tile(q1, n_q_1d)
                Qhi = np.repeat(q1, n_q_1d)
                qcoords[..., a_lo] = corner[:, None, a_lo] + mesh.h[a_lo] * Qlo
                qcoords[..., a_hi] = corner[:, None, a_hi] + mesh.h[a_hi] * Qhi
            out.append((axis, end, face_dofs, qcoords, V_face, jxw))
        return out

    def boundary_faces(self, boundary_id: int):
        """Face gather maps for surface integrals on boundary faces with the
        given id. Returns a list of (axis, end, face_dofs) with face_dofs of
        shape (n_faces, n_1d^(dim-1)) (local face dofs lexicographic in the
        remaining axes, x-most-minor)."""
        out = []
        deg = self.degree
        for axis in range(self.dim):
            if self.mesh.periodic[axis]:
                continue
            for end in (0, 1):
                ids = self.mesh.boundary_ids(axis, end)
                sel_faces = np.argwhere(ids == boundary_id)  # (n, dim-1)
                if len(sel_faces) == 0:
                    continue
                rem_axes = [a for a in range(self.dim) if a != axis]
                fixed = 0 if end == 0 else self.n_nodes_axis[axis] - 1
                n_face_dofs = (deg + 1) ** (self.dim - 1)
                face_dofs = np.empty((len(sel_faces), n_face_dofs), dtype=np.int64)
                local = np.arange(deg + 1)
                for fi, fcoords in enumerate(sel_faces):
                    per_axis = [None] * self.dim
                    per_axis[axis] = np.array([fixed])
                    for i, a in enumerate(rem_axes):
                        per_axis[a] = fcoords[i] * deg + local
                    grids = np.meshgrid(*per_axis[::-1], indexing="ij")
                    flat = [
                        grids[self.dim - 1 - a].reshape(-1) for a in range(self.dim)
                    ]
                    face_dofs[fi] = self._lattice_to_flat(flat)
                out.append((axis, end, face_dofs))
        return out
