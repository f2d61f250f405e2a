"""Q_k scalar FE space on an adaptive Morton forest (hanging nodes).

PyTorch port's counterpart of ``adaflo_tpu/fe/forest_space.py``: host numpy
work whose tables (cell_dofs, the hanging rows) move to the device where the
operators use them. The adaptive counterpart of fe/space.py: dofs live on
the union of cell node lattices of a 2:1-balanced ForestMesh. Node identity is resolved by exact
integer coordinates (every Q_k node of every cell sits on the lattice of
finest-level cells subdivided k times, so positions quantize exactly and
np.unique does the global numbering — no floating-point tolerance games).

Hanging nodes — fine-cell face nodes that are not nodes of the coarser face
across — are detected per face-with-coarser-neighbor and constrained to the
coarse face's Lagrange interpolation, reproducing deal.II's
make_hanging_node_constraints as used throughout the reference's adaptive
runs (source/navier_stokes.cc:229-259,
two_phase_base_algorithm.cc refine_grid). Constraint chains (3D edges) are
resolved by Constraints.close().

Cell batching note: cells of ALL levels form one batch axis; per-cell
geometry (h varies per level) flows through VariableCellEvaluator. The
gather/scatter uses explicit index maps (ops/lattice.IndexMapOps) — the
general path; the uniform-lattice fast path does not apply on mixed levels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from adaflo_tpu_torch.fe.basis import LagrangeBasis1D
from adaflo_tpu_torch.fe.constraints import Constraints
from adaflo_tpu_torch.mesh.forest import ForestMesh

_QUANT = 1 << 20  # micro-steps per finest-level cell for node quantization


class ForestSpace:
    """Continuous Q_k space on a 2:1-balanced forest.

    API-compatible with fe/space.py ScalarSpace where the solvers need it
    (cell_dofs, n_dofs/n_dofs_padded, node_coords, boundary_dofs(bid),
    n_local, basis, degree); `is_forest` flags the index-map operator path.
    """

    is_forest = True

    def __init__(
        self,
        forest: ForestMesh,
        degree: int,
        point_distribution: str = "gauss_lobatto",
    ) -> None:
        self.forest = forest
        self.dim = forest.dim
        self.degree = degree
        self.basis = LagrangeBasis1D(degree, point_distribution)
        self._build_dofs()
        self._build_hanging()

    # -- dof numbering -------------------------------------------------------
    def _node_keys(self, roots, levels, anchors):
        """Exact integer node keys, (E, n_loc) per axis list.

        Node i (0..k) of a cell spans fraction x_i of the cell. Key per axis:
        base = (root * 2^L + anchor * 2^(L-l)) — cell origin in finest units.
        The node position is base + x_i * 2^(L-l) finest units. We quantize
        x_i on a fixed micro-lattice: x_i is one of the (k+1) basis node
        fractions, identical at every level, so position identity holds iff
        round(position * QUANT) matches with QUANT = 2^20 micro-steps per
        finest cell — exact for endpoints and collision-free for interior
        nodes because distinct node positions differ by at least
        min_gap * 2^(L - max_level_used) >= ~0.09 finest units >> 1/QUANT.
        """
        k = self.degree
        L = int(levels.max())
        self._L = L
        E = len(levels)
        frac = self.basis.nodes  # (k+1,) node fractions on [0,1]
        QUANT = _QUANT
        keys = []
        scale = (1 << (L - levels)).astype(np.int64)  # (E,)
        # micro-offsets per node fraction and level-scale: round exactly once
        # so every (fraction, scale) pair maps to one integer
        offs = np.rint(frac[None, :] * QUANT)[0]  # (k+1,) ints at unit scale
        for a in range(self.dim):
            base = (
                roots[:, a].astype(np.int64) * (1 << L) + anchors[:, a] * scale
            )  # (E,)
            # node offset in micro units: rint(frac * scale * QUANT) — computed
            # from the SAME rounded unit-scale offsets times integer scale so
            # equal positions yield equal integers across levels
            node = base[:, None] * QUANT + (
                offs[None, :] * scale[:, None]
            ).astype(np.int64)  # (E, k+1)
            keys.append(node)
        return keys  # list of (E, k+1) per axis

    def _build_dofs(self) -> None:
        roots, levels, anchors = self.forest.cells()
        self.levels = levels
        E = len(levels)
        self.n_cells = E
        k = self.degree
        n1 = k + 1
        axis_keys = self._node_keys(roots, levels, anchors)
        # tensor local ordering: x fastest (matches CellEvaluator lattices)
        if self.dim == 1:
            full = axis_keys[0][:, :, None]  # (E, n1, 1)
        elif self.dim == 2:
            kx = axis_keys[0][:, None, :]  # broadcast (E, n1y, n1x)
            ky = axis_keys[1][:, :, None]
            full = np.stack(
                [
                    np.broadcast_to(kx, (E, n1, n1)),
                    np.broadcast_to(ky, (E, n1, n1)),
                ],
                axis=-1,
            ).reshape(E, n1 * n1, 2)
        else:
            kx = axis_keys[0][:, None, None, :]
            ky = axis_keys[1][:, None, :, None]
            kz = axis_keys[2][:, :, None, None]
            full = np.stack(
                [
                    np.broadcast_to(kx, (E, n1, n1, n1)),
                    np.broadcast_to(ky, (E, n1, n1, n1)),
                    np.broadcast_to(kz, (E, n1, n1, n1)),
                ],
                axis=-1,
            ).reshape(E, n1**self.dim, self.dim)
        # entity tag column, mirroring deal.II's entity-based dof numbering:
        # VERTEX nodes (all axes at cell corners) are shared by position
        # alone (tag 0); line/face/cell-interior nodes belong to an entity of
        # a specific refinement level, so a coarse face-interior dof and a
        # coincident fine vertex stay DISTINCT dofs tied by a weight-1.0
        # hanging constraint — exactly deal.II's count and structure
        n_loc = n1**self.dim
        loc_idx = np.arange(n_loc)
        is_vertex = np.ones(n_loc, dtype=bool)
        for a in range(self.dim):
            ia = (loc_idx // n1**a) % n1
            is_vertex &= (ia == 0) | (ia == k)
        tag = np.where(
            is_vertex[None, :], 0, (levels[:, None].astype(np.int64) + 1)
        )  # (E, n_loc)
        full = np.concatenate([full, tag[:, :, None]], axis=-1)
        # unique integer rows -> global dof numbering (no bit packing: deep
        # 3D forests would overflow a composite int64 key)
        flat = full.reshape(-1, self.dim + 1)
        ukeys, first, inverse = np.unique(
            flat, axis=0, return_index=True, return_inverse=True
        )
        self.cell_dofs = inverse.reshape(E, n1**self.dim).astype(np.int64)
        self.n_dofs = len(ukeys)
        self._n_dofs_padded: Optional[int] = None
        QUANT = _QUANT
        # geometry
        centers, h = self.forest.cell_geometry()
        self.cell_center = centers
        self.h_cells = h
        self.cell_origin = centers - 0.5 * h
        # physical coordinates: EXACT from a representative (cell, local)
        # occurrence — the quantized keys only settle identity; for
        # gauss_lobatto bases the interior fractions are irrational and the
        # decoded key would be off by ~2^-21 cells, which breaks polynomial
        # reproduction at hanging nodes
        n_loc = n1**self.dim
        rep_cell = first // n_loc
        rep_loc = first % n_loc
        frac = self.basis.nodes
        loc_frac = np.empty((n_loc, self.dim))
        for a in range(self.dim):
            # local lattice (z, y, x): axis a varies with stride n1**a
            loc_frac[:, a] = frac[(np.arange(n_loc) // n1**a) % n1]
        self.node_coords = (
            self.cell_origin[rep_cell]
            + loc_frac[rep_loc] * self.h_cells[rep_cell]
        )
        # domain boundary key extents per axis (for boundary_dofs)
        self._axis_max_key = [
            int(self.forest.n_roots[d]) * (1 << self._L) * QUANT
            for d in range(self.dim)
        ]
        self._decoded_keys = ukeys

    @property
    def n_dofs_padded(self) -> int:
        return self._n_dofs_padded or self.n_dofs

    def set_padding(self, multiple: int) -> None:
        self._n_dofs_padded = -(-self.n_dofs // multiple) * multiple

    @property
    def mesh(self):
        return self.forest

    @property
    def n_local(self) -> int:
        return (self.degree + 1) ** self.dim

    # -- boundary queries ----------------------------------------------------
    def side_dofs(self, axis: int, side: int) -> np.ndarray:
        """Dofs on the domain boundary plane (axis, side 0/1)."""
        target = 0 if side == 0 else self._axis_max_key[axis]
        return np.flatnonzero(self._decoded_keys[:, axis] == target)

    def boundary_dofs(self, bid: int) -> np.ndarray:
        """Dofs on all boundary sides carrying boundary id `bid`
        (ScalarSpace-compatible signature)."""
        sides = self.forest.sides_with_boundary_id(bid)
        if not sides:
            return np.empty(0, dtype=np.int64)
        return np.unique(
            np.concatenate([self.side_dofs(a, s) for a, s in sides])
        )

    def all_boundary_dofs(self) -> np.ndarray:
        out = [
            self.side_dofs(a, s) for a in range(self.dim) for s in (0, 1)
        ]
        return np.unique(np.concatenate(out))

    # -- hanging-node constraints ---------------------------------------------
    def _face_local_indices(self, axis: int, side: int) -> np.ndarray:
        """Local lattice indices of the nodes on face (axis, side)."""
        n1 = self.degree + 1
        idx = np.arange(n1**self.dim).reshape((n1,) * self.dim)
        # lattice axes ordering is (z, y, x): axis a indexes lattice dim
        # (dim-1-a)
        sl = [slice(None)] * self.dim
        sl[self.dim - 1 - axis] = -1 if side == 1 else 0
        return idx[tuple(sl)].reshape(-1)

    def _build_hanging(self) -> None:
        """Find fine-face nodes hanging on coarser neighbors; produce
        (slave, master, weight) COO arrays."""
        k = self.degree
        forest = self.forest
        roots, levels, anchors = forest.cells()
        slaves, masters, weights = [], [], []
        for j in range(self.n_cells):
            for axis in range(self.dim):
                for side in (0, 1):
                    nbr, rel = forest.face_neighbors(j, axis, side)
                    if rel != -1 or len(nbr) == 0:
                        continue
                    c = int(nbr[0])
                    self._constrain_face(
                        j, c, axis, side, roots, levels, anchors,
                        slaves, masters, weights,
                    )
        if slaves:
            self.hanging_slave = np.concatenate(slaves)
            self.hanging_master = np.concatenate(masters)
            self.hanging_weight = np.concatenate(weights)
        else:
            self.hanging_slave = np.empty(0, dtype=np.int64)
            self.hanging_master = np.empty(0, dtype=np.int64)
            self.hanging_weight = np.empty(0)

    def _constrain_face(
        self, j, c, axis, side, roots, levels, anchors, slaves, masters, weights
    ) -> None:
        k = self.degree
        dim = self.dim
        # fine-cell face nodes
        fine_idx = self._face_local_indices(axis, side)
        fine_dofs = self.cell_dofs[j, fine_idx]
        # coarse-cell face nodes (opposite side)
        coarse_idx = self._face_local_indices(axis, 1 - side)
        coarse_dofs = self.cell_dofs[c, coarse_idx]
        coarse_set = set(self.cell_dofs[c].tolist())
        # local coordinates of the fine nodes inside the coarse cell, per
        # tangential axis: xi = (x_node - origin_c) / h_c, computed exactly
        # in rationals: fine cell origin o_f, extent s_f; coarse o_c, s_c
        # (finest units); node fraction f along tangent t:
        # xi_t = (o_f[t] - o_c[t] + f * s_f) / s_c
        L = self._L
        s_f = 1 << (L - int(levels[j]))
        s_c = 1 << (L - int(levels[c]))
        o_f = roots[j, :dim].astype(np.int64) * (1 << L) + anchors[j, :dim] * s_f
        o_c = roots[c, :dim].astype(np.int64) * (1 << L) + anchors[c, :dim] * s_c
        tang = [a for a in range(dim) if a != axis]
        frac = self.basis.nodes
        # 1D basis values of the coarse basis at each fine node coordinate,
        # per tangential axis: (n_fine_1d, n_coarse_1d)
        W1 = []
        for t in tang:
            xi = (float(o_f[t] - o_c[t]) + frac * s_f) / s_c
            V, _ = self.basis.tabulate(xi)
            W1.append(V)  # (k+1 fine nodes, k+1 coarse nodes)
        n1 = k + 1
        # iterate fine face nodes on the (dim-1) tangential lattice,
        # x-fastest ordering consistent with _face_local_indices
        if dim == 1:
            lattice = [()]
        elif dim == 2:
            lattice = [(i,) for i in range(n1)]
        else:
            lattice = [(i, jdx) for i in range(n1) for jdx in range(n1)]
        # _face_local_indices reshapes the (z,y,x) lattice: remaining axes
        # keep their (slow->fast) order; tangential axes sorted ascending map
        # to lattice slots in DESCENDING lattice position, i.e. the flattened
        # face index runs x-fastest. Build the mapping accordingly.
        for fidx_flat, multi in enumerate(lattice):
            # multi indexes the flattened face lattice slow->fast; map to
            # per-tangent node index: tang sorted ascending = fast->slow in
            # the lattice, so reverse
            node_i = {}
            for slot, t in enumerate(reversed(tang)):
                node_i[t] = multi[slot] if dim == 3 else multi[0]
            sdof = int(fine_dofs[fidx_flat])
            if sdof in coarse_set:
                continue  # coincides with a coarse node: already merged
            # weights: product over tangential axes of coarse 1D basis at xi
            if dim == 2:
                t = tang[0]
                wrow = W1[0][node_i[t]]  # (n1,)
                sel = np.abs(wrow) > 1e-12
                mdofs = coarse_dofs[np.arange(n1)[sel]]
                wts = wrow[sel]
            else:
                t0, t1 = tang  # ascending; face lattice x-fastest = t0 fastest
                w0 = W1[0][node_i[t0]]
                w1 = W1[1][node_i[t1]]
                wt = np.einsum("a,b->ab", w1, w0).reshape(-1)  # slow t1, fast t0
                sel = np.abs(wt) > 1e-12
                mdofs = coarse_dofs[np.arange(n1 * n1)[sel]]
                wts = wt[sel]
            slaves.append(np.full(len(mdofs), sdof, dtype=np.int64))
            masters.append(mdofs.astype(np.int64))
            weights.append(wts)

    def make_constraints(
        self, dirichlet: Optional[np.ndarray] = None
    ) -> Constraints:
        con = Constraints(self.n_dofs)
        if dirichlet is not None and len(dirichlet):
            con.add_dirichlet(dirichlet)
        if len(self.hanging_slave):
            con.add_affine(
                self.hanging_slave, self.hanging_master, self.hanging_weight
            )
        con.close()
        return con
