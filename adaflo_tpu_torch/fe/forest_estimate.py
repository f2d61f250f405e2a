"""Error estimation + marking on adaptive forests.

PyTorch port's counterpart of ``adaflo_tpu/fe/forest_estimate.py`` (host
numpy). Forest counterpart of deal.II KellyErrorEstimator +
GridRefinement::refine_and_coarsen_fixed_number as the reference uses them
(source/navier_stokes.cc:1324-1369 refine_grid_pressure_based,
applications/drivencavity.cc AMR loop): per-cell indicators from the squared
normal-gradient jumps over faces, then fixed-fraction marking with a level
cap. Same-level face jumps evaluate both sides on the shared Gauss points in
one batched tensor contraction; cross-level (hanging) faces evaluate the
coarse side at the fine side's points.

Only the RANKING of indicators feeds the marking, so the deal.II prefactor
convention (h/24) matters only up to a constant.
"""

from __future__ import annotations

import numpy as np

from adaflo_tpu_torch.fe.basis import gauss_quadrature
from adaflo_tpu_torch.fe.forest_space import ForestSpace


def _face_eval_matrices(space: ForestSpace, n_q_1d: int):
    """For each (axis, side): (n_qf, n_loc) matrices evaluating d/d(axis)
    on the face, in REFERENCE coordinates (scale by 1/h[axis] per cell)."""
    dim = space.dim
    basis = space.basis
    q, w = gauss_quadrature(n_q_1d)
    Vq, Dq = basis.tabulate(q)
    V0, D0 = basis.tabulate(np.array([0.0]))
    V1, D1 = basis.tabulate(np.array([1.0]))
    mats = {}
    for axis in range(dim):
        for side in (0, 1):
            Vn, Dn = (V0, D0) if side == 0 else (V1, D1)
            # build directly: local index n = sum_a i_a * (n1 ** a)
            n1 = basis.n_dofs
            n_loc = n1**dim
            nqf = n_q_1d ** (dim - 1)
            M = np.zeros((nqf, n_loc))
            tang = [a for a in range(dim) if a != axis]
            for p in range(nqf):
                # tangential multi-index, first tangential axis fastest
                rem = p
                ti = {}
                for t in tang:
                    ti[t] = rem % n_q_1d
                    rem //= n_q_1d
                for loc in range(n_loc):
                    val = 1.0
                    for a in range(dim):
                        ia = (loc // n1**a) % n1
                        if a == axis:
                            val *= Dn[0, ia]
                        else:
                            val *= Vq[ti[a], ia]
                    M[p, loc] = val
            mats[(axis, side)] = M
    if dim == 2:
        wf = w
    else:
        wf = np.einsum("a,b->ba", w, w).reshape(-1)  # first tangential fastest
    return mats, wf


def kelly_indicator(
    space: ForestSpace, p_vec: np.ndarray, n_q_1d: int
) -> np.ndarray:
    """(E,) squared Kelly indicators for a (distributed, conforming) scalar
    dof vector: eta_K^2 = sum_faces (h/24) int_F [dp/dn]^2."""
    forest = space.forest
    dim = space.dim
    E = space.n_cells
    p = np.asarray(p_vec)[: space.n_dofs]
    mats, wf = _face_eval_matrices(space, n_q_1d)
    cells_p = p[space.cell_dofs]  # (E, n_loc)
    h = space.h_cells
    # own-side normal gradients per (axis, side): (E, n_qf)
    own = {}
    for key, M in mats.items():
        axis, _ = key
        own[key] = cells_p @ M.T / h[:, axis][:, None]

    eta = np.zeros(E)
    q, _ = gauss_quadrature(n_q_1d)
    for i in range(E):
        for axis in range(dim):
            for side in (0, 1):
                nbr, rel = forest.face_neighbors(i, axis, side)
                if len(nbr) == 0:
                    continue  # domain boundary
                g_own = own[(axis, side)][i]
                if rel == 0:
                    g_nbr = own[(axis, 1 - side)][int(nbr[0])]
                    jump2 = ((g_own - g_nbr) ** 2 * wf).sum()
                elif rel == -1:
                    # coarser neighbor: evaluate its gradient at OUR points
                    c = int(nbr[0])
                    pts = _face_points(space, i, axis, side, q)
                    g_nbr = _grad_at(space, cells_p[c], c, pts, axis)
                    jump2 = ((g_own - g_nbr) ** 2 * wf).sum()
                else:
                    # finer neighbors: each fine face accumulates the jump on
                    # its own pass (rel == -1 seen from the fine side); add
                    # the mirrored contribution here for symmetry
                    jump2 = 0.0
                    for f in nbr:
                        f = int(f)
                        pts = _face_points(space, f, axis, 1 - side, q)
                        g_f = own[(axis, 1 - side)][f]
                        g_c = _grad_at(space, cells_p[i], i, pts, axis)
                        jump2 += 0.5 * ((g_f - g_c) ** 2 * wf).sum()
                # face measure: product of tangential extents of the OWNING
                # side (for rel=+1 the fine extents are inside the sum above)
                tang = [a for a in range(dim) if a != axis]
                area = np.prod(h[i, tang]) if rel != 1 else np.prod(
                    h[int(nbr[0]), tang]
                ) * len(nbr)
                eta[i] += (h[i, axis] / 24.0) * jump2 * area
    return eta


def _face_points(space, cell, axis, side, q):
    """(n_qf, dim) physical Gauss points on the face of `cell`."""
    dim = space.dim
    o = space.cell_origin[cell]
    h = space.h_cells[cell]
    tang = [a for a in range(dim) if a != axis]
    if dim == 2:
        pts = np.zeros((len(q), 2))
        pts[:, axis] = o[axis] + side * h[axis]
        pts[:, tang[0]] = o[tang[0]] + q * h[tang[0]]
        return pts
    nq = len(q)
    pts = np.zeros((nq * nq, 3))
    pts[:, axis] = o[axis] + side * h[axis]
    # first tangential axis fastest (matches _face_eval_matrices ordering)
    t0, t1 = tang
    pts[:, t0] = o[t0] + np.tile(q, nq) * h[t0]
    pts[:, t1] = o[t1] + np.repeat(q, nq) * h[t1]
    return pts


def _grad_at(space, cell_dofs_vals, cell, pts, axis):
    """d/d(axis) of the FE function with local dofs `cell_dofs_vals` of
    `cell`, at physical points."""
    o = space.cell_origin[cell]
    h = space.h_cells[cell]
    xi = (pts - o) / h
    basis = space.basis
    n1 = basis.n_dofs
    dim = space.dim
    W = []
    for a in range(dim):
        V, D = basis.tabulate(np.clip(xi[:, a], 0.0, 1.0))
        W.append(D / h[a] if a == axis else V)
    n_loc = n1**dim
    out = np.zeros(len(pts))
    for loc in range(n_loc):
        val = np.ones(len(pts))
        for a in range(dim):
            ia = (loc // n1**a) % n1
            val = val * W[a][:, ia]
        out += cell_dofs_vals[loc] * val
    return out


def refine_and_coarsen_fixed_number(
    space: ForestSpace,
    indicators: np.ndarray,
    refine_fraction: float,
    coarsen_fraction: float,
    max_level: int = 100,
) -> np.ndarray:
    """Flags (+1/-1/0) marking the top refine_fraction cells for refinement
    and the bottom coarsen_fraction for coarsening, capped at max_level
    (GridRefinement::refine_and_coarsen_fixed_number semantics)."""
    E = len(indicators)
    flags = np.zeros(E, dtype=np.int8)
    order = np.argsort(-indicators)
    n_ref = int(round(refine_fraction * E))
    n_coa = int(round(coarsen_fraction * E))
    if n_ref:
        flags[order[:n_ref]] = 1
    if n_coa:
        flags[order[E - n_coa :]] = -1
    levels = space.levels
    flags[(flags == 1) & (levels >= max_level)] = 0
    return flags
