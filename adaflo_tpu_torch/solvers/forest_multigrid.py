"""Geometric multigrid on the adaptive-forest hierarchy (global coarsening).

PyTorch counterpart of ``adaflo_tpu/solvers/forest_multigrid.py``, the
adaptive counterpart of LatticeGMG in the role of the reference's ML-AMG on
adaptively refined meshes (navier_stokes_preconditioner.cc 'amg'/'amg
linear' on p4est grids). Levels follow deal.II's MGTransferGlobalCoarsening:
the next-coarser mesh merges every complete sibling group
(ForestMesh.coarsened()), each level carries the full Q_k space with its own
hanging-node constraints, and the transfers are nodal interpolation between
consecutive levels ((master, weight) tables: a gather and a weighted sum to
prolong, its transpose as a segment sum to restrict). Chebyshev/Jacobi
smoothing per level, CG on the coarsest level's dense matrix.

The hierarchy (spaces, constraints, transfer tables) is built on the host
once per mesh; `compute(alpha, beta)` returns a GMGState (per-level
coefficients, diagonal and lambda_max, the coarse matrix) whenever the
preconditioner refreshes. The coarse matrix is the level operator applied to
the identity's columns in batches of 64 (one batched apply per batch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from adaflo_tpu_torch.device import resolve_device
from adaflo_tpu_torch.fe.constraints import Constraints
from adaflo_tpu_torch.fe.forest_space import ForestSpace
from adaflo_tpu_torch.fe.forest_transfer import ForestFunction
from adaflo_tpu_torch.ops.lattice import IndexMapOps, segment_sum, segment_table
from adaflo_tpu_torch.ops.tensor import VariableCellEvaluator
from adaflo_tpu_torch.solvers.krylov import cg
from adaflo_tpu_torch.solvers.multigrid import GMGState, LevelState, estimate_lmax
from adaflo_tpu_torch.utils.timer import profiler_range

COARSE_BATCH = 64


@dataclass(eq=False)
class _FLevel:
    space: ForestSpace
    con: Constraints
    ev: VariableCellEvaluator
    lat: IndexMapOps
    cd: Optional[torch.Tensor]  # constrained dofs (identity rows), or None
    # transfer to the NEXT (coarser) level: for each node of this level the
    # coarse cell's local dofs and interpolation weights (n_this, n_loc_c),
    # and the transpose table of the masters (restriction)
    t_masters: Optional[torch.Tensor] = None
    t_weights: Optional[torch.Tensor] = None
    t_table: Optional[torch.Tensor] = None
    # fine cell -> coarse cell segments (coefficient averaging)
    parent_table: Optional[torch.Tensor] = None


def _transfer_maps(coarse_space: ForestSpace, fine_space: ForestSpace):
    """Nodal-interpolation masters/weights of fine nodes in coarse cells."""
    fn = ForestFunction(coarse_space)
    pts = fine_space.node_coords
    cells = fn.locate(pts)
    xi = np.clip((pts - fn.cell_origin[cells]) / fn.h_cells[cells], 0.0, 1.0)
    dim = fine_space.dim
    W = [fn.basis.tabulate(xi[:, a])[0] for a in range(dim)]
    if dim == 1:
        wloc = W[0]
    elif dim == 2:
        wloc = np.einsum("nj,ni->nji", W[1], W[0]).reshape(len(pts), -1)
    else:
        wloc = np.einsum("nk,nj,ni->nkji", W[2], W[1], W[0]).reshape(len(pts), -1)
    return fn.cell_dofs[cells], wloc  # (n_f, n_loc) each


def _coef(x, like):
    """A per-cell (E,) coefficient broadcast from axis 0 of `like`."""
    if torch.is_tensor(x) and x.ndim == 1:
        return x.reshape(x.shape + (1,) * (like.ndim - 1))
    return x


class ForestGMG:
    """V-cycle preconditioner for alpha M + beta K on a forest Q_k space."""

    def __init__(
        self,
        space: ForestSpace,
        dirichlet_sides: List[Tuple[int, int]],
        n_dofs_padded: int,
        pin_position: Optional[np.ndarray] = None,
        smoother_degree: int = 3,
        min_coarse_nodes: int = 700,
        max_coarse_dense: int = 4096,
        dtype: torch.dtype = torch.float64,
        device=None,
    ) -> None:
        self.dim = space.dim
        self.n_dofs_padded = n_dofs_padded
        self.smoother_degree = smoother_degree
        self.dtype = dtype
        self.device = dev = resolve_device(device)

        def level_mask(sp: ForestSpace) -> np.ndarray:
            dofs = [np.empty(0, dtype=np.int64)]
            for a, s in dirichlet_sides:
                dofs.append(sp.side_dofs(a, s))
            if pin_position is not None:
                d = np.linalg.norm(sp.node_coords - pin_position, axis=1)
                dofs.append(np.array([int(np.argmin(d))], dtype=np.int64))
            return np.unique(np.concatenate(dofs))

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        levels: List[_FLevel] = []
        sp = space
        while True:
            con = sp.make_constraints(dirichlet=level_mask(sp))
            ev = VariableCellEvaluator(
                sp.dim, sp.basis, sp.degree + 1, sp.h_cells, dtype=dtype, device=dev
            )
            cd = con.constrained_dofs
            levels.append(_FLevel(
                sp, con, ev, IndexMapOps(sp.cell_dofs, sp.n_dofs, dev),
                idx(cd) if len(cd) else None,
            ))
            coarser = sp.forest.coarsened()
            if coarser.n_cells == sp.forest.n_cells or sp.n_dofs <= min_coarse_nodes:
                break
            csp = ForestSpace(coarser, sp.degree)
            lev = levels[-1]
            masters, weights = _transfer_maps(csp, sp)
            lev.t_masters = idx(masters)
            lev.t_weights = torch.as_tensor(weights, dtype=dtype, device=dev)
            lev.t_table = idx(segment_table(masters.reshape(-1), csp.n_dofs))
            parent = ForestFunction(csp).locate(sp.cell_center)
            lev.parent_table = idx(segment_table(parent, csp.n_cells))
            sp = csp
        self.levels = levels
        self.coarse_n = levels[-1].space.n_dofs
        self.direct_coarse = self.coarse_n <= max_coarse_dense

    # -- level operator ----------------------------------------------------
    def _apply_raw(self, lev: _FLevel, alpha, beta, x):
        """condense(A resolve(x)) for x (n,) or a batch (B, n): the cells
        lead in the cell loop, a batch follows them."""
        xc = torch.movedim(lev.lat.gather(lev.con.resolve(x)), -2, 0)
        v = lev.ev.values(xc)
        r = lev.ev.integrate_values(_coef(alpha, v) * v)
        g = lev.ev.gradients(xc)
        r = r + lev.ev.integrate_gradients(_coef(beta, g) * g)
        return lev.con.condense(lev.lat.scatter_add(torch.movedim(r, 0, -2)))

    def _apply(self, lev: _FLevel, st: LevelState, x):
        out = self._apply_raw(lev, st.alpha, st.beta, x)
        if lev.cd is not None:
            out[..., lev.cd] = x[..., lev.cd]
        return out

    def _diagonal(self, lev: _FLevel, alpha, beta):
        E, nl = lev.space.n_cells, lev.ev.n_local
        eye = torch.eye(nl, dtype=self.dtype, device=self.device)
        xc = eye.expand(E, nl, nl)  # (cell, unit, local)
        v = lev.ev.values(xc)
        r = lev.ev.integrate_values(_coef(alpha, v) * v)
        g = lev.ev.gradients(xc)
        r = r + lev.ev.integrate_gradients(_coef(beta, g) * g)
        d = lev.lat.scatter_add(torch.diagonal(r, dim1=-2, dim2=-1))
        if lev.cd is not None:
            d[lev.cd] = 1.0
        return d

    # -- state construction -------------------------------------------------
    def compute(self, alpha, beta) -> GMGState:
        """The coefficient-dependent state; alpha/beta: floats or per-cell
        (E,) tensors of the finest level."""
        states = []
        al, be = alpha, beta
        for li, lev in enumerate(self.levels):
            diag = self._diagonal(lev, al, be)
            Dinv = torch.where(torch.abs(diag) > 1e-300, 1.0 / diag, 1.0)
            lam = estimate_lmax(
                lambda x, _al=al, _be=be, _lev=lev: self._apply_raw(_lev, _al, _be, x),
                Dinv, diag.numel(), self.dtype, self.device,
            )
            states.append(LevelState(al, be, diag, lam))
            if li + 1 < len(self.levels):
                al = self._coarsen_cells(al, lev)
                be = self._coarsen_cells(be, lev)
        coarse_matrix = None
        if self.direct_coarse:
            coarse, st = self.levels[-1], states[-1]
            eye = torch.eye(self.coarse_n, dtype=self.dtype, device=self.device)
            cols = torch.cat([
                self._apply(coarse, st, eye[b : b + COARSE_BATCH])
                for b in range(0, self.coarse_n, COARSE_BATCH)
            ])
            coarse_matrix = cols.T.contiguous()
        return GMGState(tuple(states), coarse_matrix)

    def _coarsen_cells(self, x, lev: _FLevel):
        """The mean of a per-cell coefficient over each coarse cell's
        children."""
        if not torch.is_tensor(x) or x.ndim == 0:
            return x
        s = segment_sum(x, lev.parent_table)
        cnt = segment_sum(torch.ones_like(x), lev.parent_table)
        return s / torch.clamp(cnt, min=1.0)

    # -- transfers -----------------------------------------------------------
    def _restrict(self, lev: _FLevel, r):
        return segment_sum((lev.t_weights * r[:, None]).reshape(-1), lev.t_table)

    def _prolong(self, lev: _FLevel, xc):
        return (lev.t_weights * xc[lev.t_masters]).sum(-1)

    # -- cycle ----------------------------------------------------------------
    def _smooth(self, lev: _FLevel, st: LevelState, x, b, degree: int):
        lmax = 1.1 * st.lmax
        lmin = st.lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma1 = theta / delta
        Dinv = torch.where(torch.abs(st.diag) > 1e-300, 1.0 / st.diag, 1.0)
        r = b - self._apply(lev, st, x)
        z = Dinv * r
        d = z / theta
        x = x + d
        rho_old = 1.0 / sigma1
        for _ in range(1, degree):
            r = b - self._apply(lev, st, x)
            z = Dinv * r
            rho = 1.0 / (2.0 * sigma1 - rho_old)
            d = rho * rho_old * d + (2.0 * rho / delta) * z
            x = x + d
            rho_old = rho
        return x

    def _vcycle(self, li: int, state: GMGState, b):
        lev = self.levels[li]
        st = state.levels[li]
        if li == len(self.levels) - 1:
            if state.coarse_matrix is not None:
                A = state.coarse_matrix
                dg = torch.diagonal(A)
                dinv = torch.where(torch.abs(dg) > 1e-300, 1.0 / dg, 1.0)
                return cg(
                    lambda x: A @ x, b, torch.zeros_like(b), 1e-50, 200,
                    M=lambda r: dinv * r, reduction=1e-10,
                ).x
            return self._smooth(lev, st, torch.zeros_like(b), b, 8)
        x = self._smooth(lev, st, torch.zeros_like(b), b, self.smoother_degree)
        r = b - self._apply(lev, st, x)
        if lev.cd is not None:
            r[lev.cd] = 0.0
        # restrict through the conforming embedding: fold the hanging rows
        # back after interpolating, expand them before prolongation
        nxt = self.levels[li + 1]
        rc = nxt.con.condense(self._restrict(lev, r))
        if nxt.cd is not None:
            rc[nxt.cd] = 0.0
        xc = self._vcycle(li + 1, state, rc)
        if nxt.cd is not None:
            xc = xc.clone()
            xc[nxt.cd] = 0.0
        x = x + self._prolong(lev, nxt.con.resolve(xc))
        return self._smooth(lev, st, x, b, self.smoother_degree)

    @profiler_range
    def vmult(self, state: GMGState, b):
        n = self.levels[0].space.n_dofs
        b_in = b[:n]
        mask = self.levels[0].cd
        b_act = b_in
        if mask is not None:
            b_act = b_in.clone()
            b_act[mask] = 0.0
        x = self._vcycle(0, state, b_act)
        if mask is not None:
            x = x.clone()
            x[mask] = b_in[mask]
        if b.shape[0] > n:
            x = torch.cat([x, x.new_zeros(b.shape[0] - n)])
        return x
