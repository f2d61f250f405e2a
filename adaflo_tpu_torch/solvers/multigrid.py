"""Geometric multigrid on the Q1-subelement lattice hierarchy.

PyTorch counterpart of ``adaflo_tpu/solvers/multigrid.py``, the replacement
for the reference's ML-AMG with 'amg linear'
(navier_stokes_preconditioner.cc:42-45, 465-562, 2489-2704): the Q_k dof
lattice is treated as a structured Q1 lattice, which coarsens by factor-2
nesting with tensor-product linear interpolation; each level rediscretizes
the Helmholtz-type model operator alpha M + beta K and smooths with
Chebyshev/Jacobi; the coarsest level solves with CG on its dense matrix.

The class splits into static geometry (hierarchy, index maps, masks) and a
`GMGState` of coefficient-dependent data (per-level alpha/beta/diag/
lambda_max + the coarse matrix) rebuilt by `compute()` whenever the
preconditioner refreshes. Only the uniform lattice is ported: the graded
branch (`axis_widths`) raises NotImplementedError (ROADMAP.md queue 1,
item 15).

Used per velocity component (alpha = rho * time weight, beta ~ viscosity) and
for the pressure Poisson operator (alpha = 0, beta = 1/(w rho)).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from adaflo_tpu_torch.device import resolve_device
from adaflo_tpu_torch.fe.basis import basis as make_basis
from adaflo_tpu_torch.ops.lattice import LatticeOps
from adaflo_tpu_torch.ops.tensor import CellEvaluator
from adaflo_tpu_torch.solvers.krylov import cg
from adaflo_tpu_torch.utils.timer import profiler_range


class LevelState(NamedTuple):
    alpha: object  # float or (E,) tensor
    beta: object  # float or (E,) tensor
    diag: torch.Tensor  # (n,)
    lmax: float


def estimate_lmax(apply_fn, Dinv, n, dtype, device, m: int = 25) -> float:
    """Largest eigenvalue of D^-1 A by m-step Lanczos on the similar
    symmetric operator D^-1/2 A D^-1/2 (fixed iteration count, dense
    eigvalsh of the m x m tridiagonal on the host)."""
    sq = torch.sqrt(torch.abs(Dinv))
    v = torch.cos(torch.arange(n, dtype=dtype, device=device) * 0.7 + 0.3)
    v = v / torch.linalg.norm(v)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dtype, device=device)
    alphas, betas = [], []
    for _ in range(m):
        w = sq * apply_fn(sq * v)
        a = torch.dot(v, w)
        w = w - a * v - beta * v_prev
        beta_new = torch.linalg.norm(w)
        v_prev = v
        v = w / torch.clamp(beta_new, min=1e-30)
        alphas.append(a)
        betas.append(beta_new)
        beta = beta_new
    ab = torch.stack(alphas + betas).cpu().numpy().astype(np.float64)
    T = np.diag(ab[:m]) + np.diag(ab[m : 2 * m - 1], 1) + np.diag(ab[m : 2 * m - 1], -1)
    return float(np.max(np.linalg.eigvalsh(T)))


class GMGState(NamedTuple):
    levels: Tuple[LevelState, ...]
    coarse_matrix: Optional[torch.Tensor]  # dense (n_c, n_c) or None


@dataclass
class _LevelGeom:
    n_nodes_axis: tuple
    n_cells_axis: tuple
    ev: CellEvaluator
    mask: np.ndarray  # constrained dof indices (static)
    lat: LatticeOps
    mask_t: Optional[torch.Tensor] = None
    P1d: List[torch.Tensor] = field(default_factory=list)  # per-axis (n_f, n_c)


def _interp_1d(n_fine_cells: int) -> np.ndarray:
    """(n_fine_nodes, n_coarse_nodes) linear interpolation between nested
    uniform lattices (fine has 2x cells)."""
    nc = n_fine_cells // 2 + 1
    nf = n_fine_cells + 1
    P = np.zeros((nf, nc))
    for i in range(nc):
        P[2 * i, i] = 1.0
    for i in range(nc - 1):
        P[2 * i + 1, i] = 0.5
        P[2 * i + 1, i + 1] = 0.5
    return P


def _coef(x, extra: int):
    """Per-cell coefficient broadcast over `extra` trailing axes."""
    if torch.is_tensor(x) and x.ndim == 1:
        return x.reshape(x.shape + (1,) * extra)
    return x


class LatticeGMG:
    """V-cycle preconditioner for alpha M + beta K on a structured lattice.

    Operates on dof vectors of the original Q_k space (its nodal lattice is
    the finest Q1 level); constrained rows act as identity; padded tails are
    passed through as zero."""

    def __init__(
        self,
        n_nodes_axis: tuple,
        h_fine_axis,
        dirichlet: np.ndarray,
        n_dofs_padded: int,
        smoother_degree: int = 3,
        min_coarse_nodes: int = 700,
        axis_widths=None,
        dtype: torch.dtype = torch.float64,
        device=None,
    ) -> None:
        if axis_widths is not None:
            raise NotImplementedError(
                "graded lattices are not ported (ROADMAP.md queue 1, item 15)"
            )
        dim = len(n_nodes_axis)
        self.dim = dim
        self.n_dofs_padded = n_dofs_padded
        self.smoother_degree = smoother_degree
        self.dtype = dtype
        self.device = resolve_device(device)
        q1 = make_basis(1, "equidistant")
        levels: List[_LevelGeom] = []
        n_cells_axis = tuple(n - 1 for n in n_nodes_axis)
        h = np.asarray(h_fine_axis, dtype=np.float64)
        mask = np.asarray(dirichlet, dtype=np.int64)
        nodes_axis = tuple(n_nodes_axis)
        while True:
            ev = CellEvaluator(dim, q1, 2, h, dtype=dtype, device=self.device)
            lat = LatticeOps(
                nodes_axis, n_cells_axis, 1, (False,) * dim, int(np.prod(nodes_axis))
            )
            lev = _LevelGeom(nodes_axis, n_cells_axis, ev, mask, lat)
            if len(mask):
                lev.mask_t = torch.as_tensor(mask, device=self.device)
            levels.append(lev)
            can_coarsen = all(c % 2 == 0 and c >= 2 for c in n_cells_axis) and (
                int(np.prod(nodes_axis)) > min_coarse_nodes
            )
            if not can_coarsen:
                break
            lev.P1d = [
                torch.as_tensor(_interp_1d(c), dtype=dtype, device=self.device)
                for c in n_cells_axis
            ]
            fine_mask = np.zeros(int(np.prod(nodes_axis)), dtype=bool)
            fine_mask[mask] = True
            fm = fine_mask.reshape(tuple(reversed(nodes_axis)))
            for a in range(dim):
                fm = np.take(fm, np.arange(0, fm.shape[a], 2), axis=a)
            mask = np.flatnonzero(fm.reshape(-1))
            n_cells_axis = tuple(c // 2 for c in n_cells_axis)
            nodes_axis = tuple(c + 1 for c in n_cells_axis)
            h = h * 2.0
        self.levels = levels
        self.coarse_n = int(np.prod(levels[-1].n_nodes_axis))
        self.direct_coarse = self.coarse_n <= 4096

    # -- state construction ------------------------------------------------
    def compute(self, alpha, beta) -> GMGState:
        """Build the coefficient-dependent state. alpha/beta: floats or
        per-fine-Q1-cell tensors (lexicographic cell order)."""
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
            coarse = self.levels[-1]
            st = states[-1]
            eye = torch.eye(self.coarse_n, dtype=self.dtype, device=self.device)
            cols = torch.stack([self._apply(coarse, st, e) for e in eye])
            coarse_matrix = cols.T.contiguous()
        return GMGState(tuple(states), coarse_matrix)

    def _coarsen_cells(self, x, lev: _LevelGeom):
        """Volume-weighted coefficient averaging onto the next level."""
        if not torch.is_tensor(x):
            return x
        xx = x.reshape(tuple(reversed(lev.n_cells_axis)))
        for a in range(self.dim):
            even = xx[(slice(None),) * a + (slice(0, None, 2),)]
            odd = xx[(slice(None),) * a + (slice(1, None, 2),)]
            xx = 0.5 * (even + odd)
        return xx.reshape(-1)

    # -- operator application ------------------------------------------------
    def _apply_raw(self, lev: _LevelGeom, alpha, beta, x):
        xc = lev.lat.gather(x)
        r = lev.ev.integrate_values(_coef(alpha, 1) * lev.ev.values(xc))
        g = lev.ev.gradients(xc) * _coef(beta, 2)
        r = r + lev.ev.integrate_gradients(g)
        return lev.lat.scatter_add(r)

    def _apply(self, lev: _LevelGeom, st: LevelState, x):
        if lev.mask_t is not None:
            x_in = x
            x = x.clone()
            x[lev.mask_t] = 0.0
        out = self._apply_raw(lev, st.alpha, st.beta, x)
        if lev.mask_t is not None:
            out[lev.mask_t] = x_in[lev.mask_t]
        return out

    def _diagonal(self, lev: _LevelGeom, alpha, beta):
        E = int(np.prod(lev.n_cells_axis))
        nl = 2**self.dim
        units = torch.eye(nl, dtype=self.dtype, device=self.device)
        xc = units[:, None, :].expand(nl, E, nl)
        r = lev.ev.integrate_values(_coef(alpha, 1) * lev.ev.values(xc))
        g = lev.ev.gradients(xc) * _coef(beta, 2)
        out = r + lev.ev.integrate_gradients(g)
        idx = torch.arange(nl, device=self.device)
        d = lev.lat.scatter_add(out[idx, :, idx].transpose(0, 1))
        if lev.mask_t is not None:
            d[lev.mask_t] = 1.0
        return d

    # -- cycle pieces --------------------------------------------------------
    def _smooth(self, lev: _LevelGeom, st: LevelState, x, b, degree: int):
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

    def _restrict(self, lev: _LevelGeom, r):
        rr = r.reshape(tuple(reversed(lev.n_nodes_axis)))
        for a, Pa in enumerate(lev.P1d):
            ax = self.dim - 1 - a
            rr = torch.movedim(torch.tensordot(rr, Pa, dims=([ax], [0])), -1, ax)
        return rr.reshape(-1)

    def _prolong(self, lev: _LevelGeom, xc):
        xx = xc.reshape(tuple(reversed([P.shape[1] for P in lev.P1d])))
        for a, Pa in enumerate(lev.P1d):
            ax = self.dim - 1 - a
            xx = torch.movedim(torch.tensordot(xx, Pa, dims=([ax], [1])), -1, ax)
        return xx.reshape(-1)

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
        if lev.mask_t is not None:
            r[lev.mask_t] = 0.0
        rc = self._restrict(lev, r)
        nxt = self.levels[li + 1]
        if nxt.mask_t is not None:
            rc[nxt.mask_t] = 0.0
        xc = self._vcycle(li + 1, state, rc)
        if nxt.mask_t is not None:
            xc = xc.clone()
            xc[nxt.mask_t] = 0.0
        x = x + self._prolong(lev, xc)
        return self._smooth(lev, st, x, b, self.smoother_degree)

    @profiler_range
    def vmult(self, state: GMGState, b):
        n = int(np.prod(self.levels[0].n_nodes_axis))
        b_in = b[:n]
        mask = self.levels[0].mask_t
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
