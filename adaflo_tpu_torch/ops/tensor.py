"""Sum-factorized cell evaluation/integration as batched 1D contractions.

PyTorch counterpart of ``adaflo_tpu/ops/tensor.py`` (deal.II's FEEvaluation
evaluate()/integrate(), the engine under every hot kernel of the reference,
source/navier_stokes_matrix.cc:601-916): a local dof vector on a Q_k
tensor-product cell is contracted axis by axis with small tabulated 1D
(n_q x n_1d) matrices. Cells (and components) are leading batch axes.

Geometry is Cartesian (diagonal Jacobian): physical gradients are reference
gradients scaled by 1/h per axis; the quadrature factor is w_q * prod(h).
Local dofs and quadrature points are lexicographic with x fastest, so a
local vector reshapes to (..., z, y, x).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from adaflo_tpu_torch.device import resolve_device
from adaflo_tpu_torch.fe.basis import LagrangeBasis1D, gauss_quadrature


class CellEvaluator:
    """Tabulated evaluation of one scalar basis at one quadrature rule.

    Arrays: V (n_q_1d, n_1d) values and D (n_q_1d, n_1d) derivatives on
    [0, 1], at the Gauss rule of `quad_points_1d` points or at the explicit
    (points, weights) pair it gives; contractions map (..., n_1d**dim) to
    (..., n_q_1d**dim), and gradients carry an extra axis of length dim right
    before the q axis.
    The tables live on `device`: the card unless the caller asks for the
    CPU (device=None resolves as adaflo_tpu_torch.device.resolve_device)."""

    def __init__(
        self,
        dim: int,
        basis: LagrangeBasis1D,
        quad_points_1d,
        h: Sequence[float],
        dtype: torch.dtype = torch.float64,
        device=None,
    ) -> None:
        self.dim = dim
        self.n_1d = basis.n_dofs
        if isinstance(quad_points_1d, tuple):
            q, w = quad_points_1d  # explicit (points, weights) on [0, 1]
        else:
            q, w = gauss_quadrature(int(quad_points_1d))
        V, D = basis.tabulate(q)
        self.n_q_1d = len(q)
        self.n_q = self.n_q_1d**dim
        self.n_local = self.n_1d**dim
        self.q_points_1d = q
        self.w1 = np.asarray(w)
        self.V_np = np.asarray(V, np.float64)
        self.D_np = np.asarray(D, np.float64)
        self.dtype = dtype
        self.device = device = resolve_device(device)
        self.V = torch.as_tensor(self.V_np, dtype=dtype, device=device)
        self.D = torch.as_tensor(self.D_np, dtype=dtype, device=device)
        h = np.asarray(h, dtype=np.float64)
        self.h = h
        self.inv_h = [float(x) for x in 1.0 / h]
        if dim == 1:
            jw = w * h[0]
        elif dim == 2:
            jw = np.einsum("a,b->ab", w * h[1], w * h[0]).reshape(-1)
        else:
            jw = np.einsum("a,b,c->abc", w * h[2], w * h[1], w * h[0]).reshape(-1)
        self.jxw_np = np.asarray(jw, np.float64)
        self.jxw = torch.as_tensor(self.jxw_np, dtype=dtype, device=device)

    def _to_lattice(self, u):
        return u.reshape(u.shape[:-1] + (self.n_1d,) * self.dim)

    # -- geometry factors (per cell in VariableCellEvaluator) ---------------
    def _scale(self, arr, axis: int):
        """arr times 1/h along `axis`."""
        return arr * self.inv_h[axis]

    def _times_jxw(self, f):
        """(..., n_q) times the quadrature weights jxw."""
        return f * self.jxw

    def _to_qlattice(self, f):
        return f.reshape(f.shape[:-1] + (self.n_q_1d,) * self.dim)

    # -- one 1D contraction ------------------------------------------------
    @staticmethod
    def _c(x, M, k: int):
        """Apply the 1D matrix M (rows out, cols in) along the k-th axis from
        the end of x (k = 1 is x, the fastest axis)."""
        if k == 1:
            return x @ M.T
        lead, n, rest = x.shape[:-k], x.shape[-k], x.shape[-k + 1 :]
        m = 1
        for r in rest:
            m *= r
        y = M @ x.reshape(lead + (n, m))
        return y.reshape(lead + (M.shape[0],) + rest)

    # -- evaluation --------------------------------------------------------
    def values(self, u):
        """(..., n_local) -> (..., n_q)"""
        out = self._to_lattice(u)
        for k in range(1, self.dim + 1):
            out = self._c(out, self.V, k)
        return out.reshape(u.shape[:-1] + (self.n_q,))

    def gradients(self, u):
        """(..., n_local) -> (..., dim, n_q); axis -2 indexes d/dx_0..d/dx_{dim-1}."""
        ul = self._to_lattice(u)
        V, D, c, s = self.V, self.D, self._c, self._scale
        if self.dim == 1:
            outs = [s(c(ul, D, 1), 0)]
        elif self.dim == 2:
            a0, a1 = c(ul, V, 1), c(ul, D, 1)
            outs = [s(c(a1, V, 2), 0), s(c(a0, D, 2), 1)]
        else:
            a0, a1 = c(ul, V, 1), c(ul, D, 1)
            b00, b01, b10 = c(a0, V, 2), c(a0, D, 2), c(a1, V, 2)
            outs = [s(c(b10, V, 3), 0), s(c(b01, V, 3), 1), s(c(b00, D, 3), 2)]
        out = torch.stack(outs, dim=-1 - self.dim)
        return out.reshape(u.shape[:-1] + (self.dim, self.n_q))

    # -- integration (transpose ops, both include jxw) ----------------------
    def integrate_values(self, f):
        """sum_q f_q phi_i(q) jxw_q : (..., n_q) -> (..., n_local)"""
        out = self._to_qlattice(self._times_jxw(f))
        Vt = self.V.T
        for k in range(1, self.dim + 1):
            out = self._c(out, Vt, k)
        return out.reshape(f.shape[:-1] + (self.n_local,))

    def integrate_gradients(self, g):
        """sum_q g_q . grad(phi_i)(q) jxw_q : (..., dim, n_q) -> (..., n_local)"""
        Vt, Dt, c, s = self.V.T, self.D.T, self._c, self._scale
        gl = self._to_qlattice(self._times_jxw(g))
        if self.dim == 1:
            out = c(s(gl[..., 0, :], 0), Dt, 1)
        elif self.dim == 2:
            gx = s(gl[..., 0, :, :], 0)
            gy = s(gl[..., 1, :, :], 1)
            out = c(c(gx, Dt, 1), Vt, 2) + c(c(gy, Vt, 1), Dt, 2)
        else:
            gx = s(gl[..., 0, :, :, :], 0)
            gy = s(gl[..., 1, :, :, :], 1)
            gz = s(gl[..., 2, :, :, :], 2)
            e = c(c(gx, Dt, 1), Vt, 2) + c(c(gy, Vt, 1), Dt, 2)
            f = c(c(gz, Vt, 1), Vt, 2)
            out = c(e, Vt, 3) + c(f, Dt, 3)
        return out.reshape(g.shape[:-2] + (self.n_local,))

    # -- quadrature point coordinates (host, for forcing terms) -------------
    def quad_coords(self, mesh) -> np.ndarray:
        """(n_cells, n_q, dim) physical quadrature point coordinates."""
        q = self.q_points_1d
        axes = []
        for a in range(self.dim):
            cells = np.arange(mesh.n_cells_axis[a])[:, None]
            axes.append(mesh.origin[a] + mesh.h[a] * (cells + q[None, :]))
        if self.dim == 1:
            return axes[0][:, :, None]
        if self.dim == 2:
            xc, yc = axes
            ncx, ncy = mesh.n_cells_axis
            shape = (ncy, ncx, self.n_q_1d, self.n_q_1d)
            X = np.broadcast_to(xc[None, :, None, :], shape)
            Y = np.broadcast_to(yc[:, None, :, None], shape)
            return np.stack(
                [X.reshape(-1, self.n_q), Y.reshape(-1, self.n_q)], axis=-1
            )
        xc, yc, zc = axes
        ncx, ncy, ncz = mesh.n_cells_axis
        shape = (ncz, ncy, ncx, self.n_q_1d, self.n_q_1d, self.n_q_1d)
        X = np.broadcast_to(xc[None, None, :, None, None, :], shape)
        Y = np.broadcast_to(yc[None, :, None, None, :, None], shape)
        Z = np.broadcast_to(zc[:, None, None, :, None, None], shape)
        return np.stack(
            [X.reshape(-1, self.n_q), Y.reshape(-1, self.n_q), Z.reshape(-1, self.n_q)],
            axis=-1,
        )


class VariableCellEvaluator(CellEvaluator):
    """CellEvaluator with per-cell Cartesian extents (mixed-level AMR), the
    port of the JAX package's VariableCellEvaluator
    (adaflo_tpu/ops/tensor.py:205-323).

    Arrays carry cells as the LEADING axis, shaped (E, ..., n_local) /
    (E, ..., n_q); the per-cell 1/h and JxW factors broadcast from axis 0
    (deal.II's per-cell Jacobians in MatrixFree, which the reference relies
    on in every adaptive run). The geometry stays diagonal: forest cells
    are axis-aligned boxes."""

    def __init__(
        self,
        dim: int,
        basis: LagrangeBasis1D,
        quad_points_1d,
        h_cells,
        dtype: torch.dtype = torch.float64,
        device=None,
    ) -> None:
        h_cells = np.asarray(h_cells, dtype=np.float64)
        assert h_cells.ndim == 2 and h_cells.shape[1] == dim
        super().__init__(dim, basis, quad_points_1d, h_cells[0], dtype=dtype, device=device)
        h = self.h_cells = h_cells
        kw = dict(dtype=self.dtype, device=self.device)
        self.inv_h_cells = torch.as_tensor(1.0 / h, **kw)  # (E, dim)
        w = self.w1
        if self.dim == 1:
            jw = w[None, :] * h[:, :1]
        elif self.dim == 2:
            jw = np.einsum("a,b->ab", w, w).reshape(1, -1) * (
                h[:, 0] * h[:, 1]
            ).reshape(-1, 1)
        else:
            jw = np.einsum("a,b,c->abc", w, w, w).reshape(1, -1) * (
                h[:, 0] * h[:, 1] * h[:, 2]
            ).reshape(-1, 1)
        self.jxw_cells_np = jw
        self.jxw_cells = torch.as_tensor(jw, **kw)  # (E, n_q)

    def _scale(self, arr, axis: int):
        s = self.inv_h_cells[:, axis]
        return arr * s.reshape(s.shape + (1,) * (arr.ndim - 1))

    def _times_jxw(self, f):
        j = self.jxw_cells
        return f * j.reshape(j.shape[:1] + (1,) * (f.ndim - 2) + j.shape[1:])

    def quad_coords(self, space) -> np.ndarray:
        """(E, n_q, dim) physical quadrature points of a space exposing
        cell_origin (E, dim) (a ForestSpace)."""
        q = self.q_points_1d
        if self.dim == 1:
            ref = q[:, None]
        else:
            grids = np.meshgrid(*([q] * self.dim), indexing="ij")[::-1]
            ref = np.stack(grids, axis=-1).reshape(-1, self.dim)
        return space.cell_origin[:, None, :] + ref[None, :, :] * self.h_cells[:, None, :]
