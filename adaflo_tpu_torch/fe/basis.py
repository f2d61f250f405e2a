"""1D finite-element bases and quadrature for tensor-product (Q_k) elements.

TPU-native counterpart of the reference's sum-factorized FEEvaluation setup:
Lagrange bases on Gauss-Lobatto support points (the reference builds its
velocity space as FE_Q(QGaussLobatto(p+1)), source/
navier_stokes.cc:92-106) tabulated at Gauss quadrature points. The tabulated
(n_q x n_dofs) value/gradient matrices are the only basis data the device
kernels need: all cell integrals become batched tensor contractions with
these small matrices.

All tabulation happens on host in float64 numpy; arrays are handed to JAX as
constants.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def gauss_quadrature(n_points: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points/weights on the unit interval [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n_points)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto_points(n_points: int) -> np.ndarray:
    """Gauss-Lobatto points on [0, 1] (FE_Q support points)."""
    if n_points < 2:
        raise ValueError("Gauss-Lobatto needs at least 2 points")
    if n_points == 2:
        return np.array([0.0, 1.0])
    # interior points are the roots of d/dx P_{n-1}(x) on [-1, 1]
    leg = np.polynomial.legendre.Legendre.basis(n_points - 1)
    interior = leg.deriv().roots()
    pts = np.concatenate([[-1.0], np.sort(np.real(interior)), [1.0]])
    return 0.5 * (pts + 1.0)


def equidistant_points(n_points: int) -> np.ndarray:
    return np.linspace(0.0, 1.0, n_points)


def _lagrange_eval(nodes: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate the Lagrange basis on `nodes` and its derivative at points `x`.

    Returns (values, derivs) with shape (len(x), len(nodes)). Uses direct
    product formulas in float64 (well conditioned for the small degrees used
    here, k <= 8)."""
    n = len(nodes)
    nx = len(x)
    vals = np.ones((nx, n))
    derivs = np.zeros((nx, n))
    for i in range(n):
        others = [j for j in range(n) if j != i]
        denom = np.prod([nodes[i] - nodes[j] for j in others])
        # value
        num = np.ones(nx)
        for j in others:
            num *= x - nodes[j]
        vals[:, i] = num / denom
        # derivative: sum over which factor is differentiated
        dsum = np.zeros(nx)
        for jd in others:
            term = np.ones(nx)
            for j in others:
                if j != jd:
                    term *= x - nodes[j]
            dsum += term
        derivs[:, i] = dsum / denom
    return vals, derivs


def iterated_gauss_quadrature(
    n_sub: int, n_per: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """QIterated(Gauss(n_per), n_sub) on [0, 1]: the n_per-point Gauss rule
    on each of n_sub equal sub-intervals (the reference's level-set
    quadrature, two_phase_base.cc:296-298)."""
    q, w = gauss_quadrature(n_per)
    pts = np.concatenate([(i + q) / n_sub for i in range(n_sub)])
    wts = np.tile(w / n_sub, n_sub)
    return pts, wts


def _iso_q1_eval(n_sub: int, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Hat-function basis on n_sub equal sub-intervals of [0, 1]."""
    n = n_sub + 1
    nodes = np.linspace(0.0, 1.0, n)
    h = 1.0 / n_sub
    vals = np.zeros((len(x), n))
    derivs = np.zeros((len(x), n))
    for i in range(n):
        xi = nodes[i]
        left = (x >= xi - h) & (x < xi)
        right = (x >= xi) & (x <= xi + h)
        # right edge of the last interval
        vals[:, i] = np.where(left, (x - (xi - h)) / h, 0.0) + np.where(
            right, (xi + h - x) / h, 0.0
        )
        derivs[:, i] = np.where(left, 1.0 / h, 0.0) + np.where(right, -1.0 / h, 0.0)
        if i == 0:
            vals[:, i] = np.where(right, (xi + h - x) / h, 0.0)
            derivs[:, i] = np.where(right, -1.0 / h, 0.0)
        if i == n - 1:
            vals[:, i] = np.where(left | (x == 1.0), (x - (xi - h)) / h, 0.0)
            derivs[:, i] = np.where(left | (x == 1.0), 1.0 / h, 0.0)
    return vals, derivs


class LagrangeBasis1D:
    """Lagrange basis of degree `degree` on given support points in [0, 1].

    support='iso_q1' gives the FE_Q_iso_Q1 basis: piecewise-linear hat
    functions on `degree` equal sub-intervals (the reference's level-set /
    phase-field concentration space, level_set_base.cc:54-60). It shares the
    nodal lattice of an equidistant Lagrange basis, so all dof bookkeeping is
    identical; only the tabulated shape matrices differ."""

    def __init__(self, degree: int, support: str = "gauss_lobatto") -> None:
        self.degree = degree
        self.n_dofs = degree + 1
        if support == "gauss_lobatto":
            self.nodes = gauss_lobatto_points(degree + 1)
        elif support in ("equidistant", "iso_q1"):
            self.nodes = equidistant_points(degree + 1)
        else:
            raise ValueError(support)
        self.support = support

    def tabulate(self, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(values, derivatives) matrices of shape (len(points), n_dofs)."""
        points = np.asarray(points, dtype=np.float64)
        if self.support == "iso_q1":
            return _iso_q1_eval(self.degree, points)
        return _lagrange_eval(self.nodes, points)

    @lru_cache(maxsize=None)
    def at_gauss(self, n_q: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Tabulated (values, derivatives, weights) at an n_q Gauss rule."""
        q, w = gauss_quadrature(n_q)
        v, d = self.tabulate(q)
        return v, d, w


@lru_cache(maxsize=None)
def basis(degree: int, support: str = "gauss_lobatto") -> LagrangeBasis1D:
    return LagrangeBasis1D(degree, support)
