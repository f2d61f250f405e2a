"""Krylov solvers: CG, BiCGStab, GMRES(m), FGMRES(m).

PyTorch counterpart of ``adaflo_tpu/solvers/krylov.py`` (the deal.II solver
classes the reference uses, e.g. source/navier_stokes.cc:588-641). The JAX
package runs each solver as a `lax.while_loop`; here the loops are Python
loops over tensor operations, and every convergence test reads its residual
back to the host (one synchronization per iteration). The arithmetic, the
convergence tests and the restart follow the JAX versions, so iteration
counts match.

Vectors are tensors of any shape (the coupled solver passes one flat
[u | p] vector). GMRES/FGMRES use right preconditioning, so reported
residuals are true residuals; the small Hessenberg least-squares problem
(Givens rotations, back substitution) runs on the host in float64.
Convergence control mirrors deal.II SolverControl: stop when ||r|| < tol
(absolute; callers pass tolerances already scaled by their policy) or when
max_iter is hit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class SolverResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: float  # final (estimated) residual norm
    converged: bool


def _dot(a, b):
    return torch.sum(a * b)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _identity(x):
    return x


# ---------------------------------------------------------------- CG
def cg(A, b, x0, tol, max_iter: int, M: Optional[Callable] = None, reduction=None):
    """Preconditioned conjugate gradients. `tol` is absolute on ||r||;
    `reduction` optionally adds a relative criterion (deal.II
    ReductionControl)."""
    M = M or _identity
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - A(x0)
    z = M(r)
    p = z
    rz = _dot(r, z)
    res = float(_norm(r))
    tol = float(tol)
    tol_eff = max(tol, reduction * res) if reduction is not None else tol
    k = 0
    while res > tol_eff and k < max_iter:
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        res = float(_norm(r))
        k += 1
    return SolverResult(x, k, res, res <= tol_eff)


# ---------------------------------------------------------------- BiCGStab
def bicgstab(A, b, x0, tol, max_iter: int, M: Optional[Callable] = None):
    """Preconditioned BiCGStab (right preconditioning), with the inexpensive
    residual estimate."""
    M = M or _identity
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - A(x0)
    r0 = r
    res = float(_norm(r))
    tol = float(tol)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = omega = alpha = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    breakdown = False
    while res > tol and k < max_iter and not breakdown:
        rho_new = _dot(r0, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        y = M(p)
        v = A(y)
        r0v = _dot(r0, v)
        alpha = rho_new / r0v
        s = r - alpha * v
        z = M(s)
        t = A(z)
        tt = _dot(t, t)
        omega = _dot(t, s) / tt
        x = alpha * y + (omega * z + x)
        r = s - omega * t
        rho = rho_new
        checks = torch.stack([_norm(r), rho_new.abs(), r0v.abs(), tt.abs()]).tolist()
        res = checks[0]
        breakdown = bool(
            np.isnan(res) or checks[1] < 1e-300 or checks[2] < 1e-300
            or checks[3] < 1e-300
        )
        k += 1
    return SolverResult(x, k, res, res <= tol)


# ---------------------------------------------------------------- GMRES
def _gmres_impl(A, b, x0, tol, max_iter: int, restart: int, M, flexible: bool):
    """Right-preconditioned GMRES(m)/FGMRES(m): classical Gram-Schmidt
    against the whole basis (as the JAX version), Givens rotations."""
    M = M or _identity
    shape = b.shape
    m = restart
    n = b.numel()
    tol = float(tol)

    def A_flat(v):
        return A(v.view(shape)).reshape(-1)

    def M_flat(v):
        return M(v.view(shape)).reshape(-1)

    bf = b.reshape(-1)
    if x0 is None:
        x = torch.zeros_like(bf)
        res = float(_norm(bf))
        x_is_zero = True
    else:
        x = x0.reshape(-1).clone()
        res = float(_norm(bf - A_flat(x)))
        x_is_zero = False
    k = 0
    while res > tol and k < max_iter:
        # a zero iterate needs no operator apply: A(0) = 0 exactly
        r = bf.clone() if x_is_zero else bf - A_flat(x)
        x_is_zero = False
        beta = float(_norm(r))
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        Z = torch.zeros((m, n), dtype=b.dtype, device=b.device) if flexible else None
        H = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        V[0] = r * (1.0 / beta if beta > 0 else 1.0)
        j = 0
        res_c = beta
        while j < m and res_c > tol and k + j < max_iter:
            z = M_flat(V[j])
            if flexible:
                Z[j] = z
            w = A_flat(z)
            hcol = V[: j + 1] @ w
            w = w - hcol @ V[: j + 1]
            hnorm_t = _norm(w)
            V[j + 1] = w * (1.0 / torch.clamp(hnorm_t, min=1e-300))
            host = torch.cat([hcol, hnorm_t[None]]).cpu().numpy()
            col = np.zeros(m + 1)
            col[: j + 1] = host[: j + 1]
            col[j + 1] = host[j + 1]
            for i in range(j):
                hi = cs[i] * col[i] + sn[i] * col[i + 1]
                hi1 = -sn[i] * col[i] + cs[i] * col[i + 1]
                col[i], col[i + 1] = hi, hi1
            denom = np.sqrt(col[j] ** 2 + col[j + 1] ** 2)
            c = col[j] / max(denom, 1e-300)
            s = col[j + 1] / max(denom, 1e-300)
            col[j], col[j + 1] = denom, 0.0
            H[:, j] = col
            cs[j], sn[j] = c, s
            gj = g[j]
            g[j] = c * gj
            g[j + 1] = -s * gj
            res_c = abs(g[j + 1])
            j += 1
        # back substitution on the j x j triangular system
        y = np.zeros(m)
        for i in range(j - 1, -1, -1):
            num = g[i] - H[i] @ y
            hii = H[i, i] if abs(H[i, i]) > 1e-300 else 1e-300
            y[i] = num / hii
        yt = torch.as_tensor(y[:j], dtype=b.dtype, device=b.device)
        if flexible:
            dx = yt @ Z[:j]
        else:
            dx = M_flat(yt @ V[:j])
        x = x + dx
        k += j
        res = res_c
    return SolverResult(x.view(shape), k, res, res <= tol)


def gmres(A, b, x0, tol, max_iter: int, restart: int = 50, M=None):
    return _gmres_impl(A, b, x0, tol, max_iter, restart, M, flexible=False)


def fgmres(A, b, x0, tol, max_iter: int, restart: int = 50, M=None):
    """Flexible GMRES: the preconditioner may change between iterations
    (inner solves), as in the reference's strong solver path."""
    return _gmres_impl(A, b, x0, tol, max_iter, restart, M, flexible=True)
