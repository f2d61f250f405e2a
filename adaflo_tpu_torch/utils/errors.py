"""Error norms and interpolation utilities.

PyTorch counterpart of ``adaflo_tpu/utils/errors.py`` (VectorTools::
integrate_difference / interpolate as used by the reference drivers, e.g.
tests/poiseuille.cc:154-195): cellwise L2 errors against an analytic
solution with a high-order quadrature, combined as the l2 norm of the cell
values. The field is evaluated on its own device; the sums run on the host
in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from adaflo_tpu_torch.fe.space import ScalarSpace
from adaflo_tpu_torch.ops.tensor import CellEvaluator


def _evaluator(space: ScalarSpace, n_q_1d: int, vec: torch.Tensor):
    """(evaluator on vec's device, quad coords (E, n_q, dim), jxw (E, n_q))."""
    mesh = space.mesh
    ev = CellEvaluator(
        space.dim, space.basis, n_q_1d, mesh.h, dtype=vec.dtype, device=vec.device
    )
    jxw = np.broadcast_to(ev.jxw_np, (mesh.n_cells, ev.n_q))
    return ev, ev.quad_coords(mesh), jxw


def _cells(space: ScalarSpace, vec: torch.Tensor):
    """(E, n_loc) or (E, C, n_loc) cell-local values of a nodal vector."""
    cd = torch.as_tensor(space.cell_dofs.astype(np.int64), device=vec.device)
    if vec.dim() == 1:
        return vec[cd]
    return vec[:, cd].permute(1, 0, 2)


def interpolate(space: ScalarSpace, fn, time: float = 0.0) -> np.ndarray:
    """Nodal interpolation; returns (n,) for scalar fn, (C, n) for vector."""
    return np.asarray(fn(space.node_coords, time))


def l2_error(
    space: ScalarSpace,
    vec: torch.Tensor,
    exact_fn,
    time: float = 0.0,
    n_q_1d: int | None = None,
    n_components: int = 1,
) -> float:
    """sqrt(int (u_h - u)^2 dx) with an n_q_1d Gauss rule (defaults to
    degree+2 like the reference drivers)."""
    if n_q_1d is None:
        n_q_1d = space.degree + 2
    ev, qp, jxw = _evaluator(space, n_q_1d, vec)
    E = qp.shape[0]
    exact = np.asarray(exact_fn(qp.reshape(-1, space.dim), time))
    vals = ev.values(_cells(space, vec)).cpu().numpy()
    if n_components == 1:
        diff2 = (vals.reshape(-1) - exact) ** 2
    else:
        exact = exact.reshape(n_components, E, ev.n_q)
        diff2 = ((np.transpose(vals, (1, 0, 2)) - exact) ** 2).sum(axis=0).reshape(-1)
    return float(np.sqrt(np.sum(diff2 * jxw.reshape(-1))))


def l2_norm(space: ScalarSpace, vec, n_q_1d: int, n_components: int = 1) -> float:
    """sqrt(int u_h^2 dx) with an n_q_1d Gauss rule."""
    return l2_error(
        space,
        vec,
        lambda x, t: (
            np.zeros(len(x)) if n_components == 1 else np.zeros((n_components, len(x)))
        ),
        n_q_1d=n_q_1d,
        n_components=n_components,
    )


def cell_divergence_norm(space: ScalarSpace, u, n_q_1d: int | None = None) -> float:
    """l2 norm over cells of the cellwise integral of div(u)
    (tests/beltrami.cc:228-251)."""
    if n_q_1d is None:
        n_q_1d = space.degree + 1
    ev, _, jxw = _evaluator(space, n_q_1d, u)
    grads = ev.gradients(_cells(space, u)).cpu().numpy()  # (E, C, dim, n_q)
    div = np.trace(grads, axis1=1, axis2=2)
    cell_div = (div * jxw).sum(axis=1)
    return float(np.sqrt((cell_div**2).sum()))
