"""Solver state carried across between the JAX package and the port.

The two packages keep the same state under the same names: the solution
vectors (current, old, old-old), the user right-hand side (a body force),
the time stepping's fields, the periodic axes of the mesh, the constrained
dof sets and the preconditioner bookkeeping. `state_arrays` reads them from
either package's NavierStokes solver into a flat dict of numpy arrays (it
imports neither JAX nor the JAX package: it only calls `np.asarray`);
`from_jax_state` turns such a dict into the port's tensors, and
`load_state` installs it into a port solver that was set up on the same
mesh and parameters, so that both packages can compute the same step.

Keys: solution_u, solution_p, solution_old_u, solution_old_p,
solution_old_old_u, solution_old_old_p, user_rhs_u, user_rhs_p;
ts:<field> for each field of TimeStepping (the scheme excepted); periodic;
constrained_u<c>, constrained_p, constrained_schur; and the four
preconditioner bookkeeping scalars.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_VECTORS = ("solution", "solution_old", "solution_old_old", "user_rhs")
_BOOKKEEPING = (
    "update_preconditioner",
    "update_preconditioner_frequency",
    "n_iterations_last_prec_update",
    "time_step_last_prec_update",
)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_arrays(ns) -> dict[str, np.ndarray]:
    """The state of a NavierStokes solver (either package) as numpy arrays."""
    out: dict[str, np.ndarray] = {}
    for name in _VECTORS:
        vec = getattr(ns, name)
        out[f"{name}_u"] = _np(vec[0]).astype(np.float64)
        out[f"{name}_p"] = _np(vec[1]).astype(np.float64)
    for key, val in vars(ns.time_stepping).items():
        if isinstance(val, (bool, int, float, np.floating, np.integer)):
            out[f"ts:{key}"] = np.asarray(val)
    out["periodic"] = np.asarray(ns.mesh.periodic, bool)
    for c, con in enumerate(ns.constraints_u):
        out[f"constrained_u{c}"] = np.asarray(con.constrained_dofs, np.int64)
    out["constrained_p"] = np.asarray(ns.constraints_p.constrained_dofs, np.int64)
    out["constrained_schur"] = np.asarray(
        ns.constraints_schur.constrained_dofs, np.int64
    )
    for key in _BOOKKEEPING:
        out[key] = np.asarray(getattr(ns, key))
    return out


@dataclass
class SolverState:
    solution: list
    solution_old: list
    solution_old_old: list
    user_rhs: list
    time_stepping: dict
    periodic: np.ndarray
    constrained: dict
    bookkeeping: dict


def from_jax_state(arrays: dict[str, np.ndarray], device) -> SolverState:
    """The JAX solver's state (as `state_arrays` gives it) as the port's
    float64 tensors on `device`."""
    kw = dict(dtype=torch.float64, device=device)
    vecs = {
        name: [
            torch.as_tensor(np.asarray(arrays[f"{name}_u"]), **kw),
            torch.as_tensor(np.asarray(arrays[f"{name}_p"]), **kw),
        ]
        for name in _VECTORS
    }
    ts = {k[3:]: np.asarray(v).item() for k, v in arrays.items() if k.startswith("ts:")}
    constrained = {
        k: np.asarray(v, np.int64) for k, v in arrays.items()
        if k.startswith("constrained_")
    }
    bookkeeping = {k: np.asarray(arrays[k]).item() for k in _BOOKKEEPING}
    return SolverState(
        vecs["solution"], vecs["solution_old"], vecs["solution_old_old"],
        vecs["user_rhs"], ts, np.asarray(arrays["periodic"], bool), constrained,
        bookkeeping,
    )


def load_state(ns, state: SolverState) -> None:
    """Install `state` into a port NavierStokes solver that is set up; its
    constraints must be the ones the state was taken with."""
    mine = state_arrays(ns)
    if not np.array_equal(mine["periodic"], state.periodic):
        raise ValueError("state mismatch: the periodic axes differ from this solver's")
    for key, dofs in state.constrained.items():
        if key not in mine or not np.array_equal(mine[key], dofs):
            raise ValueError(f"state mismatch: {key} differs from this solver's")
    for name in _VECTORS:
        vec = getattr(state, name)
        setattr(ns, name, [v.to(dtype=ns.dtype, device=ns.device) for v in vec])
    for key, val in state.time_stepping.items():
        setattr(ns.time_stepping, key, val)
    for key, val in state.bookkeeping.items():
        setattr(ns, key, val)
