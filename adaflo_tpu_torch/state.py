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
A two-phase solver (twophase.LevelSetOKZSolver in either package) passes
for its NavierStokes solver and adds its level-set state.

Keys: solution_u, solution_p, solution_old_u, solution_old_p,
solution_old_old_u, solution_old_old_p, user_rhs_u, user_rhs_p;
ts:<field> for each field of TimeStepping (the scheme excepted); periodic;
constrained_u<c>, constrained_p, constrained_schur; the four
preconditioner bookkeeping scalars; coefficients_rho and coefficients_mu
when the density and viscosity vary per q-point. Two-phase: ls:<vector>_c
and ls:<vector>_k (concentration and curvature) for solution, solution_old
and solution_old_old; ls:heaviside, ls:normal_vector_field,
ls:evaluated_normal_q; ls:last_smoothing_step, ls:old_residual,
ls:first_advance, ls:last_concentration_range.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from adaflo_tpu_torch.ops.navier_stokes import Coefficients

_VECTORS = ("solution", "solution_old", "solution_old_old", "user_rhs")
_BOOKKEEPING = (
    "update_preconditioner",
    "update_preconditioner_frequency",
    "n_iterations_last_prec_update",
    "time_step_last_prec_update",
)


_LS_VECTORS = ("solution", "solution_old", "solution_old_old")
_LS_FIELDS = ("heaviside", "normal_vector_field", "evaluated_normal_q")
_LS_SCALARS = ("last_smoothing_step", "old_residual", "first_advance")


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_arrays(solver) -> dict[str, np.ndarray]:
    """The state of a NavierStokes or two-phase solver (either package) as
    numpy arrays."""
    ns = getattr(solver, "navier_stokes", solver)
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
    co = ns.coefficients
    if co.rho is not None:
        out["coefficients_rho"] = _np(co.rho).astype(np.float64)
        out["coefficients_mu"] = _np(co.mu).astype(np.float64)
    if solver is not ns:
        for name in _LS_VECTORS:
            vec = getattr(solver, name)
            out[f"ls:{name}_c"] = _np(vec[0]).astype(np.float64)
            out[f"ls:{name}_k"] = _np(vec[1]).astype(np.float64)
        for name in _LS_FIELDS:
            out[f"ls:{name}"] = _np(getattr(solver, name)).astype(np.float64)
        for name in _LS_SCALARS:
            out[f"ls:{name}"] = np.asarray(getattr(solver, name))
        out["ls:last_concentration_range"] = np.asarray(
            solver.last_concentration_range, np.float64
        )
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
    coefficients: tuple = (None, None)  # (rho, mu) per q-point, or None
    level_set: dict = field(default_factory=dict)  # two-phase state


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
    coefficients = (None, None)
    if "coefficients_rho" in arrays:
        coefficients = tuple(
            torch.as_tensor(np.asarray(arrays[f"coefficients_{k}"]), **kw)
            for k in ("rho", "mu")
        )
    level_set = {}
    if "ls:solution_c" in arrays:
        for name in _LS_VECTORS:
            level_set[name] = [
                torch.as_tensor(np.asarray(arrays[f"ls:{name}_{k}"]), **kw) for k in "ck"
            ]
        for name in _LS_FIELDS:
            level_set[name] = torch.as_tensor(np.asarray(arrays[f"ls:{name}"]), **kw)
        for name in _LS_SCALARS:
            level_set[name] = np.asarray(arrays[f"ls:{name}"]).item()
        level_set["last_concentration_range"] = tuple(
            float(x) for x in np.asarray(arrays["ls:last_concentration_range"])
        )
    return SolverState(
        vecs["solution"], vecs["solution_old"], vecs["solution_old_old"],
        vecs["user_rhs"], ts, np.asarray(arrays["periodic"], bool), constrained,
        bookkeeping, coefficients, level_set,
    )


def load_state(solver, state: SolverState) -> None:
    """Install `state` into a port NavierStokes or two-phase solver that is
    set up; its constraints must be the ones the state was taken with."""
    ns = getattr(solver, "navier_stokes", solver)
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
    if state.coefficients[0] is not None:
        rho, mu = (c.to(dtype=ns.dtype, device=ns.device) for c in state.coefficients)
        ns.coefficients = Coefficients(rho, mu, None)
    if state.level_set:
        if solver is ns:
            raise ValueError("state mismatch: a two-phase state needs a two-phase solver")
        for key, val in state.level_set.items():
            if isinstance(val, list):
                val = [v.to(dtype=ns.dtype, device=ns.device) for v in val]
            elif torch.is_tensor(val):
                val = val.to(dtype=ns.dtype, device=ns.device)
            setattr(solver, key, val)
