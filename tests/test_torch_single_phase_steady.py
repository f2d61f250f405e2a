"""The port's Poiseuille driver in its Stokes and stationary
configurations (tests/prms/poiseuille_stokes.prm, 32 x 8 cells;
poiseuille_stationary.prm, 16 x 4 cells) and the 1D flow
(tests/prms/flow_1d.prm, 2,048 cells, open boundaries at both ends, `ilu
scalar`) against the JAX package, one step each, float64 on the CPU: the
printed residual tables, the Newton and Krylov counts and the final state
(torch_single_phase_cases.check_against_jax). The port's mat-vecs ran the
plain cell route ("einsum"): none of these configurations has a kernel.

Stokes and stationary agree to 1e-10 of the solution's size. The 1D state
agrees to 1e-8: its inner BiCGStab (the second stage of the first linear
solve) amplifies rounding differences between the two packages' sums (1e-14
relative after 10 iterations, 5e-3 after 18, both within their 3e-2
tolerance), so the two Newton iterates agree to their nonlinear tolerance
(1e-9), 8e-10 of the solution's size, not to round-off; their last updates
are two solves of one system that agree to its linear tolerance only, and
are left out."""

import pytest

from torch_single_phase_cases import check_against_jax, kernel_route, run

CASES = {
    "poiseuille_stokes": ("poiseuille", "poiseuille_stokes", 1e-10),
    "poiseuille_stationary": ("poiseuille", "poiseuille_stationary", 1e-10),
    "flow_1d": ("flow_1d", "flow_1d", 1e-8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_one_step_against_jax(name):
    driver, prm, tol = CASES[name]
    jax_run = run("adaflo_tpu", driver, prm, 1)
    port_run = run("adaflo_tpu_torch", driver, prm, 1)
    check_against_jax(jax_run, port_run, 1, tol=tol, updates=tol <= 1e-10)
    assert kernel_route(port_run) == "einsum"
    assert port_run["plain_route"]["vmult"] > 0
    assert port_run["plain_route"]["velocity_vmult"] > 0
