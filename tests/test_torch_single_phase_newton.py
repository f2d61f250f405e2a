"""The port's Couette and Poiseuille drivers in their coupled Newton
configurations against the JAX package, one BDF-2 step each, float64 on the
CPU: tests/prms/couette.prm (64 x 16 cells, 9,619 dofs, a moving lid
meeting two open sides with normal flux) and
tests/prms/poiseuille_ns_small.prm (32 x 8 cells, a symmetry plane and two
open sides driven by the pressure 2 - x). The printed residual tables, the
Newton and Krylov counts and the final state agree (torch_single_phase_cases
.check_against_jax, 1e-10); the port's mat-vecs ran the coupled cell
apply's plain versions (K1/K2's, on the CPU) on velocity masks that
constrain only the tangential component of the open sides."""

import pytest

from torch_single_phase_cases import check_against_jax, kernel_route, run

CASES = {
    "couette": ("couette", "couette"),
    "poiseuille_ns_small": ("poiseuille", "poiseuille_ns_small"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_one_newton_step_against_jax(name):
    driver, prm = CASES[name]
    jax_run = run("adaflo_tpu", driver, prm, 1)
    port_run = run("adaflo_tpu_torch", driver, prm, 1)
    check_against_jax(jax_run, port_run, 1)
    assert port_run["counts"][0][0] >= 2 and "converged." in port_run["text"]
    assert kernel_route(port_run) == "kernel"
    ns = port_run["problem"].navier_stokes
    masks = ns.operator.cells.mask_u
    open_side = ns.u_space.boundary_dofs(1)
    walls = set(ns.u_space.boundary_dofs(0).tolist()) | set(
        ns.u_space.boundary_dofs(3).tolist()
    )
    inner = [d for d in open_side if d not in walls]
    # the open side's normal component is free, the tangential one fixed
    assert not masks[0][inner].any() and masks[1][inner].all()
