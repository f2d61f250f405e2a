"""The port's single-phase lattice drivers held to the JAX package's
goldens on the CPU with the port's compare_with_golden (the drivers' main
with --device cpu): couette (coupled Newton, K1/K2's plain versions),
poiseuille_ns_small (coupled Newton), poiseuille_stokes and
poiseuille_stationary (the plain cell route), with the sanity anchors of
tests/test_golden_ns.py; and the reference anchor of poiseuille_ns: its
configuration to t = 2 gives ||e_u|| = 0.1321 (tests/poiseuille_ns.output
of the reference) and a pressure exact to round-off. The projection and 1D
goldens are test_torch_single_phase_golden_1d.py."""

import contextlib
import io
from pathlib import Path

import pytest
import torch

from adaflo_tpu_torch.drivers import couette, poiseuille
from adaflo_tpu_torch.parameters import FlowParameters
from adaflo_tpu_torch.testing import compare_with_golden

torch.set_num_threads(2)

HERE = Path(__file__).parent


def run_main(main, prm: str) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([str(HERE / "prms" / f"{prm}.prm"), "--device", "cpu"])
    return buf.getvalue()


def l2_errors(text: str):
    """(||e_p||, ||e_u||) of the last L2-Errors line."""
    line = [ln for ln in text.splitlines() if "L2-Errors" in ln][-1]
    return float(line.split("=")[1].split(",")[0]), float(line.split("=")[-1])


@pytest.mark.parametrize(
    "driver, prm",
    [(couette, "couette"), (poiseuille, "poiseuille_ns_small"),
     (poiseuille, "poiseuille_stokes"), (poiseuille, "poiseuille_stationary")],
    ids=lambda x: x if isinstance(x, str) else x.__name__.split(".")[-1],
)
def test_golden(driver, prm):
    text = run_main(driver.main, prm)
    compare_with_golden(text, HERE / "golden" / f"{prm}.output")
    assert "converged." in text
    if prm != "couette":
        ep, eu = l2_errors(text)
        limit = {"poiseuille_ns_small": (1.0, 1e-5), "poiseuille_stokes": (1e-8, 1e-9),
                 "poiseuille_stationary": (1.0, 1e-9)}[prm]
        assert ep < limit[0] and eu < limit[1], (ep, eu)


def test_poiseuille_reference_anchor():
    par = FlowParameters.from_file(str(HERE / "prms" / "poiseuille_ns.prm"))
    par.end_time = 2.0
    par.output_verbosity = 0
    problem = poiseuille.ChannelProblem(par, out=io.StringIO(), device="cpu")
    problem.run()
    ep, eu = problem.errors()
    assert abs(eu - 0.1321) < 2e-4, eu
    assert ep < 1e-8, ep
