"""The port's static-bubble driver (conservative level set, equal phase
densities: constant coefficients) on tests/prms/spurious_currents_ls_short.prm
(24 x 24 cells, 3 steps) on the CPU, held to
tests/golden/spurious_currents_ls_short.output with the port's
compare_with_golden, and to the golden's last pressure-jump error and
spurious-current size to 1e-8 relative."""

import io
from pathlib import Path

import torch

from adaflo_tpu_torch.drivers import spurious_currents as tsc
from adaflo_tpu_torch.drivers.rising_bubble import TwoPhaseParameters
from adaflo_tpu_torch.testing import compare_with_golden

torch.set_num_threads(2)

HERE = Path(__file__).parent


def _last(text, key):
    return float([ln for ln in text.splitlines() if key in ln][-1].split()[-2 if key == "jump" else -1])


def test_golden_spurious_currents_ls_short():
    out = io.StringIO()
    par = TwoPhaseParameters.from_file(str(HERE / "prms" / "spurious_currents_ls_short.prm"))
    problem = tsc.MicroFluidicProblem(par, out=out, device="cpu")
    problem.run()
    text = out.getvalue()
    golden = (HERE / "golden" / "spurious_currents_ls_short.output").read_text()
    compare_with_golden(text, HERE / "golden" / "spurious_currents_ls_short.output")
    assert problem.navier_stokes.coefficients.rho is None
    for key in ("jump", "absolute"):
        got, ref = _last(text, key), _last(golden, key)
        assert abs(got - ref) <= 1e-8 * abs(ref), (key, got, ref)
