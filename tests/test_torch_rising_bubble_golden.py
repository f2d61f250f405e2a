"""The port's rising-bubble driver (conservative level set, symmetry
sides, variable density and viscosity) on
tests/prms/rising_bubble_ls_short.prm (20 x 40 cells, 3 steps) on the
CPU, held to tests/golden/rising_bubble_ls_short.output with the port's
compare_with_golden; its wall-time summary holds the two-phase step's
sections. The comparisons with the JAX package are
test_torch_rising_bubble.py and test_torch_rising_bubble_3d.py."""

import io
from pathlib import Path

import torch

from adaflo_tpu_torch.drivers import rising_bubble as trb
from adaflo_tpu_torch.testing import compare_with_golden
from adaflo_tpu_torch.utils.timer import print_wall_times

torch.set_num_threads(2)

HERE = Path(__file__).parent
SHORT = HERE / "prms" / "rising_bubble_ls_short.prm"


def test_golden_rising_bubble_ls_short():
    out = io.StringIO()
    par = trb.TwoPhaseParameters.from_file(str(SHORT))
    problem = trb.MicroFluidicProblem(par, out=out, device="cpu")
    problem.run()
    text = out.getvalue()
    compare_with_golden(text, HERE / "golden" / "rising_bubble_ls_short.output")
    # the bubble rises and stays round
    vy = problem.solution_data[-1][5]
    assert 0.02 < vy < 0.05 and problem.solution_data[-1][3] > 0.999
    # the wall-time summary holds the two-phase step's sections
    par.output_wall_times = True
    summary = io.StringIO()
    print_wall_times(par, problem, out=summary)
    for name in ("LS advance concentration + reinit.", "LS compute force.", "NS solve system."):
        assert f"| {name:<31s} |         3 |" in summary.getvalue(), name
