"""The lattice goldens of the rising bubble's variants and of augmented
Taylor-Hood, run by the port's drivers (their main with --device cpu) and
held to tests/golden/<prm>.output with the port's compare_with_golden:

- rising_bubble_ls_{picard,imex,expl}_short: the 2D bubble (20 x 40 cells)
  with the coupled Picard, semi-implicit and explicit linearizations, on the
  operator's plain cell route;
- rising_bubble_ls_q3_short: the 2D bubble at velocity degree 3 (10 x 20
  cells, coupled Newton), on K1/K2's 2D Q3/Q2 instance (its plain versions
  on the CPU);
- rising_bubble_ls_augp_short, beltrami_2d_augp_small,
  beltrami_2d_augp_proj_small: augmented Taylor-Hood elements (FE_Q_DG0
  pressure) on the lattice, on the plain cell route;
- under `slow` (ADAFLO_RUN_SLOW=1): beltrami_3d_augp_small (8^3 cells,
  about 170 s on two CPU threads, most of it the host's issue of the
  velocity GMG's V-cycles) and spurious_currents_ls_3d_short (15^3 cells,
  about 170 s); both run on the card in chip_smoke.py's phase 3.

Each run also records which route served vmult and velocity_vmult. The
comparisons with the JAX package's own output are
test_torch_q3_bubble_step.py and test_torch_augmented_steps.py."""

import contextlib
import importlib
import io
import os
from pathlib import Path

import pytest
import torch

from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import navier_stokes as tns
from adaflo_tpu_torch.testing import compare_with_golden

torch.set_num_threads(2)

HERE = Path(__file__).parent
SLOW = pytest.mark.skipif(
    os.environ.get("ADAFLO_RUN_SLOW") is None, reason="set ADAFLO_RUN_SLOW=1"
)
# (golden, driver module, route of vmult and velocity_vmult)
GOLDENS = [
    ("rising_bubble_ls_picard_short", "rising_bubble", "einsum"),
    ("rising_bubble_ls_imex_short", "rising_bubble", "einsum"),
    ("rising_bubble_ls_expl_short", "rising_bubble", "einsum"),
    ("rising_bubble_ls_q3_short", "rising_bubble", "kernel"),
    ("rising_bubble_ls_augp_short", "rising_bubble", "einsum"),
    ("beltrami_2d_augp_small", "beltrami", "einsum"),
    ("beltrami_2d_augp_proj_small", "beltrami", "einsum"),
    pytest.param("beltrami_3d_augp_small", "beltrami", "einsum", marks=SLOW),
    pytest.param("spurious_currents_ls_3d_short", "spurious_currents", "einsum", marks=SLOW),
]


def run_main(driver: str, prm: str):
    """(printed text, plain-version calls, plain-route applies) of the
    driver's main on tests/prms/<prm>.prm on the CPU."""
    main = importlib.import_module(f"adaflo_tpu_torch.drivers.{driver}").main
    plain0, route0 = dict(cm.plain_calls), dict(tns.PLAIN_ROUTE_APPLIES)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([str(HERE / "prms" / f"{prm}.prm"), "--device", "cpu"])
    plain = {k: v - plain0[k] for k, v in cm.plain_calls.items() if v > plain0[k]}
    route = {k: v - route0[k] for k, v in tns.PLAIN_ROUTE_APPLIES.items() if v > route0[k]}
    return buf.getvalue(), plain, route


@pytest.mark.parametrize("golden, driver, route", GOLDENS)
def test_golden(golden, driver, route):
    text, plain, applies = run_main(driver, golden)
    compare_with_golden(text, HERE / "golden" / f"{golden}.output")
    assert text.count("Time step #") >= 2
    if route == "kernel":
        # K1/K2's plain versions (the CPU's stand-in for the kernel) alone
        assert set(plain) == {"coupled_apply_plain"} and not applies, (plain, applies)
    else:
        assert not plain and applies.get("velocity_vmult", 0) > 0, (plain, applies)
