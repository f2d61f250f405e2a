"""The port's 1D flow driver (flow_1d, flow_1d_damped: 2,048 cells, open
boundaries at both ends, the damping term in the second) and its Poiseuille
driver in the projection scheme (poiseuille_ns_proj_small, 50 steps) held to
the JAX package's goldens on the CPU with the port's compare_with_golden;
all three run the operator's plain cell route."""

import contextlib
import io
from pathlib import Path

import pytest
import torch

from adaflo_tpu_torch.drivers import flow_1d, poiseuille
from adaflo_tpu_torch.ops import navier_stokes as tops
from adaflo_tpu_torch.testing import compare_with_golden

torch.set_num_threads(2)

HERE = Path(__file__).parent


@pytest.mark.parametrize(
    "driver, prm",
    [(flow_1d, "flow_1d"), (flow_1d, "flow_1d_damped"),
     (poiseuille, "poiseuille_ns_proj_small")],
    ids=["flow_1d", "flow_1d_damped", "poiseuille_ns_proj_small"],
)
def test_golden(driver, prm):
    before = dict(tops.PLAIN_ROUTE_APPLIES)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        driver.main([str(HERE / "prms" / f"{prm}.prm"), "--device", "cpu"])
    text = buf.getvalue()
    compare_with_golden(text, HERE / "golden" / f"{prm}.output")
    assert tops.PLAIN_ROUTE_APPLIES["velocity_vmult"] > before["velocity_vmult"]
    if prm.startswith("flow_1d"):
        assert text.count("Time step #") == 5 and text.count("converged.") == 5
        assert tops.PLAIN_ROUTE_APPLIES["vmult"] > before["vmult"]
    else:
        eu = float([ln for ln in text.splitlines() if "L2-Errors" in ln][-1].split("=")[-1])
        assert eu < 5e-3
