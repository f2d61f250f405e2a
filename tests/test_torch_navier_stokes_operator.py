"""The port's NavierStokesOperator and its coupled cell apply's plain version
against the JAX einsum operator: 3D Q2/Q1 (the slice's table set). Cases,
checks and tolerances: torch_operator_cases.py."""

import pytest
import torch

from torch_operator_cases import (
    MODES,
    build_cases,
    case_keys,
    check_plain_version_mode,
    check_residual_assemble,
    check_velocity_vmult_and_diagonals,
    check_vmult,
    check_vmult_layout,
)

torch.set_num_threads(2)

KEYS, IDS = case_keys(3, 2)


@pytest.fixture(scope="module")
def cases():
    return build_cases(KEYS)


@pytest.fixture
def case(request, cases):
    return cases[request.param]


@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_residual_assemble(case):
    check_residual_assemble(case)


@pytest.mark.parametrize("variable", [False, True], ids=["const", "variable"])
@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_vmult(case, variable):
    check_vmult(case, variable)


@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_velocity_vmult_and_diagonals(case):
    check_velocity_vmult_and_diagonals(case)


@pytest.mark.parametrize("lin_kind", ["dofs", "qfields"])
@pytest.mark.parametrize("layout", ["pr", "t", "n", "pe", "pi"])
@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_vmult_layouts(case, layout, lin_kind):
    check_vmult_layout(case, layout, lin_kind)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_plain_version_modes(case, mode):
    check_plain_version_mode(case, mode)


def test_wrapper_routes_cpu_tensors_to_the_plain_version(cases):
    from adaflo_tpu_torch.ops import coupled_matvec as cm

    case = cases[(3, 2, True)]
    before = cm.plain_calls["coupled_apply_plain"]
    launched = dict(cm.launches)
    case.top.vmult(case.t["du"], case.t["dp"], case.ttw, case.tres[2])
    assert cm.plain_calls["coupled_apply_plain"] == before + 1
    assert cm.launches == launched
