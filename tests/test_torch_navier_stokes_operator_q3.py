"""The port's NavierStokesOperator and its coupled cell apply's plain version
against the JAX einsum operator: 3D Q3/Q2. Cases, checks and tolerances:
torch_operator_cases.py."""

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
)

torch.set_num_threads(2)

KEYS, IDS = case_keys(3, 3)


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


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", KEYS, ids=IDS, indirect=True)
def test_plain_version_modes(case, mode):
    check_plain_version_mode(case, mode)
