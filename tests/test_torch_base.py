"""Port base layer against the JAX package: parameters, prm parsing and the
BDF-2 time stepping (adaflo_tpu_torch.parameters / time_stepping)."""

import dataclasses
import enum
from pathlib import Path

import numpy as np
import pytest
import torch

import adaflo_tpu.parameters as jpar
import adaflo_tpu.time_stepping as jts
import adaflo_tpu_torch.parameters as tpar
import adaflo_tpu_torch.time_stepping as tts

torch.set_num_threads(2)

PRMS = sorted((Path(__file__).parent / "prms").glob("*.prm"))


def _plain(v):
    return v.value if isinstance(v, enum.Enum) else v


@pytest.mark.parametrize("prm", PRMS, ids=lambda p: p.stem)
def test_prm_files_parse_to_equal_fields(prm):
    try:
        ref = jpar.FlowParameters.from_file(str(prm))
    except Exception as exc:
        # a file that FlowParameters does not read (a driver declares extra
        # subsections): the port rejects it with the same error
        with pytest.raises(Exception) as got_exc:
            tpar.FlowParameters.from_file(str(prm))
        assert type(got_exc.value).__name__ == type(exc).__name__
        assert str(got_exc.value) == str(exc)
        return
    got = tpar.FlowParameters.from_file(str(prm))
    ref_f = {f.name: _plain(getattr(ref, f.name)) for f in dataclasses.fields(ref)}
    got_f = {f.name: _plain(getattr(got, f.name)) for f in dataclasses.fields(got)}
    assert got_f == ref_f
    assert got.pressure_degree == ref.pressure_degree


def _sequence(mod, pmod):
    ts = mod.TimeStepping(
        pmod.TimeSteppingParameters(
            time_step_scheme=pmod.Scheme("bdf_2"),
            start_time=0.0,
            end_time=1.0,
            time_step_size_start=0.07,
            time_step_size_max=0.2,
            time_step_size_min=0.01,
        )
    )
    rows = []
    steps = [0.07, 0.05, 0.11, 0.2, 0.03, 0.09]
    k = 0
    while not ts.at_end():
        ts.set_desired_time_step(steps[k % len(steps)])
        ts.next()
        rows.append(
            (ts.now(), ts.step_size(), ts.weight(), ts.weight_old(),
             ts.weight_old_old(), *ts.extrapolation_factors, ts.step_no())
        )
        k += 1
    return np.asarray(rows)


def test_bdf2_weights_equal_over_variable_steps():
    ref = _sequence(jts, jpar)
    got = _sequence(tts, tpar)
    assert len(ref) > 5
    np.testing.assert_array_equal(got, ref)  # same host arithmetic: bitwise


_ISOLATION = """
import importlib, pkgutil, sys
import adaflo_tpu_torch
for mod in pkgutil.walk_packages(adaflo_tpu_torch.__path__, "adaflo_tpu_torch."):
    importlib.import_module(mod.name)
import adaflo_tpu_torch.drivers.beltrami
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "adaflo_tpu"))
print(len([m for m in sys.modules if m.startswith("adaflo_tpu_torch")]), bad)
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATION], cwd=root, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20  # every module of the port was imported


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    from adaflo_tpu_torch.mesh.structured import StructuredMesh
    from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    par = tpar.FlowParameters.from_string("subsection Navier-Stokes\n set dimension = 3\nend\n")
    mesh = StructuredMesh((2, 2, 2), (0.0,) * 3, (1.0,) * 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NavierStokes(par, mesh)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NavierStokes(par, mesh, device="cuda")
    assert NavierStokes(par, mesh, device="cpu").device.type == "cpu"


def test_resolve_device_gives_cuda_its_index(monkeypatch):
    from adaflo_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_operator_and_multigrid_need_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    from adaflo_tpu_torch.fe.constraints import Constraints
    from adaflo_tpu_torch.fe.space import ScalarSpace
    from adaflo_tpu_torch.mesh.structured import StructuredMesh
    from adaflo_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from adaflo_tpu_torch.solvers.multigrid import LatticeGMG

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    par = tpar.FlowParameters.from_string("subsection Navier-Stokes\n set dimension = 2\nend\n")
    mesh = StructuredMesh((2, 2), (0.0,) * 2, (1.0,) * 2)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    cu = [Constraints(us.n_dofs) for _ in range(2)]
    cp = Constraints(ps.n_dofs)
    for c in cu + [cp]:
        c.close()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NavierStokesOperator(par, us, ps, cu, cp)
    assert NavierStokesOperator(par, us, ps, cu, cp, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LatticeGMG((5, 5), (0.25, 0.25), np.arange(5), 25)
    assert LatticeGMG((5, 5), (0.25, 0.25), np.arange(5), 25, device="cpu").device.type == "cpu"


def _unit_cube_cells(mask_u=None, mask_p=None):
    """Coupled-apply tables of a 2x2x2 Q2/Q1 lattice, and its dof counts."""
    from adaflo_tpu_torch.fe.space import ScalarSpace
    from adaflo_tpu_torch.mesh.structured import StructuredMesh
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.ops.lattice import LatticeOps
    from adaflo_tpu_torch.ops.tensor import CellEvaluator

    mesh = StructuredMesh((2, 2, 2), (0.0,) * 3, (1.0,) * 3)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    cells = cm.CoupledCells(
        CellEvaluator(3, us.basis, 3, mesh.h), CellEvaluator(3, ps.basis, 3, mesh.h),
        LatticeOps.for_space(us).cell_dof_table(),
        LatticeOps.for_space(ps).cell_dof_table(), mask_u, mask_p, "cpu",
    )
    return cells, us.n_dofs, ps.n_dofs


def test_kernel_wrapper_rejects_vectors_the_tables_would_overrun():
    """The kernel indexes u, p and the masks through the cell tables, so the
    wrapper refuses vectors shorter than the tables' dofs and masks of
    another shape than the vectors."""
    from adaflo_tpu_torch.ops import coupled_matvec as cm

    _, n_u, n_p = _unit_cube_cells()
    cells, _, _ = _unit_cube_cells(np.zeros((3, n_u), bool), np.zeros(n_p, bool))
    sc = cm.ApplyScalars(0.5, 20.0, 1.0, 1.0, 1.0, 0.0, 0.0)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float64)
    u, p = z(3, n_u), z(n_p)
    cm.coupled_apply(u, p, u, cells, sc)  # the right lengths pass
    with pytest.raises(ValueError, match="shorter"):
        cm.coupled_apply(z(3, n_u - 1), p, z(3, n_u - 1), cells, sc)
    with pytest.raises(ValueError, match="shorter"):
        cm.coupled_apply(u, z(n_p - 1), u, cells, sc)
    with pytest.raises(ValueError, match="velocity mask"):
        cm.coupled_apply_velocity(z(3, n_u + 1), z(3, n_u + 1), cells, sc)
    with pytest.raises(ValueError, match="pressure mask"):
        cm.coupled_apply(u, z(n_p + 1), u, cells, sc)


def test_kernel_wrapper_never_falls_back_off_the_cpu():
    """A tensor on neither the CPU nor a CUDA device gets no plain version."""
    from adaflo_tpu_torch.ops import coupled_matvec as cm

    cells, n_u, n_p = _unit_cube_cells()
    meta = dict(dtype=torch.float64, device="meta")
    u = torch.empty((3, n_u), **meta)
    p = torch.empty(n_p, **meta)
    sc = cm.ApplyScalars(0.5, 20.0, 1.0, 1.0, 1.0, 0.0, 0.0)
    calls = cm.plain_calls["coupled_apply_plain"]
    with pytest.raises(RuntimeError, match="no kernel"):
        cm.coupled_apply(u, p, u, cells, sc)
    with pytest.raises(RuntimeError, match="no kernel"):
        cm.coupled_apply_velocity(u, u, cells, sc)
    assert cm.plain_calls["coupled_apply_plain"] == calls
