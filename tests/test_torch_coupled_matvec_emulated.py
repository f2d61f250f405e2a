"""The CUDA source of the coupled cell apply, run on the CPU.

`csrc/coupled_matvec.cu` is compiled with g++ against the emulation header
of `tests/torch_emulation.py` (one thread per block). The library is
driven through the port's own ctypes argument packing
(`ops/coupled_matvec._launch_cells` / `_launch_epilogue`) on CPU tensors and
compared with the plain versions in every mode, float64 (1e-12 relative)
and float32 (1e-5): the nodal entries (K1, K2) against
`coupled_apply_plain`, the cell-block entries (K3 with the u* dof and
q-field streams, K4's in-kernel gather; coupled and velocity-only) against
`coupled_apply_cells_plain` and `coupled_apply_gather_plain`, on a box and
on a periodic lattice (wrapped cell tables); and the probe instances on a
4^3 box (K12's and K13's phase-masked instances against
`coupled_apply_ablated_plain`, K11's table-free lattice source against
`coupled_apply_plain`, K6's tiled scatter against `scatter_cells_plain` on
boxes, uneven, periodic and sub-tile lattices, with its node multiplicities
and its count of global atomics), and K13's
three schedules (rowdma, pipe and unroll2, each on the one-shot body's
gather and compute) against full's plain version on boxes whose group
counts, at each schedule's own cells per group, make the persistent grid's
blocks loop, rowdma's also with poisoned constrained entries; the
cell-block entries bit for bit against saved digests of their outputs; every
production entry at each table set and
precision on a lattice whose last cell group is short (a tail group of the
one-shot body's compile-time cells per block), and the geometry entry's
cells per block and shared memory against hand-worked numbers. What this
cannot show: that nvcc accepts the source,
what many threads do, and that the copies are asynchronous; `chip_smoke.py`
checks all three on the card. Skips where g++ is missing."""

import numpy as np
import pytest
import torch

from adaflo_tpu_torch.fe.space import ScalarSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops.lattice import LatticeOps
from adaflo_tpu_torch.ops.tensor import CellEvaluator
from adaflo_tpu_torch.scripts import joint_err
from torch_emulation import EMU_SMS, build_emulated

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory, monkeypatch_module):
    lib = cm.bind(build_emulated("coupled_matvec.cu", tmp_path_factory.mktemp("coupled_matvec_emu")))
    # the wrapper's launch helpers, pointed at the emulated library and a
    # null stream, for this module only
    monkeypatch_module.setattr(cm, "load_library", lambda: lib)
    monkeypatch_module.setattr(cm, "_stream", lambda device: 0)
    return lib


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def _case(dim, degree, dtype, constrained, periodic=False, shape=None):
    rng = np.random.default_rng(dim * 10 + degree)
    if shape is None:
        shape = (3, 4, 2) if dim == 3 else (4, 3)
    mesh = StructuredMesh(shape, (0.0,) * dim, (1.0, 1.3, 0.7)[:dim])
    if periodic:
        for axis in (0, 2)[: dim - 1]:
            mesh.set_periodic(axis)
    us, ps = ScalarSpace(mesh, degree), ScalarSpace(mesh, degree - 1)
    ev_u = CellEvaluator(dim, us.basis, degree + 1, mesh.h, device="cpu")
    ev_p = CellEvaluator(dim, ps.basis, degree + 1, mesh.h, device="cpu")
    mask_u = mask_p = None
    if constrained:
        mask_u = np.zeros((dim, us.n_dofs), bool)
        mask_u[:, us.boundary_dofs(0)] = True
        mask_p = np.zeros(ps.n_dofs, bool)
        mask_p[0] = True
    cells = cm.CoupledCells(
        ev_u, ev_p, LatticeOps.for_space(us).cell_dof_table(),
        LatticeOps.for_space(ps).cell_dof_table(), mask_u, mask_p, "cpu",
    )
    t = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype)
    u, p, s = t(dim, us.n_dofs), t(ps.n_dofs), t(dim, us.n_dofs)
    coeffs = tuple(
        torch.tensor(rng.uniform(0.5, 2.0, (mesh.n_cells, cells.n_q)), dtype=dtype)
        for _ in range(3)
    )
    return cells, u, p, s, coeffs


SETS = [(3, 2), (2, 2), (3, 3)]
MODES = ["const", "variable", "ids-scale-norm", "velocity"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim,degree", SETS, ids=["3d-q2", "2d-q2", "3d-q3"])
def test_emulated_kernel_matches_plain_version(emulated, dim, degree, mode, dtype):
    cells, u, p, s, coeffs = _case(dim, degree, dtype, mode != "const")
    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    co = coeffs if mode == "variable" else None
    if mode == "velocity":
        ref = [cm.coupled_apply_plain(u, None, s, cells, sc, velocity_only=True)]
        out_u = torch.zeros_like(u)
        cm._launch_cells(cm.MODE_NODAL, False, u, None, s, cells, sc, None, out_u, None)
        cm._launch_epilogue(u, None, cells, out_u, None, True, None, None)
        got = [out_u]
    else:
        kw = dict(identity=mode != "const", scale=0.37 if mode != "const" else None)
        ref = list(cm.coupled_apply_plain(u, p, s, cells, sc, coeffs=co, want_norm=True, **kw))
        out_u, out_p = torch.zeros_like(u), torch.zeros_like(p)
        norm = torch.zeros((), dtype=dtype)
        cm._launch_cells(cm.MODE_NODAL, True, u, p, s, cells, sc, co, out_u, out_p)
        cm._launch_epilogue(u, p, cells, out_u, out_p, kw["identity"], kw["scale"], norm)
        got = [out_u, out_p, norm]
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    scale = max(float(b.abs().max()) for b in ref)
    assert err <= (1e-12 if dtype == torch.float64 else 1e-5) * scale


ENTRIES = [
    "cells", "cells-velocity", "cells-qfields", "cells-qfields-velocity",
    "gather", "gather-velocity",
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("lattice", ["box", "periodic"])
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("dim,degree", SETS, ids=["3d-q2", "2d-q2", "3d-q3"])
def test_emulated_block_entries_match_plain_versions(
    emulated, dim, degree, entry, lattice, dtype
):
    """K3 (both streams) and K4, coupled and velocity-only, write the same
    unscattered (E, n_cols) cell block as their plain versions."""
    cells, u, p, s, _ = _case(dim, degree, dtype, True, lattice == "periodic")
    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    velocity = entry.endswith("velocity")
    rng = np.random.default_rng(7)
    E, nl, npl = cells.n_cells, cells.ev_u.n_local, cells.ev_p.n_local
    t = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype)
    if entry.startswith("gather"):
        pp = None if velocity else p
        ref = cm.coupled_apply_gather_plain(u, pp, s, cells, sc)
        got = torch.full_like(ref, float("nan"))
        cm._launch_cells(cm.MODE_GATHER, not velocity, u, pp, s, cells, sc, None, got, None)
    else:
        x = t(E, dim * nl + (0 if velocity else npl))
        qfields = "qfields" in entry
        stream = t(E, dim * (dim + 1), cells.n_q) if qfields else t(E, dim * nl)
        mode = cm.MODE_CELLS_QFIELDS if qfields else cm.MODE_CELLS
        ref = cm.coupled_apply_cells_plain(x, stream, cells, sc, velocity_only=velocity)
        got = torch.full_like(ref, float("nan"))
        cm._launch_cells(mode, not velocity, x, None, stream, cells, sc, None, got, None)
    assert got.shape == ref.shape
    err = float((got - ref).abs().max())
    assert err <= (1e-12 if dtype == torch.float64 else 1e-5) * float(ref.abs().max())


# SHA-256 (its first 32 hex digits) of the cell-block entries' outputs, ENTRIES
# in turn, on _case's box with Dirichlet rows, the x blocks and u* streams
# drawn from default_rng(7) in that order: the one-shot body's bits before
# its gather and its compute became two functions (the periodic channel's
# BiCGStab inner solves follow K3's last bit)
BLOCK_DIGESTS = {
    (3, 2, torch.float64): "4d102b5b289fd5d4c6a6dca85c6ae12e",
    (3, 2, torch.float32): "00753a54d339907e34edd2d2a1f4198c",
    (2, 2, torch.float64): "3727c2f13f0f54e10b3675a2e60275c4",
    (2, 2, torch.float32): "7cfa2388f90fc479acf82fea864fd037",
    (3, 3, torch.float64): "2119250a3633d659717ada3ef0a7043c",
    (3, 3, torch.float32): "73d0d5afa641a200d77a09fca4bf7177",
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("dim,degree", SETS, ids=["3d-q2", "2d-q2", "3d-q3"])
def test_emulated_block_entries_keep_their_bits(emulated, dim, degree, dtype):
    """K3 (both streams) and K4, coupled and velocity-only, write the
    (E, n_cols) blocks they wrote before, bit for bit (BLOCK_DIGESTS): each
    output element is written once, so the one-shot body is deterministic."""
    import hashlib

    cells, u, p, s, _ = _case(dim, degree, dtype, True)
    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    rng = np.random.default_rng(7)
    E, nl, npl = cells.n_cells, cells.ev_u.n_local, cells.ev_p.n_local
    t = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype)
    digest = hashlib.sha256()
    for entry in ENTRIES:
        velocity = entry.endswith("velocity")
        got = torch.full((E, dim * nl + (0 if velocity else npl)), float("nan"), dtype=dtype)
        if entry.startswith("gather"):
            cm._launch_cells(cm.MODE_GATHER, not velocity, u, None if velocity else p, s, cells,
                             sc, None, got, None)
        else:
            qfields = "qfields" in entry
            x = t(*got.shape)
            stream = t(E, dim * (dim + 1), cells.n_q) if qfields else t(E, dim * nl)
            cm._launch_cells(cm.MODE_CELLS_QFIELDS if qfields else cm.MODE_CELLS, not velocity,
                             x, None, stream, cells, sc, None, got, None)
        digest.update(got.numpy().tobytes())
    assert digest.hexdigest()[:32] == BLOCK_DIGESTS[(dim, degree, dtype)]


def _box4(dtype, shape=(4, 4, 4)):
    """The probes' Dirichlet box at 4^3 cells (or `shape`), Q2/Q1, with its
    masks (every velocity boundary dof, one pressure dof) and the lattice
    shape."""
    rng = np.random.default_rng(44)
    mesh = StructuredMesh(shape, (0.0,) * 3, (1.0,) * 3)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    ev_u = CellEvaluator(3, us.basis, 3, mesh.h, device="cpu")
    ev_p = CellEvaluator(3, ps.basis, 3, mesh.h, device="cpu")
    mask_u = np.zeros((3, us.n_dofs), bool)
    mask_u[:, us.boundary_dofs(0)] = True
    mask_p = np.zeros(ps.n_dofs, bool)
    mask_p[0] = True
    cells = cm.CoupledCells(
        ev_u, ev_p, LatticeOps.for_space(us).cell_dof_table(),
        LatticeOps.for_space(ps).cell_dof_table(), mask_u, mask_p, "cpu",
        lattice=(mesh.n_cells_axis, tuple(mesh.periodic)),
    )
    t = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype)
    return cells, t(3, us.n_dofs), t(ps.n_dofs), t(3, us.n_dofs), t


# the probe checks hold max-abs error over max-abs of the whole output
# [u | p] (joint_err): a variant may leave one part at roundoff (a dropped
# gather gives the cell constant values, so the divergence rows vanish)
PROBE_VARIANTS = [("K12", v) for v in cm.K12_VARIANTS] + [("K13", v) for v in cm.K13_VARIANTS]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("probe,variant", PROBE_VARIANTS, ids=[f"{p}-{v}" for p, v in PROBE_VARIANTS])
def test_emulated_probe_instances_match_plain_versions(emulated, probe, variant, dtype):
    """K12/K13: each phase-masked instance of the cell kernel writes the
    nodal output of coupled_apply_ablated_plain for its variant."""
    cells, u, p, s, _ = _box4(dtype)
    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    ph = cm.VARIANTS[variant]
    M = cells.probe_tables(u.device, dtype, sc)["M89"] if ph & cm.PH_MDOT else None
    ref = cm.coupled_apply_ablated_plain(u, p, s, cells, sc, variant)
    got = (torch.zeros_like(u), torch.zeros_like(p))
    cm._launch_variant(ph, None, u, p, s, cells, sc, M, *got)
    assert joint_err(got, ref)[1] <= (1e-12 if dtype == torch.float64 else 1e-5)


# boxes for the schedules, at each schedule's cells per group (rowdma 6
# float64 / 13 float32, pipe 7 / 14, unroll2 5 / 10): 4^3 (every schedule
# many groups per block of the persistent grid; an odd count for rowdma and
# for unroll2 in float64), 3 x 3 x 2 and 1 x 3 x 3 (one to three groups, or
# pairs: mostly a block runs its prologue's group alone, and a single group
# makes a grid of one block), 9 x 5 x 2 (every count of groups, or pairs, odd
# and more than the grid: not a multiple of it; groups straddle x-row ends,
# a float32 pipe group three rows) and 1 x 7 x 7 (one cell per x-row, so a
# pipe group has a segment per cell; every schedule loops)
SCHED_SHAPES = [(4, 4, 4), (3, 3, 2), (1, 3, 3), (9, 5, 2), (1, 7, 7)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SCHED_SHAPES, ids=["x".join(map(str, s)) for s in SCHED_SHAPES])
@pytest.mark.parametrize("schedule", list(cm.K13_SCHEDULES))
def test_emulated_schedules_match_full_plain_version(emulated, schedule, shape, dtype):
    """K13's schedules (rowdma, pipe and unroll2 on the one-shot body's
    gather and compute) with Dirichlet masks (the
    zero-filled copies) write full's nodal output. The emulated card has
    EMU_SMS SMs of one resident block; where there are more groups (pairs
    for unroll2) than blocks, each block loops over its groups through both
    staging slots (both work areas; the pipe's slab and its one work area),
    and an odd group count leaves a last pair without its second group."""
    cells, u, p, s, _ = _box4(dtype, shape)
    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    ref = cm.coupled_apply_ablated_plain(u, p, s, cells, sc, schedule)
    got = (torch.zeros_like(u), torch.zeros_like(p))
    cm._launch_variant(cm.PH_ALL, None, u, p, s, cells, sc, None, *got,
                       sched=cm.K13_SCHEDULES[schedule])
    assert joint_err(got, ref)[1] <= (1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_rowdma_loops_through_both_staging_slots_with_masks(emulated, dtype):
    """rowdma on the 4^3 box, where each block of the emulated grid runs at
    least two groups, so its gathers land in both staging slots, one after
    the other, and stage x reads each back: with u and p poisoned (NaN) at
    their constrained entries, the zero-filled copies keep the output finite
    and equal to full's plain version (which masks them)."""
    cells, u, p, s, _ = _box4(dtype)
    cpb = cm.schedule_residency(dtype, "rowdma", 4)["cpb"]
    assert -(-cells.n_cells // cpb) >= 2 * EMU_SMS + 1
    u = u.masked_fill(cells.mask_u, float("nan"))
    p = p.masked_fill(cells.mask_p, float("nan"))
    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    ref = cm.coupled_apply_ablated_plain(u, p, s, cells, sc, "rowdma")
    got = (torch.zeros_like(u), torch.zeros_like(p))
    cm._launch_variant(cm.PH_ALL, None, u, p, s, cells, sc, None, *got,
                       sched=cm.SCHED_ROW_ASYNC)
    assert all(bool(torch.isfinite(g).all()) for g in got + ref)
    assert joint_err(got, ref)[1] <= (1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("schedule", list(cm.K13_SCHEDULES))
def test_emulated_schedule_boxes_cover_every_loop(emulated, schedule, dtype):
    """SCHED_SHAPES hold, at each schedule's own cells per group, a box
    whose blocks loop over several groups, one with an odd group count, one
    whose count of groups (pairs for unroll2) is odd and more than the grid
    (not a multiple of it), one whose groups straddle x-row ends and one of a
    cell per x-row."""
    cpb = cm.schedule_residency(dtype, schedule, 1)["cpb"]
    runs = {}  # shape: (cell groups, units of the grid: groups or pairs, blocks)
    for shape in SCHED_SHAPES:
        groups = -(-int(np.prod(shape)) // cpb)
        units = -(-groups // 2) if schedule == "unroll2" else groups
        runs[shape] = (groups, units, min(units, EMU_SMS))
    assert any(units > grid for _, units, grid in runs.values())
    assert any(groups % 2 == 1 and units > grid for groups, units, grid in runs.values())
    assert any(units > grid and units % grid for _, units, grid in runs.values())
    assert any(shape[0] % cpb and units > grid for shape, (_, units, grid) in runs.items())
    assert any(shape[0] == 1 and units > grid for shape, (_, units, grid) in runs.items())


def test_emulated_schedule_entry_refuses_what_it_does_not_instance(emulated):
    """The C entry returns an error, which the wrapper raises, for a
    schedule with dropped phases, with the table-free lattice source, or an
    unknown one, and for pipe without the cells per axis: no silent
    fallback to another instance."""
    cells, u, p, s, _ = _box4(torch.float64)
    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    out = (torch.zeros_like(u), torch.zeros_like(p))
    bad = [
        (cm.PH_GATHER | cm.PH_SCATTER, None, cm.SCHED_ROW_ASYNC),
        (cm.PH_ALL, (4, 4), cm.SCHED_PAIR),
        (cm.PH_ALL, None, 7),
    ]
    for phases, lattice, sched in bad:
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            cm._launch_variant(phases, lattice, u, p, s, cells, sc, None, *out, sched=sched)
    cells.lattice = None  # no cells per axis for the pipe's copies
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        cm._launch_variant(cm.PH_ALL, None, u, p, s, cells, sc, None, *out, sched=cm.SCHED_PIPE)


def test_emulated_residency_counts_each_schedules_shared_memory(emulated):
    """The residency entry's body, cells per group and shared memory per
    block at 48 cells along x. Every schedule runs the one-shot body: work
    areas of CPB cells of 699 values, each rounded up to 16 bytes. rowdma
    one, with two staging slots of CPB cells of 170 values (6 x 27 item
    dofs, 8 pressure dofs): 6 x 5,592 + 2 x 6 x 1,360 = 49,872 B float64,
    36,352 (13 x 2,796 to 16) + 2 x 13 x 680 = 54,032 B float32 (7 cells
    would take 58,184 / 58,192 B and 14 float32 58,192). pipe one, with its
    slab (2 segments of 54 velocity and 4 pressure run slots, each the
    16-byte aligned size of a run plus 15 bytes: 144 and 80 B at CPB 7
    float64 and CPB 14 float32) and its mbarrier and tables (8 + 2 x 58 x 8
    + CPB x 8 bytes, to 16); unroll2 two. CPB is the most, up to full's, at
    which four blocks and their 1 KB of reserve fit 228 KB: rowdma 6
    float64 and 13 float32, pipe 7 (8 would take 63,792 B) and 14, unroll2
    5 and 10. "full" (the one-shot body of K1's instance): 10 cells
    (float64) or 20 (float32) of 699 values
    (test_emulated_geometry_of_production_instances). The emulated card
    holds one block per SM."""
    pipe_tables = {7: 992, 14: 1056}
    expect = {
        torch.float64: {"full": ("lines", 10, 10 * 699 * 8),
                        "rowdma": ("lines", 6, 6 * 5592 + 2 * 6 * 170 * 8),
                        "pipe": ("lines", 7, 39152 + 2 * (54 * 144 + 4 * 80) + pipe_tables[7]),
                        "unroll2": ("lines", 5, 2 * 27968)},
        torch.float32: {"full": ("lines", 20, 20 * 699 * 4),
                        "rowdma": ("lines", 13, 36352 + 2 * 13 * 170 * 4),
                        "pipe": ("lines", 14, 39152 + 2 * (54 * 144 + 4 * 80) + pipe_tables[14]),
                        "unroll2": ("lines", 10, 2 * 27968)},
    }
    for dtype, names in expect.items():
        for name, (body, cpb, smem) in names.items():
            assert cm.schedule_residency(dtype, name, 48) == {
                "body": body, "cpb": cpb, "smem": smem, "blocks_per_sm": 1}
            assert 4 * (smem + 1024) <= 228 * 1024


def _slots(dim, degree, mode, pres):
    """The one-shot body's slots per cell, values per slot and q points per
    cell: 2 dim items (dim with the q-field stream) of dim + 1 slots, the
    pressure's, each of (degree + 1)^dim values."""
    items = dim if mode == cm.MODE_CELLS_QFIELDS else 2 * dim
    n = (degree + 1) ** dim
    return items * (dim + 1) + (1 if pres else 0), n, n


def test_emulated_geometry_of_production_instances(emulated):
    """The geometry entry's cells per block and shared memory per block of
    every production instance. Each cell holds its slots (_slots), the cell
    stride padded up to the q points per cell modulo 32; CPB is 56 KB // the
    cell's bytes, at least 1. Worked out by hand: 3D Q2/Q1 with pressure 25
    x 27 = 675 values, padded to 699 (= 27 mod 32): 10 float64 cells of
    5,592 B, 20 float32; velocity only 24 slots, 667 values, 10 cells; the
    q-field stream 13 slots, 379 values, 18 cells; 2D Q2/Q1 (4 items of 3
    slots) 13 x 9 = 117, padded to 137 (= 9 mod 32), 52 cells; 3D Q3/Q2 25 x
    64 = 1,600 (= 0 mod 32), 4 float64 cells and 8 float32. The emulated card
    holds one block per SM."""
    by_hand = {
        (torch.float64, cm.MODE_NODAL, True, 3, 2): (10, 10 * 699 * 8),
        (torch.float32, cm.MODE_NODAL, True, 3, 2): (20, 20 * 699 * 4),
        (torch.float64, cm.MODE_NODAL, False, 3, 2): (10, 10 * 667 * 8),
        (torch.float64, cm.MODE_CELLS_QFIELDS, True, 3, 2): (18, 18 * 379 * 8),
        (torch.float64, cm.MODE_GATHER, True, 2, 2): (52, 52 * 137 * 8),
        (torch.float64, cm.MODE_CELLS, True, 3, 3): (4, 4 * 1600 * 8),
        (torch.float32, cm.MODE_CELLS, True, 3, 3): (8, 8 * 1600 * 4),
    }
    for (dtype, mode, pres, dim, degree), (cpb, smem) in by_hand.items():
        assert cm.cell_geometry(dtype, mode, pres, dim, degree) == {
            "cpb": cpb, "smem": smem, "blocks_per_sm": 1}
    for dim, degree in cm.TABLE_SETS:
        for _, mode, pres in cm.PRODUCTION_ENTRIES:
            for dtype in (torch.float64, torch.float32):
                g = cm.cell_geometry(dtype, mode, pres, dim, degree)
                slots, nb, nq = _slots(dim, degree, mode, pres)
                stride = slots * nb + (nq - slots * nb) % 32
                size = 8 if dtype == torch.float64 else 4
                assert g["cpb"] == max(1, 56 * 1024 // (stride * size))
                assert g["smem"] == g["cpb"] * stride * size


# the production entries, each at its own cells per block (a tail group)
TAIL_ENTRIES = [e for e, _, _ in cm.PRODUCTION_ENTRIES]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("entry", TAIL_ENTRIES)
@pytest.mark.parametrize("dim,degree", SETS, ids=["3d-q2", "2d-q2", "3d-q3"])
def test_emulated_tail_group_matches_plain_version(emulated, dim, degree, entry, dtype):
    """Every production entry on a lattice of 2 CPB + 2 cells ((CPB + 1) x 2
    [x 1], CPB the instance's cells per block), with Dirichlet rows: two
    full groups and a last one of 2 cells, which the one-shot body masks.
    K1 in its variable-coefficient mode with identity rows, scale and norm;
    K2 with its identity rows; K3 and K4 as their plain versions."""
    mode, pres = next((m, pr) for e, m, pr in cm.PRODUCTION_ENTRIES if e == entry)
    cpb = cm.cell_geometry(dtype, mode, pres, dim, degree)["cpb"]
    shape = (cpb + 1, 2, 1)[:dim]
    cells, u, p, s, coeffs = _case(dim, degree, dtype, True, shape=shape)
    assert cells.n_cells % cpb == 2 and cells.n_cells > 2 * cpb
    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    rng = np.random.default_rng(17)
    E, nl, npl = cells.n_cells, cells.ev_u.n_local, cells.ev_p.n_local
    t = lambda *sh: torch.tensor(rng.standard_normal(sh), dtype=dtype)
    if entry == "coupled_apply":
        kw = dict(identity=True, scale=0.37)
        ref = list(cm.coupled_apply_plain(u, p, s, cells, sc, coeffs=coeffs, want_norm=True,
                                          **kw))
        got = [torch.zeros_like(u), torch.zeros_like(p), torch.zeros((), dtype=dtype)]
        cm._launch_cells(cm.MODE_NODAL, True, u, p, s, cells, sc, coeffs, *got[:2])
        cm._launch_epilogue(u, p, cells, *got[:2], True, 0.37, got[2])
    elif entry == "coupled_apply_velocity":
        ref = [cm.coupled_apply_plain(u, None, s, cells, sc, velocity_only=True)]
        got = [torch.zeros_like(u)]
        cm._launch_cells(cm.MODE_NODAL, False, u, None, s, cells, sc, None, got[0], None)
        cm._launch_epilogue(u, None, cells, got[0], None, True, None, None)
    elif entry.startswith("coupled_apply_gather"):
        pp = p if pres else None
        ref = [cm.coupled_apply_gather_plain(u, pp, s, cells, sc)]
        got = [torch.full_like(ref[0], float("nan"))]
        cm._launch_cells(cm.MODE_GATHER, pres, u, pp, s, cells, sc, None, got[0], None)
    else:
        x = t(E, dim * nl + (npl if pres else 0))
        stream = t(E, dim * (dim + 1), cells.n_q) if mode == cm.MODE_CELLS_QFIELDS else t(E, dim * nl)
        ref = [cm.coupled_apply_cells_plain(x, stream, cells, sc, velocity_only=not pres)]
        got = [torch.full_like(ref[0], float("nan"))]
        cm._launch_cells(mode, pres, x, None, stream, cells, sc, None, got[0], None)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    scale = max(float(b.abs().max()) for b in ref)
    assert err <= (1e-12 if dtype == torch.float64 else 1e-5) * scale


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_lattice_source_matches_plain_version(emulated, dtype):
    """K11: the kernel given no cell tables (null pointers) computes the
    addresses from the lattice and matches coupled_apply_plain, identity
    rows included (its epilogue is K1's)."""
    cells, u, p, s, _ = _box4(dtype)
    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    ref = cm.coupled_apply_plain(u, p, s, cells, sc)
    out_u, out_p = torch.zeros_like(u), torch.zeros_like(p)
    cm._launch_variant(cm.PH_ALL, (4, 4), u, p, s, cells, sc, None, out_u, out_p)
    cm._launch_epilogue(u, p, cells, out_u, out_p, True, None, None)
    assert joint_err((out_u, out_p), ref)[1] <= (1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_scatter_cells_matches_plain_version(emulated, dtype):
    """K6: the tiled scatter, given the lattice shape and no cell table, adds
    into nonzero outputs as index_add_ through the tables does."""
    cells, u, p, _, t = _box4(dtype)
    block = t(cells.n_cells, 89)
    ref = cm.scatter_cells_plain(block, cells, u.clone(), p.clone())
    out_u, out_p = u.clone(), p.clone()
    rc = cm.load_library().adaflo_scatter_cells(
        1 if dtype == torch.float64 else 0, block.data_ptr(), out_u.data_ptr(),
        out_p.data_ptr(), u.shape[1], 4, 4, 4, 0, None,
    )
    assert rc == 0
    assert joint_err((out_u, out_p), ref)[1] <= (1e-12 if dtype == torch.float64 else 1e-5)


def _lattice_cells(shape, periodic):
    """Q2/Q1 cells of an n_x x n_y x n_z lattice with the given periodic axes,
    their tables from LatticeOps and their lattice shape."""
    mesh = StructuredMesh(shape, (0.0,) * 3, (1.0, 1.3, 0.7))
    for axis, wraps in enumerate(periodic):
        if wraps:
            mesh.set_periodic(axis)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    return cm.CoupledCells(
        CellEvaluator(3, us.basis, 3, mesh.h, device="cpu"),
        CellEvaluator(3, ps.basis, 3, mesh.h, device="cpu"),
        LatticeOps.for_space(us).cell_dof_table(), LatticeOps.for_space(ps).cell_dof_table(),
        None, None, "cpu", lattice=(mesh.n_cells_axis, tuple(mesh.periodic)),
    )


# K6's tile is 8 x 4 x 4 cells: a box of one full tile's parity cells, an
# uneven lattice with partial tiles on every axis, the channel's periodic
# axes (x, z), every axis periodic, and lattices smaller than one tile
# (the all-periodic one wraps a tile onto itself)
SCATTER_LATTICES = [
    ((4, 4, 4), (False, False, False)),
    ((9, 5, 6), (False, False, False)),
    ((10, 3, 9), (True, False, True)),
    ((9, 6, 5), (True, True, True)),
    ((3, 2, 3), (False, False, False)),
    ((3, 2, 3), (True, True, True)),
]
SCATTER_IDS = ["x".join(map(str, s)) + "-" + "".join("p" if w else "n" for w in per)
               for s, per in SCATTER_LATTICES]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape,periodic", SCATTER_LATTICES, ids=SCATTER_IDS)
def test_emulated_scatter_tiles_match_plain_version(emulated, shape, periodic, dtype):
    """K6 on lattices that its tile does not divide, periodic ones and ones
    smaller than a tile, into nonzero outputs (n_u with padding)."""
    cells = _lattice_cells(shape, periodic)
    rng = np.random.default_rng(sum(shape))
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dtype)
    block = t(cells.n_cells, 89)
    u, p = t(3, cells.min_n_u + 5), t(cells.min_n_p + 3)
    ref = cm.scatter_cells_plain(block, cells, u.clone(), p.clone())
    got = (u.clone(), p.clone())
    cm._launch_scatter(block, cells, *got)
    assert joint_err(got, ref)[1] <= (1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("shape,periodic", SCATTER_LATTICES, ids=SCATTER_IDS)
def test_emulated_scatter_tiles_count_each_node_as_often_as_its_cells(emulated, shape, periodic):
    """A block of ones gives each node its multiplicity (the cells that
    touch it), as the plain version counts it: a face added twice or an
    interior node dropped changes a count."""
    cells = _lattice_cells(shape, periodic)
    block = torch.ones(cells.n_cells, 89, dtype=torch.float64)
    got = (torch.zeros(3, cells.min_n_u, dtype=torch.float64),
           torch.zeros(cells.min_n_p, dtype=torch.float64))
    cm._launch_scatter(block, cells, *got)
    ref = cm.scatter_cells_plain(block, cells, *(torch.zeros_like(g) for g in got))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert float(got[0].sum()) == 3 * 27 * cells.n_cells
    assert float(got[1].sum()) == 8 * cells.n_cells
    assert float(got[0].min()) >= 1 and float(got[1].min()) >= 1


TILE = (8, 4, 4)


def _tile_touches(shape, periodic):
    """Per tile of TILE cells, the nodes of its node box (Q2 velocity, 3
    components, and Q1 pressure) that another tile's box or a second node
    of its own box (a periodic wrap) also holds: the global atomics the
    tiled scatter must issue, counted from how often each lattice node is
    held, not from the kernel's face rule. Returns {tile: count}."""
    out = {}
    for deg, comps in ((2, 3), (1, 1)):
        nodes = [deg * n + (0 if w else 1) for n, w in zip(shape, periodic)]
        boxes = {}
        for tz in range(-(-shape[2] // TILE[2])):
            for ty in range(-(-shape[1] // TILE[1])):
                for tx in range(-(-shape[0] // TILE[0])):
                    axes = []
                    for a, t in enumerate((tx, ty, tz)):
                        c0 = t * TILE[a]
                        n = min(TILE[a], shape[a] - c0)
                        axes.append(np.arange(deg * c0, deg * (c0 + n) + 1) % nodes[a])
                    gz, gy, gx = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
                    boxes[(tx, ty, tz)] = ((gz * nodes[1] + gy) * nodes[0] + gx).ravel()
        held = np.bincount(np.concatenate(list(boxes.values())), minlength=int(np.prod(nodes)))
        for tile, ids in boxes.items():
            out[tile] = out.get(tile, 0) + comps * int(np.sum(held[ids] > 1))
    return out


@pytest.mark.parametrize("shape,periodic",
                         SCATTER_LATTICES + [((24, 12, 12), (False, False, False))],
                         ids=SCATTER_IDS + ["24x12x12-nnn"])
def test_emulated_scatter_tiles_use_atomics_only_where_tiles_meet(emulated, shape, periodic):
    """The tiled scatter issues one global atomicAdd per node that two tile
    boxes hold (or a periodic axis wraps onto its own box) and none for a
    node of one tile alone: the emulation runs one thread, so a plain
    read-add-write where tiles meet would still sum right there, and only
    this count shows it. A full tile with neighbours on every side takes
    1,926 velocity and 162 pressure atomics."""
    cells = _lattice_cells(shape, periodic)
    touches = _tile_touches(shape, periodic)
    if shape == (24, 12, 12):
        assert touches[(1, 1, 1)] == 1926 + 162
    block = torch.ones(cells.n_cells, 89, dtype=torch.float64)
    got = (torch.zeros(3, cells.min_n_u, dtype=torch.float64),
           torch.zeros(cells.min_n_p, dtype=torch.float64))
    before = emulated.adaflo_emu_atomics()
    cm._launch_scatter(block, cells, *got)
    assert emulated.adaflo_emu_atomics() - before == sum(touches.values())


def test_emulated_scatter_plan_and_lattice_checks(emulated):
    """K6's plan: 8 x 4 x 4 cell tiles, one block of 384 threads each (one a
    padded entry of a pass's 4 cells along x), the
    tile's 3 x 17 x 9 x 9 velocity and 9 x 5 x 5 pressure nodes (a value and
    an int32 destination each) and a slot table of a cell's 96 padded
    entries (int32) in shared memory; and the launch refuses a lattice shape
    that the tables do not number."""
    for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
        plan = cm.scatter_plan(dtype, (17, 9, 5))
        assert plan["tile"] == TILE and plan["threads"] == 4 * 96
        assert plan["smem"] == (3 * 17 * 9 * 9 + 9 * 5 * 5) * (size + 4) + 96 * 4
        assert plan["grid"] == 3 * 3 * 2 and plan["blocks_per_sm"] >= 1
    cells = _lattice_cells((3, 2, 3), (True, False, False))
    cells.lattice = ((3, 2, 3), (False, False, False))
    z = torch.zeros(3, cells.min_n_u + 20, dtype=torch.float64)
    with pytest.raises(ValueError, match="does not match"):
        cm._launch_scatter(torch.zeros(cells.n_cells, 89, dtype=torch.float64), cells, z,
                           torch.zeros(cells.min_n_p + 20, dtype=torch.float64))
