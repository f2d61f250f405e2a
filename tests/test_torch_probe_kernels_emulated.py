"""The CUDA source of the contraction-rate probes, run on the CPU.

`csrc/probe_kernels.cu` is compiled with g++ against the emulation header of
`tests/torch_emulation.py` (one thread per block) and driven through the
port's own ctypes packing (`ops/probe_kernels._launch_*`) on CPU tensors at
block 128 and 2 grid steps, against the plain versions: K7 (`row_fma`, every
n_ops, aligned and shifted, also at a block of 100 columns, whose last tile
is cut short, and its work items counted to write every output once), K8 (`row_copies`, exact), the float32 entries of
K9 and K5 (`dense_dot`, the SIMT product on its persistent grid with its TMA
ring: resident at every (m, k) over 2 and 3 steps, and streamed over 64
columns (one work item, fewer than the 2 emulated blocks), 256, 1,088 (17
items, an odd count) and 4,096) and K10 (`sf_eval`, every q row and the
zeroed pad rows); float64 1e-12 and float32 1e-5, max-abs error over
max-abs. The tensor-core entries (TF32, bf16, float64 DMMA) are inline PTX,
which the emulation leaves out: their emulated calls raise, and they meet
their plain versions only on the card, in chip_smoke.py phase 2. The dot's
layout arithmetic, plain C++ exported under ADAFLO_EMULATED, is held against
the PTX ISA's formulas: the 128-byte swizzle, the wgmma descriptor's fields,
the canonical K-major and MN-major layouts the descriptors address against
where the block puts A and where the TMA puts X, the float64 path's column
and k-slot permutations, and the blocks' work items. Skips where g++ is
missing."""

import ctypes

import numpy as np
import pytest
import torch

from adaflo_tpu_torch.ops import probe_kernels as pk
from torch_emulation import build_emulated

torch.set_num_threads(2)

BLOCK, NBLK = 128, 2
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = pk.bind(build_emulated("probe_kernels.cu", tmp_path_factory.mktemp("probe_emu")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk, "load_library", lambda: lib)
        mp.setattr(pk, "_stream", lambda device: 0)
        yield lib


def _randn(seed, *shape, dtype=torch.float64):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape), dtype=dtype)


def _rel(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    return float((got - ref).abs().max()) / float(ref.abs().max())


@DTYPES
@pytest.mark.parametrize("shifted", [False, True], ids=["aligned", "shifted"])
@pytest.mark.parametrize("n_ops", pk.N_OPS)
def test_emulated_row_fma_matches_plain_version(emulated, n_ops, shifted, dtype):
    x = _randn(7, 96, BLOCK + 128, dtype=dtype)
    out = torch.full((24, BLOCK), float("nan"), dtype=dtype)
    pk._launch_row_fma(x, out, n_ops, shifted, NBLK)
    assert _rel(out, pk.row_fma_plain(x, n_ops, shifted, NBLK)) <= TOL[dtype]


@DTYPES
@pytest.mark.parametrize("shifted", [False, True], ids=["aligned", "shifted"])
@pytest.mark.parametrize("n_ops", pk.N_OPS)
def test_emulated_row_fma_tail_tile_matches_plain_version(emulated, n_ops, shifted, dtype):
    """K7 at block 100, not a multiple of its 64-column tile: the last tile
    writes its 36 columns and skips the rest (the output's NaN fill would
    show a column left out, or a write past the block's)."""
    x = _randn(15, 96, 100 + 128, dtype=dtype)
    out = torch.full((24, 100), float("nan"), dtype=dtype)
    pk._launch_row_fma(x, out, n_ops, shifted, NBLK)
    assert _rel(out, pk.row_fma_plain(x, n_ops, shifted, NBLK)) <= TOL[dtype]
    assert pk.row_fma(x, n_ops, shifted, NBLK).shape == (24, 100)  # the wrapper takes it


@pytest.mark.parametrize("block", [64, 100, 128, 4096])
def test_emulated_row_fma_items_write_every_output_once(emulated, block):
    """K7's work items, (column, residue mod 8) over every column tile and
    thread of a block, write each of the (24, block) outputs of a step
    exactly once (through the kernel's own item loop, fma_items)."""
    fn = _emu(emulated, "adaflo_emu_fma_writes", None, ctypes.c_int, ctypes.c_void_p)
    counts = np.zeros((24, block), np.int32)
    fn(block, counts.ctypes.data)
    assert (counts == 1).all()


# (block, nblk, step groups) of the resident kernels' runs: the emulated
# card's 2 slots (groups None: 1 group, the blocks looping over the tiles at
# 256 columns), or slots set to groups x tiles (a group takes 4 steps at
# least): 13 steps in groups of 4, 4 and 5, and a block of one K8 tile (2
# K10 tiles float32, 4 float64) in groups of 4 and 5
RESIDENT_RUNS = pytest.mark.parametrize("block,nblk,groups", [
    (BLOCK, NBLK, None), (256, 3, None), (BLOCK, 13, 3), (64, 9, 2)])


@pytest.fixture
def slots(emulated):
    """set(n): K8's and K10's launches on n slots (the persistent grid's
    blocks at most) in place of the emulated query's 2; reset after the
    test."""
    fn = _emu(emulated, "adaflo_emu_set_slots", None, ctypes.c_longlong)
    yield fn
    fn(0)


def _set_groups(slots, name, dtype, block, groups, n_rows=89):
    """Slots for `groups` step groups of `name`'s tiles at `block` (None:
    the emulated query's)."""
    if groups is not None:
        slots(groups * block // pk.resident_plan(name, dtype, block, 1, n_rows)["tile_cols"])


@DTYPES
@RESIDENT_RUNS
@pytest.mark.parametrize("n_rows", pk.N_ROWS)
def test_emulated_row_copies_equal_plain_version(emulated, slots, n_rows, block, nblk, groups,
                                                 dtype):
    """K8's resident tile (a NaN fill would show an output left unwritten)
    on every kind of step group (RESIDENT_RUNS), exact."""
    _set_groups(slots, "row_copies", dtype, block, groups, n_rows)
    x = _randn(8, 32, block + 2560, dtype=dtype)
    out = torch.full((n_rows, block), float("nan"), dtype=dtype)
    pk._launch_row_copies(x, out, nblk)
    assert torch.equal(out, pk.row_copies_plain(x, n_rows, nblk))


@pytest.mark.parametrize("nblk", [NBLK, 3])
@pytest.mark.parametrize("m,k", pk.DOT_SHAPES)
def test_emulated_dense_dot_f32_matches_plain_version(emulated, m, k, nblk):
    A, x = _randn(9, m, k, dtype=torch.float32), _randn(10, k, BLOCK, dtype=torch.float32)
    out = torch.full((m, BLOCK), float("nan"))
    pk._launch_dense_dot(A, x, out, "f32", nblk, False)
    assert _rel(out, pk.dense_dot_plain(A, x, "f32", nblk)) <= 1e-5


@pytest.mark.parametrize("cols", [256, 64, 1088, 4096])
def test_emulated_streamed_dot_f32_matches_plain_version(emulated, cols):
    A, X = _randn(11, 384, 96, dtype=torch.float32), _randn(12, 96, cols, dtype=torch.float32)
    out = torch.full((384, cols), float("nan"))
    pk._launch_dense_dot(A, X, out, "f32", 1, True)
    assert _rel(out, pk.dense_dot_streamed_plain(A, X, "f32")) <= 1e-5


@pytest.mark.parametrize("precision", ["tf32", "bf16", "f64"])
def test_emulated_tensor_core_entries_raise(emulated, precision):
    """Left out of the emulated build: the C entry returns an error and the
    launch raises."""
    dtype = torch.float64 if precision == "f64" else torch.float32
    A, x = _randn(13, 96, 96, dtype=dtype), _randn(14, 96, BLOCK, dtype=dtype)
    with pytest.raises(RuntimeError, match=f"dense_dot\\[{precision}\\]"):
        pk._launch_dense_dot(A, x, torch.empty((96, BLOCK), dtype=dtype), precision, 1, False)


def _emu(lib, name, restype, *argtypes):
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = restype, list(argtypes)
    return fn


def _swizzle(addr):
    """PTX ISA's 128-byte swizzle of a shared-memory byte address (bits
    [4, 7) XOR bits [7, 10))."""
    return addr ^ (((addr >> 7) & 7) << 4)


def test_emulated_swizzle_is_the_ptx_128_byte_pattern(emulated):
    swz = _emu(emulated, "adaflo_emu_swz128", ctypes.c_int, ctypes.c_int, ctypes.c_int)
    assert all(swz(r, b) == _swizzle(128 * r + b) for r in range(384) for b in range(128))


def test_emulated_wgmma_descriptor_fields(emulated):
    """Start address >> 4 in bits [0, 14), leading byte offset >> 4 in
    [16, 30), stride byte offset >> 4 in [32, 46), base offset 0, 128-byte
    swizzle (1) in bits [62, 64)."""
    desc = _emu(emulated, "adaflo_emu_wgmma_desc", ctypes.c_ulonglong, ctypes.c_uint,
                ctypes.c_uint, ctypes.c_uint)
    for addr, lbo, sbo in ((0, 16, 1024), (0x2A400, 12288, 1024), (0x3FFF0, 4096, 1024)):
        d = desc(addr, lbo, sbo)
        assert d & 0x3FFF == addr >> 4
        assert (d >> 16) & 0x3FFF == lbo >> 4
        assert (d >> 32) & 0x3FFF == sbo >> 4
        assert (d >> 49) & 7 == 0 and d >> 62 == 1
        assert d & ~((0x3FFF) | (0x3FFF << 16) | (0x3FFF << 32) | (3 << 62)) == 0


@pytest.mark.parametrize("AS", [2, 4], ids=["bf16", "tf32"])
@pytest.mark.parametrize("m,k", pk.DOT_SHAPES)
def test_emulated_wgmma_b_operand_addresses_the_resident_a(emulated, m, k, AS):
    """The B operand (A^T, K-major, 128-byte swizzle) of every n48 chunk and
    k-step: PTX's canonical layout, element (n, kk) at start + (n // 8) SBO
    + (n % 8) 128 + kk AS, swizzled, is where the block stored
    A[n0 + 48 q + n][32 ks / AS + kk]."""
    a_off = _emu(emulated, "adaflo_emu_mma_a_offset", ctypes.c_int, *[ctypes.c_int] * 4)
    b_start = _emu(emulated, "adaflo_emu_mma_b_start", ctypes.c_uint, *[ctypes.c_int] * 4)
    per = 32 // AS  # k of one 32-byte k-step (k16 bf16, k8 TF32)
    for n0 in (0, m // 2):
        for q in range(m // 96):
            for ks in range(k // per):
                start = b_start(n0, q, ks, m)
                for n in range(48):
                    for kk in range(per):
                        nominal = start + (n // 8) * 1024 + (n % 8) * 128 + kk * AS
                        assert _swizzle(nominal) == a_off(n0 + 48 * q + n, per * ks + kk, m, AS)


@pytest.mark.parametrize("k", [96, 32])
def test_emulated_wgmma_a_operand_addresses_the_tma_stage(emulated, k):
    """K5 bf16's A operand (X^T, MN-major, 128-byte swizzle): PTX's canonical
    layout, element (m', kk) at start + (kk // 8) SBO + m' 2 (m' < 64, one
    swizzle atom wide), swizzled, is where the TMA box put X[16 ks + kk][m']
    (row 16 ks + kk, byte 2 m', swizzled)."""
    x_start = _emu(emulated, "adaflo_emu_mma_x_start", ctypes.c_uint, ctypes.c_int)
    for ks in range(k // 16):
        for kk in range(16):
            for mp in range(64):
                nominal = x_start(ks) + (kk // 8) * 1024 + (kk % 8) * 128 + 2 * mp
                assert _swizzle(nominal) == _swizzle(128 * (16 * ks + kk) + 2 * mp)


def test_emulated_f64_permutations_load_conflict_free_and_store_sectors(emulated):
    """The float64 path's column permutation f64_col(n, j) (32 columns) and
    k-slot permutation (slot t: k 2t, slot t + 4: k 2t + 1): bijections; a
    lane's columns of subtiles j, j + 1 (j even) consecutive and 16-byte
    aligned; a thread's accumulators n = 2t, 2t + 1 of subtiles j, j + 1 one
    aligned group of 4 columns (16-byte staging stores); and each LDS.128 of a
    quarter-warp (lanes 4 g + t, g in {2p, 2p + 1}) on 8 distinct 16-byte
    units of the swizzled rows: conflict-free."""
    col = _emu(emulated, "adaflo_emu_f64_col", ctypes.c_int, ctypes.c_int, ctypes.c_int)
    kslot = _emu(emulated, "adaflo_emu_f64_kslot", ctypes.c_int, ctypes.c_int)
    assert sorted(kslot(s) for s in range(8)) == list(range(8))
    assert [kslot(t) for t in range(4)] == [0, 2, 4, 6] and kslot(4) == 1
    assert sorted(col(n, j) for n in range(8) for j in range(4)) == list(range(32))
    for n in range(8):
        for j in (0, 2):
            assert col(n, j + 1) == col(n, j) + 1 and col(n, j) % 2 == 0
    for t in range(4):
        for j in (0, 2):
            cols = sorted(col(2 * t + e, j + i) for e in (0, 1) for i in (0, 1))
            assert cols == list(range(cols[0], cols[0] + 4)) and cols[0] % 4 == 0
    for ks in range(12):
        for slot_base in (0, 4):  # the b0 (slot t) and b1 (slot t + 4) loads
            for j in (0, 2):
                for p in range(4):
                    units = set()
                    for g in (2 * p, 2 * p + 1):
                        for t in range(4):
                            row = 8 * ks + kslot(slot_base + t)
                            c = col(g, j)
                            units.add((_swizzle(128 * row + (c % 16) * 8) % 128) // 16)
                    assert len(units) == 8


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("grid,items", [(132, 1728), (132, 3712), (2, 1), (6, 17), (264, 5)])
def test_emulated_blocks_cover_every_work_item_once(emulated, grid, items, parts):
    """Every part's items, each once, over the blocks of that part (block b:
    part b % parts); the launch makes the grid a multiple of the parts."""
    fn = _emu(emulated, "adaflo_emu_dot_items", ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)
    grid = parts * max(1, min(items, grid // parts))
    buf = np.zeros(items + 1, np.int64)
    seen = {p: [] for p in range(parts)}
    for b in range(grid):
        n = fn(b, grid, parts, items, buf.ctypes.data)
        seen[b % parts] += buf[:n].tolist()
    assert all(sorted(v) == list(range(items)) for v in seen.values())


def test_emulated_dot_plan_reports_the_launch(emulated):
    """The float32 instances' plan on the emulated card (1 block per SM):
    288 threads, 64-column items, one part, 2-4 stages, within the 232,448 B
    a block may use; the tensor-core instances are not in the emulated
    build."""
    for m, k in pk.DOT_SHAPES:
        plan = pk.dot_plan("f32", m, k, streamed=False)
        assert plan["threads"] == 288 and plan["tile_cols"] == 64 and plan["parts"] == 1
        assert 2 <= plan["stages"] <= 4 and plan["smem"] <= 232448
        assert plan["blocks_per_sm"] == 1
    assert pk.dot_plan("f32", 384, 96, False)["smem"] == 222256
    with pytest.raises(RuntimeError, match=r"dense_dot\[tf32\] plan"):
        pk.dot_plan("tf32", 384, 96, False)


@DTYPES
@RESIDENT_RUNS
def test_emulated_sf_eval_matches_plain_version(emulated, slots, block, nblk, groups, dtype):
    """Every q row of the three stages, and the pad rows q = 27..31 zero, on
    every kind of step group (RESIDENT_RUNS) at each type's tile (32
    columns float32, 16 float64)."""
    _set_groups(slots, "sf_eval", dtype, block, groups)
    x = _randn(15, 32, block + 2560, dtype=dtype)
    coeffs = ((0.3, 0.5, 0.2), (0.25, 0.6, 0.15), (0.1, 0.7, 0.2)), ((-1.0, 0.0, 1.0),
                                                                   (-0.5, 0.1, 0.4),
                                                                   (-0.8, -0.2, 1.0))
    out = torch.full((384, block), float("nan"), dtype=dtype)
    pk._launch_sf_eval(x, out, nblk, coeffs)
    ref = pk.sf_eval_plain(x, nblk, coeffs)
    assert _rel(out, ref) <= TOL[dtype]
    pad = out.reshape(12, 32, block)[:, 27:]
    assert torch.equal(pad, torch.zeros_like(pad))


@DTYPES
@pytest.mark.parametrize("block,nblk,n_slots", [
    (64, 9, 2), (256, 3, None), (4096, 29, 6 * 132), (2048, 58, 3 * 132), (2048, 13, 3 * 132)])
@pytest.mark.parametrize("name,n_rows", [("row_copies", 29), ("row_copies", 89), ("sf_eval", 0)])
def test_emulated_resident_items_run_every_step_once(emulated, slots, name, n_rows, block, nblk,
                                                     n_slots, dtype):
    """K8's and K10's work items (tile, step group) over the blocks of their
    persistent grid run every step of every tile exactly once, and a step's
    items over the threads of a block write every element of the output
    tile exactly once (K10's pad rows, zeroed once a block, included); on
    the emulated query's 2 slots and on a card's 132 SMs x 3 or 6 resident
    blocks. The plan reports at most as many blocks as slots and items."""
    if n_slots is not None:
        slots(n_slots)
    plan = pk.resident_plan(name, dtype, block, nblk, n_rows or 89)
    assert plan["slots"] == (n_slots or 2) and plan["groups"] <= nblk
    assert plan["grid"] == min(plan["slots"], plan["items"])
    assert plan["items"] == plan["groups"] * block // plan["tile_cols"]
    rows = n_rows or 384
    fn = _emu(emulated, "adaflo_emu_resident_work", ctypes.c_int, *[ctypes.c_int] * 5,
              ctypes.c_void_p, ctypes.c_void_p)
    runs = np.zeros((block // plan["tile_cols"], nblk), np.int32)
    writes = np.zeros((rows, plan["tile_cols"]), np.int32)
    kernel = pk.RESIDENT.index(name)
    assert fn(kernel, int(dtype == torch.float64), n_rows, block, nblk, runs.ctypes.data,
              writes.ctypes.data) == 0
    assert (runs == 1).all() and (writes == 1).all()
