"""The probes of the coupled cell apply (K6, K11, K12, K13) against the JAX
package's probe kernels and lattice scatter, on the CPU.

- The plain versions of K13's full, datapath and mdot ablations and of K12's
  full apply against the JAX probe kernel bodies (``make_kernel`` of
  ``scripts/probe_pr_parts.py``, ``_kernel_ablate`` of
  ``scripts/probe_pr_phases.py``) and K11's against ``make_kernel_grouped``
  (``scripts/probe_pr_grouped.py``), each run in TPU interpret mode on a 4^3
  box with 128-wide blocks, its packed parity output unpacked with
  ``NavierStokesOperator.pr_unpack``. The tolerances follow each probe's
  arithmetic: K13 runs in float64 (1e-12); K12 runs in float32 as its script
  does (1e-6); K11's dots accumulate in float32 whatever the input (1e-6).
  K13 and K11 round the u* stream to bf16 as their scripts do, and the port
  is given the same rounded u*.
- K13's TPU schedules (``make_kernel_rowdma``, ``make_kernel_pipe``,
  ``make_kernel_unroll2``, with ``run_variant``'s scratch shapes) at 8^3
  with 128-wide blocks (6 grid steps, so the prefetch slots and unroll2's 3
  steps run) against full's plain version, which is each schedule's: rowdma
  in float64 to 1e-12; pipe, which reads scratch rows it never writes
  (ROADMAP F12), with uninitialized memory read as zero, to 1e-12, and with
  the default NaN fill it returns NaN (at 4^3); unroll2, whose dots return float32
  (F14), to 1e-7; and at 6^3 (3 blocks) unroll2's grid of one step leaves
  the last block unwritten (F13), while the port's output covers it.
- ``scatter_cells_plain`` (K6) against the JAX ``LatticeOps.scatter_add``
  (1e-13; also on periodic lattices), K6's wrapped lattice addresses
  against the JAX lattice's cell -> dof map, K6's bound counted by hand and
  its argument checks' order, and K11's lattice addresses against
  ``cell_dof_table()``.
- The probe drivers: CUDA needed unless ``--device cpu``, their CPU runs, and
  no import of JAX, the JAX package or ``scripts/``.

The JAX probe modules set ADAFLO_* variables when imported; they are loaded
with the environment restored afterwards, and ADAFLO_PALLAS_MATVEC=1 is set
only while the JAX operator that reads it is built. No variable-coefficient
JAX apply is built.
"""

import functools
import importlib.util
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from adaflo_tpu.fe.constraints import Constraints as JConstraints
from adaflo_tpu.fe.space import ScalarSpace as JScalarSpace
from adaflo_tpu.mesh.structured import StructuredMesh as JStructuredMesh
from adaflo_tpu.ops import pallas_matvec as jpm
from adaflo_tpu.ops.lattice import LatticeOps as JLatticeOps
from adaflo_tpu.ops.navier_stokes import NavierStokesOperator as JOperator
from adaflo_tpu.parameters import FlowParameters as JFlowParameters
from adaflo_tpu_torch.fe.space import ScalarSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops.lattice import LatticeOps
from adaflo_tpu_torch.ops.tensor import CellEvaluator

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PROBE_ENV = ("ADAFLO_BENCH", "ADAFLO_TPU_NO_X64", "ADAFLO_PALLAS_MATVEC",
             "ADAFLO_PALLAS_PR_BLOCK")
SC = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
BLOCK = 128


@pytest.fixture(scope="module")
def jax_probes():
    """The three JAX probe modules, imported from their files without the
    PROBE_ENV variables and with the environment restored exactly
    afterwards: the modules set some of those variables when imported
    (probe_pr_phases sets ADAFLO_PALLAS_MATVEC=1), which would otherwise
    stay set for the JAX tests that the same worker runs next."""
    mods = {}
    saved = dict(os.environ)
    try:
        for k in PROBE_ENV:
            os.environ.pop(k, None)
        for name in ("probe_pr_phases", "probe_pr_parts", "probe_pr_grouped"):
            spec = importlib.util.spec_from_file_location(
                f"jax_{name}", ROOT / "scripts" / f"{name}.py"
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mods


def _jax_scalars():
    """combine_linear's (rho_w, tau1_rho, beta, mut, tgd) for SC."""
    return (SC.rho * SC.weight - SC.damping, SC.tau1 * SC.rho, SC.beta,
            SC.tau1 * SC.mu, SC.tau_grad_div)


@pytest.fixture(scope="module")
def case():
    """The probes' box at 4^3 (_probe_box)."""
    return _probe_box(4)


@functools.lru_cache(maxsize=None)
def _probe_box(n: int):
    """The probes' box (unit cube, no constraints) at n^3, Q2/Q1: the JAX
    operator with its Pallas tables and the port's cell tables, and nodal
    u, p, u* from a numpy seed."""
    par = JFlowParameters.from_string(
        "subsection Navier-Stokes\n  set dimension = 3\n  set velocity degree = 2\nend\n"
    )
    jmesh = JStructuredMesh((n,) * 3, (0.0,) * 3, (1.0,) * 3)
    jus, jps = JScalarSpace(jmesh, 2), JScalarSpace(jmesh, 1)
    cu = [JConstraints(jus.n_dofs) for _ in range(3)]
    cp = JConstraints(jps.n_dofs)
    for c in cu + [cp]:
        c.close()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFLO_PALLAS_MATVEC", "1")
        op = JOperator(par, jus, jps, cu, cp, dtype=jnp.float64)
    assert op._pallas_tables is not None
    mesh = StructuredMesh((n,) * 3, (0.0,) * 3, (1.0,) * 3)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    cells = cm.CoupledCells(
        CellEvaluator(3, us.basis, 3, mesh.h, device="cpu"),
        CellEvaluator(3, ps.basis, 3, mesh.h, device="cpu"),
        LatticeOps.for_space(us).cell_dof_table(), LatticeOps.for_space(ps).cell_dof_table(),
        None, None, "cpu", lattice=(mesh.n_cells_axis, tuple(mesh.periodic)),
    )
    rng = np.random.default_rng(4)
    u = rng.standard_normal((3, us.n_dofs))
    p = rng.standard_normal(ps.n_dofs)
    s = rng.standard_normal((3, us.n_dofs))
    return types.SimpleNamespace(op=op, cells=cells, u=u, p=p, s=s)


def _geometry(op):
    rows_table = op._pr_rows_table()
    EA = op.lat_u.n_anchors
    block, EA_pad, win, L_need = jpm.pr_params(rows_table, EA, BLOCK)
    return rows_table, EA, block, EA_pad, win, L_need


def _jax_inputs(c, dtype, stream_dtype):
    """Packed (u, p), the u* dof stream on the anchor raster (rounded
    through stream_dtype), the phantom mask, and the port's u* with the same
    rounding."""
    op = c.op
    rows_table, EA, block, EA_pad, win, L_need = _geometry(op)
    x0 = op.pr_pack(jnp.asarray(c.u, dtype), jnp.asarray(c.p, dtype))
    xin = jnp.pad(x0, ((0, 0), (0, max(0, L_need - x0.shape[1]))))
    ld = op._gather_u(jnp.asarray(c.s), resolve=False)
    st = op.lat_u.cells_to_anchors(jpm.qdofs_t(types.SimpleNamespace(dofs=ld), stream_dtype))
    st = jnp.pad(st, ((0, 0), (0, EA_pad - st.shape[-1]))).astype(dtype)
    mask = jnp.pad(op.lat_u.anchor_mask_dev(dtype).reshape(1, -1), ((0, 0), (0, EA_pad - EA)))
    s_port = np.asarray(jnp.asarray(c.s, stream_dtype).astype(jnp.float64))
    return xin, st, mask, s_port


def _unpack(op, out):
    u, p = op.pr_unpack(out)
    return np.asarray(u, np.float64), np.asarray(p, np.float64)


def _rel(got, ref):
    err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(got, ref))
    return err / max(float(np.abs(np.asarray(b)).max()) for b in ref)


def _port(c, variant, dtype, u, p, s):
    t = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=dtype)
    if variant == "lattice":
        out = cm.coupled_apply_lattice(t(u), t(p), t(s), c.cells, SC)
    else:
        out = cm.coupled_apply_ablated_plain(t(u), t(p), t(s), c.cells, SC, variant)
    return [o.numpy().astype(np.float64) for o in out]


def _interpreted(kernel, params=None, **kw):
    """pl.pallas_call in TPU interpret mode (the mode is read when the call
    is built and traced), with its parameters `params` (default: the
    defaults, uninitialized memory read as NaN)."""
    params = pltpu.InterpretParams() if params is None else params
    with pltpu.force_tpu_interpret_mode(params):
        call = pl.pallas_call(kernel, **kw)

    def run(*args):
        with pltpu.force_tpu_interpret_mode(params):
            return call(*args)

    return run


def _rep(shape):
    return pl.BlockSpec(shape, lambda i: (0, 0), memory_space=pltpu.VMEM)


@pytest.mark.parametrize("parts", ["full", "datapath", "mdot"])
def test_k13_plain_matches_jax_probe_kernel(jax_probes, case, parts):
    """K13 (probe_pr_parts.make_kernel) in float64, the u* stream through
    bf16 as run_variant rounds it: the port's plain ablation agrees to
    1e-12."""
    out, s_port, _ = _k13_out(jax_probes, case, parts, "nan")
    ref = _unpack(case.op, out)
    got = _port(case, parts, torch.float64, case.u, case.p, s_port)
    assert _rel(got, ref) <= 1e-12


def _k13_out(jax_probes, c, parts, memory):
    """K13's kernel for `parts` (an ablation of make_kernel, or a TPU
    schedule: rowdma, pipe, unroll2) of scripts/probe_pr_parts.py in TPU
    interpret mode, float64, u* through bf16, built as run_variant
    (:363-416) builds it: its scratch shapes, pipe's rows and matrices
    padded to 96, unroll2's two blocks per grid step. memory: interpret
    mode's uninitialized_memory. Returns the packed output, the port's u*
    and (block, EA_pad)."""
    op, dtype = c.op, jnp.float64
    tables = op._pallas_tables
    rows_table, EA, block, EA_pad, win, L_need = _geometry(op)
    xin, st, mask, s_port = _jax_inputs(c, dtype, jnp.bfloat16)
    g, dim = tables.g, tables.dim
    n_su, n_cols, R_pad = dim * tables.n_u_loc, len(rows_table), xin.shape[0]
    Ae = jnp.asarray(tables.A_evg, dtype)
    M89, A_ics, beta = jpm.combine_linear(tables, _jax_scalars(), dtype)
    vm = lambda *shape: pltpu.VMEM(shape, dtype)
    probe = jax_probes["probe_pr_parts"]
    make = getattr(probe, f"make_kernel_{parts}", probe.make_kernel)
    kern = make(g, dim, tuple(rows_table), win, block, parts)
    sem = pltpu.SemaphoreType.DMA((2,))
    scratch = {
        "rowdma": [vm(2, n_cols, block), vm(dim * g, block), vm(R_pad, win), sem],
        "pipe": [vm(2, R_pad, win), vm(2, -(-n_cols // 8) * 8, block), vm(dim * g, block),
                 vm(R_pad, win), sem],
        "unroll2": [vm(2, R_pad, 2 * block + (win - block)), vm(n_cols, block),
                    vm(n_cols, block), vm(dim * g, block), vm(dim * g, block), vm(R_pad, win),
                    sem],
    }.get(parts, [vm(2, R_pad, win), vm(n_cols, block), vm(dim * g, block), vm(R_pad, win),
                  sem])
    bmul = 2 if parts == "unroll2" else 1
    nc_k = -(-n_cols // 8) * 8 if parts == "pipe" else n_cols
    Ae_k = jnp.pad(Ae, ((0, 0), (0, nc_k - n_cols)))
    M_k = jnp.pad(M89, ((0, nc_k - n_cols), (0, nc_k - n_cols)))
    Ai_k = jnp.pad(A_ics, ((0, nc_k - n_cols), (0, 0)))
    call = _interpreted(
        kern, pltpu.InterpretParams(uninitialized_memory=memory),
        grid=(EA_pad // (bmul * block),),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,), memory_space=pltpu.SMEM),
            _rep((Ae.shape[0], nc_k)), _rep((Ae.shape[0], n_su)),
            _rep((nc_k, nc_k)), _rep((nc_k, dim * g)),
            pl.BlockSpec((1, bmul * block), lambda i: (0, i), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec((n_su, bmul * block), lambda i: (0, i), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((R_pad, bmul * block), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R_pad, EA_pad), dtype),
        scratch_shapes=scratch,
    )
    out = call(beta[None], Ae_k, Ae[:, :n_su], M_k, Ai_k, mask, xin, st)
    return np.asarray(out), s_port, (block, EA_pad)


# (schedule, cells per axis, uninitialized memory, check): the schedule
# against the port to its tolerance, or the reference's fault it shows
SCHEDULE_CASES = [
    ("rowdma", 8, "nan", "equal"),
    ("pipe", 8, "zero", "equal"),
    ("unroll2", 8, "nan", "equal"),
    ("pipe", 4, "nan", "F12"),
    ("unroll2", 6, "nan", "F13"),
]
SCHEDULE_TOL = {"rowdma": 1e-12, "pipe": 1e-12, "unroll2": 1e-7}  # unroll2: F14


@pytest.mark.parametrize("parts,n,memory,check", SCHEDULE_CASES,
                         ids=[f"{p}-{n}-{m}-{c}" for p, n, m, c in SCHEDULE_CASES])
def test_k13_schedule_matches_jax_probe_kernel(jax_probes, parts, n, memory, check):
    """K13's TPU schedules compute full's output, so the port's plain
    version of each (coupled_apply_ablated_plain, full's) is held against
    them: rowdma in float64 to 1e-12 (0.0 found); pipe to 1e-12 once its
    never-written scratch rows 89-95 read as zero, and NaN with the default
    NaN fill (F12, on the 4^3 box: the dots multiply those rows by the zero
    columns of the padded matrices); unroll2 to 1e-7, its dots returning float32 (F14,
    3.5e-9 found). At 6^3 the 343 anchors make 3 blocks of 128 and unroll2's
    grid EA_pad // 256 one step, so the last block of the output is never
    written (F13), while the port's output covers every cell."""
    c = _probe_box(n)
    out, s_port, (block, EA_pad) = _k13_out(jax_probes, c, parts, memory)
    got = _port(c, parts, torch.float64, c.u, c.p, s_port)
    if check == "equal":
        assert _rel(got, _unpack(c.op, out)) <= SCHEDULE_TOL[parts]
    elif check == "F12":
        assert np.isnan(out).any()
    else:  # F13
        n_blocks, steps = EA_pad // block, EA_pad // (2 * block)
        assert (n_blocks, steps) == (3, 1)
        packed = np.asarray(c.op.pr_pack(jnp.asarray(got[0]), jnp.asarray(got[1])))
        done = slice(0, 2 * block)
        last = slice(2 * block, EA_pad)
        scale = np.abs(packed).max()
        assert np.abs(out[:, done] - packed[: out.shape[0], done]).max() <= 1e-7 * scale
        assert np.isnan(out[:, last]).all()  # never written
        assert np.abs(packed[:, last]).max() > 0.1 * scale


def test_k12_plain_full_matches_jax_probe_kernel(jax_probes, case):
    """K12's full apply (probe_pr_phases._kernel_ablate with every phase)
    in float32 as its script runs it: the port's plain version, given the
    same float32 inputs, agrees to 1e-6."""
    op, dtype = case.op, jnp.float32
    tables = op._pallas_tables
    rows_table, EA, block, EA_pad, win, L_need = _geometry(op)
    xin, st, mask, s_port = _jax_inputs(case, dtype, jnp.float32)
    g, dim = tables.g, tables.dim
    n_su, n_cols, R_pad = dim * tables.n_u_loc, len(rows_table), xin.shape[0]
    Ae = jnp.asarray(tables.A_evg, dtype)
    M89, A_ics, beta = jpm.combine_linear(tables, _jax_scalars(), dtype)
    flags = frozenset(["gather", "rdot", "sdot", "vpu", "outdots", "scatter"])
    kern = lambda *refs: jax_probes["probe_pr_phases"]._kernel_ablate(
        g, dim, tuple(rows_table), win, block, flags, *refs
    )
    call = _interpreted(
        kern,
        grid=(EA_pad // block,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,), memory_space=pltpu.SMEM),
            _rep((Ae.shape[0], n_cols)), _rep((Ae.shape[0], n_su)),
            _rep((n_cols, n_cols)), _rep((n_cols, dim * g)),
            pl.BlockSpec((1, block), lambda i: (0, i), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec((n_su, block), lambda i: (0, i), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((R_pad, block), lambda i: (0, i), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R_pad, EA_pad), dtype),
        scratch_shapes=[
            pltpu.VMEM((2, R_pad, win), dtype), pltpu.VMEM((n_cols, block), dtype),
            pltpu.VMEM((dim * g, block), dtype), pltpu.VMEM((R_pad, win), dtype),
            pltpu.SemaphoreType.DMA((2,)),
        ],
    )
    out = call(beta[None], Ae, Ae[:, :n_su], M89, A_ics, mask, xin, st)
    ref = _unpack(op, out)
    f32 = lambda a: np.asarray(a, np.float32)
    got = _port(case, "full", torch.float64, f32(case.u), f32(case.p), s_port)
    assert _rel(got, ref) <= 1e-6


def test_k11_matches_jax_grouped_probe_kernel(jax_probes, case):
    """K11 (probe_pr_grouped.make_kernel_grouped, float32 dots) against the
    port's K11 entry on the CPU (coupled_apply_plain), the u* stream
    through bf16 as the script rounds it: agreement to 1e-6 (2.5e-7 found)."""
    op, dtype = case.op, jnp.float32
    tables = op._pallas_tables
    rows_table, EA, block, EA_pad, win, L_need = _geometry(op)
    xin, st, mask, s_port = _jax_inputs(case, dtype, jnp.bfloat16)
    g, dim = tables.g, tables.dim
    n_su, n_cols, R_pad = dim * tables.n_u_loc, len(rows_table), xin.shape[0]
    Ae = np.asarray(tables.A_evg, np.float32)
    M89, A_ics, beta = jpm.combine_linear(tables, _jax_scalars(), dtype)
    offsets = sorted({off for _, off in rows_table})
    K = len(offsets) * R_pad
    G = np.zeros((n_cols, K), np.float32)
    for k, (srow, off) in enumerate(rows_table):
        G[k, offsets.index(off) * R_pad + srow] = 1.0
    kern = jax_probes["probe_pr_grouped"].make_kernel_grouped(
        g, dim, tuple(offsets), win, block, R_pad, False
    )
    call = _interpreted(
        kern,
        grid=(EA_pad // block,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,), memory_space=pltpu.SMEM),
            _rep((Ae.shape[0], K)), _rep((Ae.shape[0], n_su)), _rep((n_cols, K)),
            _rep((n_cols, dim * g)), _rep((K, n_cols)),
            pl.BlockSpec((1, block), lambda i: (0, i), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec((n_su, block), lambda i: (0, i), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((R_pad, block), lambda i: (0, i), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R_pad, EA_pad), dtype),
        scratch_shapes=[
            pltpu.VMEM((2, R_pad, win), dtype), pltpu.VMEM((K, block), dtype),
            pltpu.VMEM((dim * g, block), dtype), pltpu.VMEM((n_cols, block), dtype),
            pltpu.VMEM((R_pad, win), dtype), pltpu.SemaphoreType.DMA((2,)),
        ],
    )
    out = call(beta[None], jnp.asarray(Ae @ G), jnp.asarray(Ae[:, :n_su]),
                   jnp.asarray(np.asarray(M89) @ G), A_ics, jnp.asarray(G.T.copy()),
                   mask, xin, st)
    ref = _unpack(op, out)
    f32 = lambda a: np.asarray(a, np.float32)
    got = _port(case, "lattice", torch.float64, f32(case.u), f32(case.p), s_port)
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("shape", [(4, 4, 4), (3, 2, 5)])
def test_scatter_cells_plain_matches_jax_scatter_add(shape):
    """K6's plain version adds the (E, 89) block as the JAX lattice
    scatter_add does, component by component and the pressure."""
    mesh, jmesh = StructuredMesh(shape, (0.0,) * 3, (1.0,) * 3), JStructuredMesh(
        shape, (0.0,) * 3, (1.0,) * 3
    )
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    cells = cm.CoupledCells(
        CellEvaluator(3, us.basis, 3, mesh.h, device="cpu"),
        CellEvaluator(3, ps.basis, 3, mesh.h, device="cpu"),
        LatticeOps.for_space(us).cell_dof_table(), LatticeOps.for_space(ps).cell_dof_table(),
        None, None, "cpu",
    )
    block = np.random.default_rng(6).standard_normal((cells.n_cells, 89))
    out_u, out_p = cm.scatter_cells(
        torch.as_tensor(block), cells, torch.zeros(3, us.n_dofs, dtype=torch.float64),
        torch.zeros(ps.n_dofs, dtype=torch.float64),
    )
    jlu = JLatticeOps.for_space(JScalarSpace(jmesh, 2))
    jlp = JLatticeOps.for_space(JScalarSpace(jmesh, 1))
    ref_u = [np.asarray(jlu.scatter_add(jnp.asarray(block[:, 27 * c : 27 * (c + 1)])))
             for c in range(3)]
    ref_p = np.asarray(jlp.scatter_add(jnp.asarray(block[:, 81:])))
    assert _rel([out_u.numpy(), out_p.numpy()], [np.stack(ref_u)[:, : us.n_dofs],
                                                 ref_p[: ps.n_dofs]]) <= 1e-13


@pytest.mark.parametrize("degree", [2, 1], ids=["q2", "q1"])
@pytest.mark.parametrize("shape", [(4, 4, 4), (3, 2, 5), (1, 1, 1)])
def test_lattice_addresses_equal_cell_dof_table(shape, degree):
    """K11's addresses (lattice_dof in the kernel, lattice_cell_dofs here)
    are the cell table on every cell: the port numbers the lattice's dofs
    lexicographically, x fastest."""
    space = ScalarSpace(StructuredMesh(shape, (0.0,) * 3, (1.0,) * 3), degree)
    np.testing.assert_array_equal(
        cm.lattice_cell_dofs(shape, degree), LatticeOps.for_space(space).cell_dof_table()
    )


PERIODIC_LATTICES = [((4, 3, 5), (True, False, True)), ((3, 2, 4), (True, True, True)),
                     ((2, 3, 1), (False, True, False))]
PERIODIC_IDS = ["x".join(map(str, s)) + "-" + "".join("p" if w else "n" for w in per)
                for s, per in PERIODIC_LATTICES]


def _jax_periodic_space(shape, periodic, degree):
    mesh = JStructuredMesh(shape, (0.0,) * 3, (1.0,) * 3)
    for axis, wraps in enumerate(periodic):
        if wraps:
            mesh.set_periodic(axis)
    return JScalarSpace(mesh, degree)


@pytest.mark.parametrize("degree", [2, 1], ids=["q2", "q1"])
@pytest.mark.parametrize("shape,periodic", PERIODIC_LATTICES, ids=PERIODIC_IDS)
def test_periodic_lattice_addresses_equal_jax_cell_dofs(shape, periodic, degree):
    """K6's wrapped addresses (lattice_cell_dofs with the periodic axes) are
    the JAX lattice's cell -> dof map (its gather of the dof numbers) and
    the JAX space's cell_dofs: node degree n_c of a periodic axis is node 0."""
    space = _jax_periodic_space(shape, periodic, degree)
    jlat = JLatticeOps.for_space(space)
    jtable = np.asarray(jlat.gather(jnp.arange(space.n_dofs, dtype=jnp.int32)))
    got = cm.lattice_cell_dofs(shape, degree, periodic)
    np.testing.assert_array_equal(got, jtable)
    np.testing.assert_array_equal(got, space.cell_dofs)


@pytest.mark.parametrize("shape,periodic", PERIODIC_LATTICES, ids=PERIODIC_IDS)
def test_scatter_cells_matches_jax_scatter_add_on_periodic_lattices(shape, periodic):
    """scatter_cells on the CPU (its plain version) adds the (E, 89) block
    as the JAX lattice scatter_add does on a periodic lattice, into nonzero
    outputs."""
    mesh = StructuredMesh(shape, (0.0,) * 3, (1.0,) * 3)
    for axis, wraps in enumerate(periodic):
        if wraps:
            mesh.set_periodic(axis)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    cells = cm.CoupledCells(
        CellEvaluator(3, us.basis, 3, mesh.h, device="cpu"),
        CellEvaluator(3, ps.basis, 3, mesh.h, device="cpu"),
        LatticeOps.for_space(us).cell_dof_table(), LatticeOps.for_space(ps).cell_dof_table(),
        None, None, "cpu", lattice=(mesh.n_cells_axis, tuple(mesh.periodic)),
    )
    rng = np.random.default_rng(len(shape) + sum(shape))
    block = rng.standard_normal((cells.n_cells, 89))
    u0, p0 = rng.standard_normal((3, us.n_dofs)), rng.standard_normal(ps.n_dofs)
    out_u, out_p = cm.scatter_cells(torch.as_tensor(block), cells, torch.as_tensor(u0.copy()),
                                    torch.as_tensor(p0.copy()))
    jlu = JLatticeOps.for_space(_jax_periodic_space(shape, periodic, 2))
    jlp = JLatticeOps.for_space(_jax_periodic_space(shape, periodic, 1))
    ref_u = u0 + np.stack([np.asarray(jlu.scatter_add(jnp.asarray(block[:, 27 * c : 27 * (c + 1)])))
                           for c in range(3)])
    ref_p = p0 + np.asarray(jlp.scatter_add(jnp.asarray(block[:, 81:])))
    assert _rel([out_u.numpy(), out_p.numpy()], [ref_u, ref_p]) <= 1e-13


def test_scatter_bound_counts_the_block_and_the_output_once():
    """K6's bound at 3 x 2 x 2 cells, by hand: the (12, 89) block read once,
    the 7 x 5 x 5 velocity nodes (3 components) and 4 x 3 x 3 pressure
    nodes read and written once; no cell table (the TPU kernel reads none,
    nor does the port's), so 12 x (27 + 8) int32 are not counted."""
    from adaflo_tpu_torch.scripts import HBM_BYTES_PER_S, scatter_bound

    mesh = StructuredMesh((3, 2, 2), (0.0,) * 3, (1.0,) * 3)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    cells = cm.CoupledCells(
        CellEvaluator(3, us.basis, 3, mesh.h, device="cpu"),
        CellEvaluator(3, ps.basis, 3, mesh.h, device="cpu"),
        LatticeOps.for_space(us).cell_dof_table(), LatticeOps.for_space(ps).cell_dof_table(),
        None, None, "cpu", lattice=(mesh.n_cells_axis, tuple(mesh.periodic)),
    )
    assert (us.n_dofs, ps.n_dofs) == (175, 36)
    for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
        b = scatter_bound(cells, us.n_dofs, ps.n_dofs, dtype)
        assert b["bytes"] == 12 * 89 * size + 2 * (3 * 175 + 36) * size
        assert b["flops"] == 12 * 89 and b["bound_by"] == "bytes"
        assert b["bound_ms"] == pytest.approx(b["bytes"] / HBM_BYTES_PER_S * 1e3)
    # the probes' 48^3 box: 124,432,192 B in float64, 0.0371 ms
    n_u, n_p = 97**3, 49**3
    big = types.SimpleNamespace(n_cells=48**3, ev_u=cells.ev_u, ev_p=cells.ev_p)
    assert scatter_bound(big, n_u, n_p, torch.float64)["bytes"] == 124_432_192
    assert scatter_bound(big, n_u, n_p, torch.float32)["bytes"] == 62_216_096


def test_scatter_cells_checks_its_arguments_in_order():
    """scatter_cells: the table set first, then the tensors, then the CPU's
    plain version (with or without a lattice shape), then any device
    without a kernel, before the lattice shape that only the kernel needs."""
    mesh = StructuredMesh((2, 2, 2), (0.0,) * 3, (1.0,) * 3)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    cells = cm.CoupledCells(
        CellEvaluator(3, us.basis, 3, mesh.h, device="cpu"),
        CellEvaluator(3, ps.basis, 3, mesh.h, device="cpu"),
        LatticeOps.for_space(us).cell_dof_table(), LatticeOps.for_space(ps).cell_dof_table(),
        None, None, "cpu",
    )
    meta = lambda *s: torch.zeros(*s, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="block must be"):
        cm.scatter_cells(meta(8, 88), cells, meta(3, us.n_dofs), meta(ps.n_dofs))
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        cm.scatter_cells(meta(8, 89), cells, meta(3, us.n_dofs), meta(ps.n_dofs))
    block = torch.ones(8, 89, dtype=torch.float64)
    out_u, out_p = cm.scatter_cells(block, cells, torch.zeros(3, us.n_dofs, dtype=torch.float64),
                                    torch.zeros(ps.n_dofs, dtype=torch.float64))
    assert float(out_u.sum()) == 3 * 27 * 8 and float(out_p.sum()) == 8 * 8


def test_k11_refuses_periodic_lattices_and_other_table_sets():
    mesh = StructuredMesh((2, 2, 2), (0.0,) * 3, (1.0,) * 3)
    mesh.set_periodic(0)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    cells = cm.CoupledCells(
        CellEvaluator(3, us.basis, 3, mesh.h, device="cpu"),
        CellEvaluator(3, ps.basis, 3, mesh.h, device="cpu"),
        LatticeOps.for_space(us).cell_dof_table(), LatticeOps.for_space(ps).cell_dof_table(),
        None, None, "cpu", lattice=(mesh.n_cells_axis, tuple(mesh.periodic)),
    )
    u = torch.zeros(3, us.n_dofs, dtype=torch.float64)
    p = torch.zeros(ps.n_dofs, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="non-periodic"):
        cm.coupled_apply_lattice(u, p, u, cells, SC)
    mesh2 = StructuredMesh((2, 2), (0.0,) * 2, (1.0,) * 2)
    us2, ps2 = ScalarSpace(mesh2, 2), ScalarSpace(mesh2, 1)
    cells2 = cm.CoupledCells(
        CellEvaluator(2, us2.basis, 3, mesh2.h, device="cpu"),
        CellEvaluator(2, ps2.basis, 3, mesh2.h, device="cpu"),
        LatticeOps.for_space(us2).cell_dof_table(), LatticeOps.for_space(ps2).cell_dof_table(),
        None, None, "cpu",
    )
    for fn in (lambda: cm.coupled_apply_lattice(u, p, u, cells2, SC),
               lambda: cm.coupled_apply_ablated(u, p, u, cells2, SC, "full"),
               lambda: cm.scatter_cells(torch.zeros(4, 22), cells2, u, p)):
        with pytest.raises(NotImplementedError, match="3D Q2/Q1"):
            fn()


def test_pipe_schedule_refuses_periodic_lattices():
    """K13's pipe schedule copies x-runs of the non-periodic probe box, so it
    refuses periodic cells and cells without a lattice shape, on the CPU as
    on the card; rowdma and unroll2 read the cell tables and take them."""
    mesh = StructuredMesh((2, 2, 2), (0.0,) * 3, (1.0,) * 3)
    mesh.set_periodic(0)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    ev = [CellEvaluator(3, sp.basis, 3, mesh.h, device="cpu") for sp in (us, ps)]
    tables = [LatticeOps.for_space(sp).cell_dof_table() for sp in (us, ps)]
    periodic = cm.CoupledCells(*ev, *tables, None, None, "cpu",
                               lattice=(mesh.n_cells_axis, tuple(mesh.periodic)))
    shapeless = cm.CoupledCells(*ev, *tables, None, None, "cpu")
    u = torch.zeros(3, us.n_dofs, dtype=torch.float64)
    p = torch.zeros(ps.n_dofs, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="non-periodic probe box"):
        cm.coupled_apply_ablated(u, p, u, periodic, SC, "pipe")
    with pytest.raises(ValueError, match="no lattice shape"):
        cm.coupled_apply_ablated(u, p, u, shapeless, SC, "pipe")
    for name in ("rowdma", "unroll2"):
        out = cm.coupled_apply_ablated(u, p, u, periodic, SC, name)
        assert all(float(o.abs().max()) == 0.0 for o in out)


def test_sass_counts_find_the_schedule_instances():
    """sass_counts keys the probe configuration's cell kernel instances by
    schedule and type from their mangled names (ptxas and cuobjdump print
    those), skips other instances, reads each one's registers and spills,
    and flags a schedule whose SASS lacks its asynchronous copies."""
    from adaflo_tpu_torch.scripts import sass_counts

    name = "_ZN12_GLOBAL__N_119coupled_cell_kernelILi3ELi3ELi3ELi2ELb1ELi0ELi0ELi0E{}Li{}ELi{}EEEvPKT7_"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name.format('d', 63, 2)}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name.format('d', 63, 2)}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 70 registers, used 1 barriers, 384 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{name.format('f', 31, 0)}' for 'sm_90a'",
        "ptxas info    : Used 33 registers, used 1 barriers, 384 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{name.format('f', 63, 0)}' for 'sm_90a'",
        "ptxas info    : Used 40 registers, used 1 barriers, 384 bytes cmem[0]",
    ])
    clean = {"stack": 0, "spill_stores": 0, "spill_loads": 0}
    assert sass_counts.schedule_ptxas(log) == {"pipe double": {"registers": 70, **clean},
                                               "full float": {"registers": 40, **clean}}
    spilled = log.replace("0 bytes spill stores", "8 bytes spill stores")
    assert sass_counts.schedule_ptxas(spilled)["pipe double"]["spill_stores"] == 8
    ok = {f"{n} {t}": {op: 1 for op in ops}
          for n, ops in sass_counts.SCHEDULE_OPS.items() for t in ("double", "float")}
    assert sass_counts.check_schedules(ok) == []
    ok["pipe float"] = {"UBLKCP": 2, "SYNCS": 0, "LDGSTS": 0}
    del ok["rowdma double"]
    assert sass_counts.check_schedules(ok) == ["rowdma double", "pipe float"]


def test_sass_counts_report_rowdma_on_the_one_shot_body():
    """rowdma runs the one-shot body as pipe and unroll2 do (SCHEDULE_BODY),
    and sass_counts keys its instances (schedule 1) by type, reads their
    registers and spills, and flags an instance without cp.async (LDGSTS),
    as it does the others."""
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.scripts import sass_counts

    assert set(cm.SCHEDULE_BODY.values()) == {"lines"}
    assert sass_counts.SCHEDULE_OPS["rowdma"] == ("LDGSTS",)
    name = "_ZN12_GLOBAL__N_119coupled_cell_kernelILi3ELi3ELi3ELi2ELb1ELi0ELi0ELi0E{}Li63ELi1EEEvPKT7_"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name.format('f')}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name.format('f')}",
        "    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 384 bytes cmem[0]",
    ])
    assert sass_counts.schedule_ptxas(log) == {"rowdma float": {
        "registers": 128, "stack": 16, "spill_stores": 12, "spill_loads": 12}}
    ok = {f"{n} {t}": {op: 1 for op in ops}
          for n, ops in sass_counts.SCHEDULE_OPS.items() for t in ("double", "float")}
    ok["rowdma float"] = {"LDGSTS": 0, "LDG": 40, "STS": 180}  # plain loads and stores
    assert sass_counts.check_schedules(ok) == ["rowdma float"]


def test_sass_counts_find_the_tiled_scatter_instances():
    """sass_counts keys K6's instances (scatter_tiles_kernel<T>) by type,
    reads their registers and spills, and flags a type whose SASS has no
    global atomic, no plain store, no shared-memory sum, or a shared-memory
    atomic."""
    from adaflo_tpu_torch.scripts import sass_counts

    name = "_ZN12_GLOBAL__N_120scatter_tiles_kernelI{}EEvPKT_PS1_S4_x14ScatterLattice"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name.format('d')}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name.format('d')}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers, 392 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{name.format('f')}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name.format('f')}",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 392 bytes cmem[0]",
    ])
    got = sass_counts.scatter_ptxas(log)
    assert got["double"] == {"registers": 56, "stack": 0, "spill_stores": 0, "spill_loads": 0}
    assert got["float"]["spill_stores"] == 8
    assert sass_counts.scatter_key("_ZN12_GLOBAL__N_120scatter_cells_kernelIdEEv") is None
    ok = {t: {"REDG": 12, "STG": 12, "LDS": 30, "STS": 20, "ATOMS": 0} for t in ("float", "double")}
    assert sass_counts.check_scatter(ok) == []
    ok["float"] = dict(ok["float"], ATOMS=12)
    ok["double"] = dict(ok["double"], REDG=0)
    assert sass_counts.check_scatter(ok) == ["float", "double"]
    assert sass_counts.check_scatter({"double": ok["double"]}) == ["float", "double"]


def test_scatter_variants_each_undo_one_choice_of_the_source(monkeypatch):
    """scripts/scatter_variants: every variant's substitutions apply to K6's
    source once each (the script fails loudly if the source drifts), each
    variant differs from the source, its timer runs the plain version on the
    CPU (error 0), and the script needs a card."""
    from adaflo_tpu_torch.scripts import scatter_variants as sv

    source = sv.SOURCE.read_text()
    for name in sv.VARIANTS:
        assert (sv.variant_source(name) == source) == (name == "tiled")
    assert set(sv.ABLATIONS) < set(sv.VARIANTS)
    res = sv.time_scatter(cm, 2, "cpu")
    assert set(res) == {"float64", "float32"}
    assert all(r["rel_err"] == 0.0 and r["blocks_per_sm"] is None for r in res.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        sv.main([])


def test_cell_flops_split_by_phase():
    """The per-phase operation counts of the cell apply (the bounds of
    chip_smoke.py and of the probes): 14,482 per 3D Q2/Q1 cell, of which
    the u* evaluation is half the evaluations and drops out with the q-field
    stream, and the pressure stages drop out without a pressure."""
    from adaflo_tpu_torch.scripts import cell_flops

    f = cell_flops(3, 3, 3, 2)
    assert sum(f.values()) == 14482
    assert f["eval_ustar"] == 3 * 9 * 27 * 5  # 3 items, 9 stages of 27 5-term dots
    assert f["eval_u"] == f["eval_ustar"] + (12 + 18 + 27) * 3  # + 3 pressure stages
    qf = cell_flops(3, 3, 3, 2, qfields=True)
    assert qf["eval_ustar"] == 0 and qf["eval_u"] == f["eval_u"]
    assert qf["qpoint"] == f["qpoint"] - 27 * 9
    v = cell_flops(3, 3, 3, 2, velocity_only=True)
    assert v["eval_u"] == v["eval_ustar"] and v["qpoint"] == f["qpoint"] - 2 * 27
    assert sum(cell_flops(2, 3, 3, 2, variable=True).values()) > sum(
        cell_flops(2, 3, 3, 2).values())


PROBES = ["probe_pr_phases", "probe_pr_parts", "probe_pr", "probe_pr_grouped"]


@pytest.mark.parametrize("name", PROBES)
def test_probe_driver_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch, capsys, name):
    mod = importlib.import_module(f"adaflo_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--cells", "2", "--reps", "1"])
    mod.main(["--cells", "2", "--reps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ms" in out and "(cpu)" in out


def test_probe_drivers_hold_each_variant_to_its_plain_version_on_the_cpu():
    """On the CPU every entry runs its plain version, so each variant's
    error is exactly 0; K12 reports an attribution per dropped phase."""
    from adaflo_tpu_torch.scripts import probe_pr, probe_pr_grouped, probe_pr_parts
    from adaflo_tpu_torch.scripts import probe_pr_phases

    quiet = lambda *a: None
    k12 = probe_pr_phases.run(2, 1, torch.float64, "cpu", out=quiet)
    assert set(k12) == set(cm.K12_VARIANTS)
    assert all("attribution_ms" in r for n, r in k12.items() if n.startswith("minus_"))
    k13 = probe_pr_parts.run(2, 1, torch.float32, "cpu", out=quiet)
    assert list(k13) == list(cm.K13_VARIANTS) + list(cm.K13_SCHEDULES)
    assert all(k13[v]["bound_ms"] == k13["full"]["bound_ms"] for v in cm.K13_SCHEDULES)
    k6 = probe_pr.run(2, 1, torch.float64, "cpu", out=quiet)
    k11 = probe_pr_grouped.run(2, 1, torch.float64, "cpu", out=quiet)
    for res in (k12, k13, k6, k11):
        assert all(r["rel_err"] == 0.0 for r in res.values())
    assert k6["scatter_cells"]["bound_by"] == "bytes"
    assert k11["lattice"]["bytes"] < k11["production"]["bytes"]


_ISOLATION = """
import importlib, pkgutil, sys
import adaflo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(adaflo_tpu_torch.__path__, "adaflo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"adaflo_tpu_torch.scripts.probe_pr_phases", "adaflo_tpu_torch.scripts.probe_pr_parts",
        "adaflo_tpu_torch.scripts.probe_pr", "adaflo_tpu_torch.scripts.probe_pr_grouped"} <= set(names)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "adaflo_tpu", "scripts"))
assert not bad, bad
"""


def test_probe_drivers_import_neither_jax_nor_the_jax_package_nor_its_scripts():
    proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_unported_probe_bounds_follow_their_shapes():
    """K5 and K7-K10's computed bounds at their scripts' defaults: the work
    of each JAX probe at its script's shapes (probe_bounds.py)."""
    from adaflo_tpu_torch.scripts.probe_bounds import bounds

    b = bounds()
    assert b["K5 f32"]["flops"] == 2 * 384 * 96 * 110592
    assert b["K5 f32"]["bound_by"] == "operations" and b["K5 bf16"]["bound_by"] == "bytes"
    assert b["K8 float32"]["flops"] == 0 and b["K8 float32"]["bound_by"] == "bytes"
    assert b["K9 f32"]["flops"] == 2 * 384 * 96 * 4096 * 29
    assert all(v["bound_ms"] > 0 for v in b.values())
