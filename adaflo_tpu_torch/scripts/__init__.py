"""Measurement probes of the coupled cell apply, the port's counterparts of
the JAX package's ``scripts/probe_pr*.py``.

Each module runs as ``python -m adaflo_tpu_torch.scripts.<name> [--cells 48]
[--reps 20] [--dtype float64|float32] [--device cpu]``:

- ``probe_pr_parts``: K13's whole-apply ablations (datapath, noshift, mdot,
  evdots, full, noscatter);
- ``probe_pr_phases``: K12's minus-one-phase ablations and the phase
  attribution (full - ablated);
- ``probe_pr``: K6, the cell-block scatter alone, beside ``index_add_`` and
  the lattice scatter, and K3 and K4 alone;
- ``probe_pr_grouped``: K11, the apply with addresses from lattice
  coordinates, beside K1.

and the contraction-rate and matrix-unit probes, with options of their own:

- ``probe_sf``: K7-K10 (row statements, row copies, the resident dense dot,
  the sum-factorized evaluation) at two work levels each, with the marginal
  rates (``--block 4096 --nblk 29 --dtype float32|float64``);
- ``probe_mxu``: K5, the streamed dense dot, beside the library's products
  (``--n 4096 --cols 110592``);
- ``probe_bounds``: the bounds of K5 and K7-K10 at a configuration;
- ``sass_counts``: the probe kernels' instruction counts (cuobjdump);
- ``scatter_variants``: K6's design choices undone one at a time, and K6 of
  another checkout, timed side by side (``--checkout DIR``).

Without ``--device cpu`` a probe needs a CUDA device and raises otherwise; on
the CPU it runs the plain versions, and its times are CPU times. This module
holds what the probes share: the case (the probes' 48^3-cell Q2/Q1 box), the
timing and the bounds.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import time
from typing import NamedTuple

import torch

from adaflo_tpu_torch.device import resolve_device
from adaflo_tpu_torch.fe.constraints import Constraints
from adaflo_tpu_torch.fe.space import ScalarSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.ops.coupled_matvec import (
    PH_CONTIG,
    PH_EVAL_U,
    PH_EVAL_USTAR,
    PH_GATHER,
    PH_INTEGRATE,
    PH_MDOT,
    PH_QPOINT,
    VARIANTS,
)
from adaflo_tpu_torch.ops.navier_stokes import NavierStokesOperator, TimeWeights
from adaflo_tpu_torch.parameters import FlowParameters

# NVIDIA H100 SXM at its 700 W limit (data sheet, dense rates): the HBM3
# rate, and the peak rate of each number type: float64 on the tensor cores
# (DMMA), float64 on the CUDA cores (the rate of elementwise statements,
# which the tensor cores cannot run), float32 outside the tensor cores, TF32
# and bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float64_simt": 34e12, "float32": 67e12,
              "tf32": 495e12, "bf16": 989e12}


class ProbeCase(NamedTuple):
    op: NavierStokesOperator
    u: torch.Tensor  # (3, n_u), also the linearization point
    p: torch.Tensor  # (n_p,)
    sc: object  # ApplyScalars of the case's BDF weights


def parse_args(description: str, argv=None, extra=None):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--cells", type=int, default=48, help="cells per axis (default 48)")
    ap.add_argument("--reps", type=int, default=20, help="timed applies (default 20)")
    ap.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain versions)",
    )
    ap.add_argument("--seed", type=int, default=0, help="seed of the random inputs")
    if extra is not None:
        extra(ap)
    return ap.parse_args(argv)


def probe_case(cells: int, dtype, device, seed: int = 0) -> ProbeCase:
    """The probes' configuration (scripts/probe_pr*.py): the unit cube of
    cells^3 cells, Q2/Q1, no constraints; random nodal u and p from a
    torch.Generator seeded with `seed`; the Newton linearization at u, BDF
    weights (30, -30, 0) and tau1 = 1."""
    device = resolve_device(device)
    par = FlowParameters.from_string(
        "subsection Navier-Stokes\n  set dimension = 3\n"
        "  set velocity degree = 2\nend\n"
    )
    mesh = StructuredMesh((cells,) * 3, (0.0,) * 3, (1.0,) * 3)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    cu = [Constraints(us.n_dofs) for _ in range(3)]
    cp = Constraints(ps.n_dofs)
    for c in cu + [cp]:
        c.close()
    op = NavierStokesOperator(par, us, ps, cu, cp, dtype=dtype, device=device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    u = torch.randn((3, us.n_dofs_padded), generator=gen, dtype=dtype).to(device)
    p = torch.randn((ps.n_dofs_padded,), generator=gen, dtype=dtype).to(device)
    return ProbeCase(op, u, p, op._apply_scalars(TimeWeights(30.0, -30.0, 0.0, 1.0)))


def time_ms(fn, device, reps: int, warmup: int = 3) -> dict:
    """Two times of `fn` in ms, after `warmup` calls: "ms", the mean of
    `reps` calls issued back to back between one pair of CUDA events (the
    card's time per call while the host runs ahead of it), and "call_ms",
    the median of `reps` calls each between its own events and waited for
    (what a caller that waits sees: the wrapper's checks, its output
    allocations, the launch and the gap before it). On the CPU both are
    host-clock times."""
    for _ in range(warmup):
        fn()
    sync(device)
    calls = []
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        chained = a.elapsed_time(b) / reps
        for _ in range(reps):
            a.record()
            fn()
            b.record()
            b.synchronize()
            calls.append(a.elapsed_time(b))
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        chained = 1e3 * (time.perf_counter() - t0) / reps
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            calls.append(1e3 * (time.perf_counter() - t0))
    return dict(ms=chained, call_ms=statistics.median(calls))


def time_rounds(fns: dict, device, reps: int, rounds: int = 5) -> dict:
    """{name: {"ms", "call_ms"}} for the callables of `fns`, timed in turns:
    `rounds` rounds, each timing every callable (time_ms, `reps` calls), and
    the median of each time over the rounds, so that a drift of the card's
    clocks between calls falls on every variant alike."""
    samples = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            samples[name].append(time_ms(fn, device, reps, warmup=1))
    return {
        name: {k: statistics.median(t[k] for t in v) for k in ("ms", "call_ms")}
        for name, v in samples.items()
    }


def joint_err(got, ref):
    """(max-abs error, that over the max-abs of the whole output)."""
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    return err, err / max(max(float(b.abs().max()) for b in ref), 1e-300)


def cell_flops(dim: int, n1: int, q1: int, p1: int, variable: bool = False,
               velocity_only: bool = False, qfields: bool = False) -> dict:
    """Floating-point operations one cell needs in the cell kernel's sum
    factorization (coupled_cell_kernel), by phase: eval_u (u and p at the q
    points), eval_ustar (u*), qpoint, integrate. An output of a k-term
    contraction costs k multiplies and k - 1 adds; Gauss weights, 1/h and
    the per-step scalar products are tables or constants and cost nothing
    here. Without a pressure (velocity_only) the pressure stages, the -p on
    the stress diagonal and the pressure row are left out, as the kernel
    leaves them. With the u* q-field stream (qfields) u* is read at the q
    points, so its evaluation stages and the 1/h on its gradients are left
    out."""

    def dots(n_out: int, terms: int) -> int:
        return n_out * (2 * terms - 1)

    nq = q1**dim
    if dim == 3:
        # evaluation along x (V, D), y (V, D, V), z (V, V, V, D) per item
        item = 2 * dots(n1 * n1 * q1, n1) + 3 * dots(n1 * q1 * q1, n1) + 4 * dots(nq, n1)
        eval_p = dots(p1 * p1 * q1, p1) + dots(p1 * q1 * q1, p1) + dots(nq, p1)
        # transposed integration per component: x (value + st_cx, st_cy,
        # st_cz), y (two inputs, one), z (two inputs)
        integ = dim * (dots(n1 * q1 * q1, 2 * q1) + (dim - 1) * dots(n1 * q1 * q1, q1))
        integ += dim * (dots(n1 * n1 * q1, 2 * q1) + dots(n1 * n1 * q1, q1))
        integ += dim * dots(n1**3, 2 * q1)
        integ_p = dots(p1 * q1 * q1, q1) + dots(p1 * p1 * q1, q1) + dots(p1**3, q1)
    else:
        item = 2 * dots(n1 * q1, n1) + 3 * dots(q1 * q1, n1)
        eval_p = dots(p1 * q1, p1) + dots(q1 * q1, p1)
        integ = dim * (dots(n1 * q1, 2 * q1) + (dim - 1) * dots(n1 * q1, q1))
        integ += dim * dots(n1 * n1, 2 * q1)
        integ_p = dots(p1 * q1, q1) + dots(p1 * p1, q1)
    # q-point terms (_q_point_terms, "vmult"), per point
    point = (1 if qfields else 2) * dim * dim  # 1/h on the gradients of u, u*
    point += 2 * (dim - 1)  # div u, div u*
    point += dim * (4 + 4 * dim)  # convection: beta terms, then 2 dim products
    # value row times JxW: a u + b conv (constant), or
    # rho (w u + tau1 conv) - d u with tau1 mu formed per point (variable)
    point += dim * 7 + 1 if variable else dim * 4
    point += dim * dim + (1 if variable else 0)  # symmetric stress, 2 tau1 mu
    point += 1 + dim  # tau_gd div, added on the diagonal
    point += dim + dim * dim  # JxW / h_d, times every stress entry
    pres = 0 if velocity_only else 1
    point += 2 * pres  # -p on the diagonal, the pressure row -div JxW
    return {
        "eval_u": dim * item + pres * eval_p,
        "eval_ustar": 0 if qfields else dim * item,
        "qpoint": point * nq,
        "integrate": integ + pres * integ_p,
    }


def roofline(nbytes: int, flops: int, rate: str) -> dict:
    """Least time of a call on the card: its bytes over the HBM rate against
    its operations over the peak rate of `rate` (a key of PEAK_FLOPS)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[rate]
    return dict(
        bytes=nbytes, flops=flops, bound_ms=1e3 * max(t_bytes, t_flops),
        bound_by="bytes" if t_bytes >= t_flops else "operations",
    )


def _rate(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def variant_bound(variant: str, cells, n_u: int, n_p: int, dtype) -> dict:
    """Least time of one apply of a probe variant (K12/K13, or "lattice" for
    K11) on the card: the bytes it must move (u, u* and p once, or one value
    per cell and item for a dropped gather; the int32 cell tables once, but
    none for K11; the masks; M89 for mdot; the output once) over the HBM
    rate, against the operations of the phases it runs over the peak
    rate."""
    s = torch.finfo(dtype).bits // 8
    dim, E = 3, cells.n_cells
    nl, npl = cells.ev_u.n_local, cells.ev_p.n_local
    ph = VARIANTS["full" if variant == "lattice" else variant]
    if ph & (PH_GATHER | PH_CONTIG):
        nbytes = (2 * dim * n_u + n_p) * s
    else:
        nbytes = E * (2 * dim + 1) * s
    nbytes += 0 if variant == "lattice" else E * (nl + npl) * 4
    nbytes += 0 if cells.mask_u is None else dim * n_u
    nbytes += 0 if cells.mask_p is None else n_p
    nbytes += (dim * n_u + n_p) * s
    f = cell_flops(dim, cells.degree + 1, cells.degree + 1, cells.degree)
    flops = 0
    for name, bit in (("eval_u", PH_EVAL_U), ("eval_ustar", PH_EVAL_USTAR),
                      ("qpoint", PH_QPOINT), ("integrate", PH_INTEGRATE)):
        if ph & bit:
            flops += E * f[name]
    if ph & PH_MDOT:  # M89 once, one dense product per cell
        n_cols = dim * nl + npl
        nbytes += n_cols**2 * s
        flops += E * n_cols * (2 * n_cols - 1)
    return roofline(nbytes, flops, _rate(dtype))


def scatter_bound(cells, n_u: int, n_p: int, dtype) -> dict:
    """K6: read the (E, n_cols) block once, read and write the nodal output
    (3 n_u + n_p values) once; one add per block entry. No cell table: the
    TPU kernel reads none, and neither does the port's."""
    s = torch.finfo(dtype).bits // 8
    E, nl, npl = cells.n_cells, cells.ev_u.n_local, cells.ev_p.n_local
    n_cols = 3 * nl + npl
    nbytes = E * n_cols * s + 2 * (3 * n_u + n_p) * s
    return roofline(nbytes, E * n_cols, _rate(dtype))


@contextlib.contextmanager
def allow_tf32():
    """float32 matrix products in TF32 inside the block, the old setting
    restored after it; every probe keeps TF32 off otherwise."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def per_step(step, nblk: int, device):
    """A callable that runs `step` nblk times: the library's counterpart of a
    kernel that does one grid step's work nblk times over, each step writing
    the same output. On the card the nblk calls are one CUDA graph, captured
    at the first call after a warm-up on a side stream, so that one replay
    times the library's kernels without the host's launches between them;
    on the CPU a loop."""
    if device.type != "cuda":
        def loop():
            for _ in range(nblk):
                step()

        return loop
    graph = None

    def replay():
        nonlocal graph
        if graph is None:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(3):
                    step()
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(nblk):
                    step()
        graph.replay()

    return replay
