#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (adaflo_tpu_torch) on one NVIDIA GPU.

Phases:
  1. device: nvidia-smi name and power limit, CUDA version, kernel build time;
  2. kernels against their plain PyTorch versions, on the card: the coupled
     cell apply (K1 entry coupled_apply, K2 entry coupled_apply_velocity) at
     the main path's 16^3-cell lattice and at the 48^3-cell Q2/Q1 lattice
     (2,855,668 dofs), with Dirichlet boundary rows and a pressure-fix dof;
     every mode (constant coefficients in float64 and float32, variable
     coefficients, identity rows + scale + norm, velocity-only, 2D Q2/Q1,
     3D Q3/Q2); max-abs error over max-abs <= 1e-12 (float64) / 1e-5
     (float32); time per apply (CUDA events, median of 20 after warm-up)
     beside the plain version's time and the bound;
  3. the slice: the port's Beltrami driver on tests/prms/beltrami_3d.prm in
     float64 to t = 0.2 (4 steps), held to the reference anchors of
     tests/golden/beltrami_3d.output, with the launch counts of the main path.

The last line is {"ok": true, "device": {...}}; a "kernels" JSON line and
the nvidia-smi line come before it. Any failed phase raises and the script
exits non-zero without that line. It needs one CUDA device and the
repository checkout around it.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}  # outside the tensor cores
TOL = {"float64": 1e-12, "float32": 1e-5}
K1_SOURCE = "adaflo_tpu_torch/csrc/coupled_matvec.cu"
K1_REPLACES = "adaflo_tpu/ops/pallas_matvec.py:1145"  # coupled_vmult_pr2
K2_REPLACES = "adaflo_tpu/ops/pallas_matvec.py:685"  # coupled_vmult_pr
# reference anchors (tests/golden/beltrami_3d.output)
ANCHORS = {
    "cells": " Number of active cells: 4096.",
    "dofs": " Number of degrees of freedom (velocity/pressure): 112724 (107811 + 4913).",
    "err_t0": ("0.02383", "0.0001993"),
    "res_step1": ("2.590e+00", "6.423e-02"),
    "err_t02": ("0.02185", "0.0007541"),
}


class Tee(io.StringIO):
    """Captures the driver's output and echoes it to stdout."""

    def write(self, s):
        sys.stdout.write(s)
        return super().write(s)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cell_flops(dim: int, n1: int, q1: int, p1: int, variable: bool,
               velocity_only: bool) -> int:
    """Floating-point operations one cell needs in the kernel's sum
    factorization (coupled_cell_kernel). An output of a k-term contraction
    costs k multiplies and k - 1 adds; Gauss weights, 1/h and the per-step
    scalar products are tables or constants and cost nothing here. Without
    a pressure (velocity_only) the pressure stages, the -p on the stress
    diagonal and the pressure row are left out, as the kernel leaves them."""

    def dots(n_out: int, terms: int) -> int:
        return n_out * (2 * terms - 1)

    ni = 2 * dim  # items evaluated: u_c and u*_c
    nq = q1**dim
    f = 0
    if dim == 3:
        # evaluation along x (V, D), y (V, D, V), z (V, V, V, D) per item
        f += ni * (2 * dots(n1 * n1 * q1, n1) + 3 * dots(n1 * q1 * q1, n1)
                   + 4 * dots(nq, n1))
        # transposed integration per component: x (value + st_cx, st_cy,
        # st_cz), y (two inputs, one), z (two inputs)
        f += dim * (dots(n1 * q1 * q1, 2 * q1) + (dim - 1) * dots(n1 * q1 * q1, q1))
        f += dim * (dots(n1 * n1 * q1, 2 * q1) + dots(n1 * n1 * q1, q1))
        f += dim * dots(n1**3, 2 * q1)
        if not velocity_only:
            f += dots(p1 * p1 * q1, p1) + dots(p1 * q1 * q1, p1) + dots(nq, p1)
            f += dots(p1 * q1 * q1, q1) + dots(p1 * p1 * q1, q1) + dots(p1**3, q1)
    else:
        f += ni * (2 * dots(n1 * q1, n1) + 3 * dots(q1 * q1, n1))
        f += dim * (dots(n1 * q1, 2 * q1) + (dim - 1) * dots(n1 * q1, q1))
        f += dim * dots(n1 * n1, 2 * q1)
        if not velocity_only:
            f += dots(p1 * q1, p1) + dots(q1 * q1, p1)
            f += dots(p1 * q1, q1) + dots(p1 * p1, q1)
    # q-point terms (_q_point_terms, "vmult"), per point
    point = 2 * dim * dim  # 1/h on the gradients of u and u*
    point += 2 * (dim - 1)  # div u, div u*
    point += dim * (4 + 4 * dim)  # convection: beta terms, then 2 dim products
    # value row times JxW: a u + b conv (constant), or
    # rho (w u + tau1 conv) - d u with tau1 mu formed per point (variable)
    point += dim * 7 + 1 if variable else dim * 4
    point += dim * dim + (1 if variable else 0)  # symmetric stress, 2 tau1 mu
    point += 1 + dim  # tau_gd div, added on the diagonal
    point += dim + dim * dim  # JxW / h_d, times every stress entry
    if not velocity_only:
        point += 2  # -p on the diagonal, the pressure row -div JxW
    return f + point * nq


def bound(cells, dtype: str, n_u: int, n_p: int, velocity_only: bool, variable: bool):
    """(bytes, flops, bound_ms, bound_by) of one apply: every input read
    once, every output written once; the operations of cell_flops at the
    dtype's peak rate."""
    s = 4 if dtype == "float32" else 8
    dim, E = cells.dim, cells.n_cells
    nl, npl = (cells.degree + 1) ** dim, cells.degree**dim
    nbytes = 2 * dim * n_u * s + E * nl * 4 + dim * n_u  # u, u*, cell table, mask
    nbytes += dim * n_u * s  # output
    if not velocity_only:
        nbytes += n_p * s + E * npl * 4 + n_p + n_p * s
    if variable:
        nbytes += 3 * E * cells.n_q * s
    flops = E * cell_flops(
        dim, cells.degree + 1, cells.degree + 1, cells.degree, variable, velocity_only
    )
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[dtype]
    return nbytes, flops, 1e3 * max(t_bytes, t_flops), (
        "bytes" if t_bytes >= t_flops else "operations"
    )


def lattice_case(dim: int, degree: int, n_cells_axis: int, dtype, seed: int, device):
    """Cell data of a Dirichlet-bounded lattice with one pressure-fix dof and
    random vectors (numpy seed)."""
    import torch

    from adaflo_tpu_torch.mesh.structured import StructuredMesh
    from adaflo_tpu_torch.fe.space import ScalarSpace
    from adaflo_tpu_torch.ops.coupled_matvec import CoupledCells
    from adaflo_tpu_torch.ops.lattice import LatticeOps
    from adaflo_tpu_torch.ops.tensor import CellEvaluator

    mesh = StructuredMesh((n_cells_axis,) * dim, (-1.0,) * dim, (1.0,) * dim)
    us, ps = ScalarSpace(mesh, degree), ScalarSpace(mesh, degree - 1)
    ev_u = CellEvaluator(dim, us.basis, degree + 1, mesh.h)
    ev_p = CellEvaluator(dim, ps.basis, degree + 1, mesh.h)
    mask_u = np.zeros((dim, us.n_dofs), bool)
    mask_u[:, us.boundary_dofs(0)] = True
    mask_p = np.zeros(ps.n_dofs, bool)
    mask_p[ps.boundary_dofs(0)[0]] = True
    cells = CoupledCells(
        ev_u, ev_p, LatticeOps.for_space(us).cell_dof_table(),
        LatticeOps.for_space(ps).cell_dof_table(), mask_u, mask_p, device,
    )
    rng = np.random.default_rng(seed)
    kw = dict(dtype=dtype, device=device)
    u = torch.as_tensor(rng.standard_normal((dim, us.n_dofs)), **kw)
    p = torch.as_tensor(rng.standard_normal(ps.n_dofs), **kw)
    s = torch.as_tensor(rng.standard_normal((dim, us.n_dofs)), **kw)
    coeffs = tuple(
        torch.as_tensor(rng.uniform(0.5, 2.0, (mesh.n_cells, cells.n_q)), **kw)
        for _ in range(3)
    )
    return cells, u, p, s, coeffs


def rel_err(got, ref) -> float:
    """Largest max-abs error over max-abs among the outputs (velocity,
    pressure, norm), each held to its own scale."""
    return max(
        float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
        for a, b in zip(got, ref)
    )


def check_kernels(device):
    """Phase 2: every mode against the plain version; returns the timing
    records of the main-path mode at 16^3 and 48^3."""
    import torch

    from adaflo_tpu_torch.ops import coupled_matvec as cm

    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.0, 1.0, 0.0, 0.0)
    sc_var = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    records = {}
    cases = [
        # (label, dim, degree, cells per axis, dtype, mode)
        ("3D Q2/Q1 16^3 f64 const+ids", 3, 2, 16, torch.float64, "ids"),
        ("3D Q2/Q1 16^3 f64 velocity", 3, 2, 16, torch.float64, "velocity"),
        ("3D Q2/Q1 48^3 f64 const+ids", 3, 2, 48, torch.float64, "ids"),
        ("3D Q2/Q1 48^3 f64 velocity", 3, 2, 48, torch.float64, "velocity"),
        ("3D Q2/Q1 48^3 f64 const", 3, 2, 48, torch.float64, "const"),
        ("3D Q2/Q1 48^3 f32 const", 3, 2, 48, torch.float32, "const"),
        ("3D Q2/Q1 48^3 f32 const+ids", 3, 2, 48, torch.float32, "ids"),
        ("3D Q2/Q1 48^3 f64 variable", 3, 2, 48, torch.float64, "variable"),
        ("3D Q2/Q1 48^3 f64 ids+scale+norm", 3, 2, 48, torch.float64, "norm"),
        ("2D Q2/Q1 256^2 f64 variable+ids+scale+norm", 2, 2, 256, torch.float64, "all"),
        ("2D Q2/Q1 256^2 f64 velocity", 2, 2, 256, torch.float64, "velocity"),
        ("3D Q3/Q2 16^3 f64 variable+ids+scale+norm", 3, 3, 16, torch.float64, "all"),
        ("3D Q3/Q2 16^3 f32 const+ids", 3, 3, 16, torch.float32, "ids"),
        ("3D Q3/Q2 16^3 f64 velocity", 3, 3, 16, torch.float64, "velocity"),
    ]
    for label, dim, degree, n, dtype, mode in cases:
        cells, u, p, s, coeffs = lattice_case(dim, degree, n, dtype, 1000 + n, device)
        dname = str(dtype).split(".")[-1]
        variable = mode in ("variable", "all")
        scal = sc_var if variable else sc
        kw = dict(coeffs=coeffs if variable else None)
        if mode == "velocity":
            run = lambda: cm.coupled_apply_velocity(u, s, cells, scal, **kw)
            plain = lambda: cm.coupled_apply_plain(
                u, None, s, cells, scal, velocity_only=True, **kw
            )
            got, ref = [run()], [plain()]
        else:
            extra = dict(
                identity=mode != "const" and mode != "variable",
                scale=0.37 if mode in ("norm", "all") else None,
                want_norm=mode in ("norm", "all"),
            )
            run = lambda: cm.coupled_apply(u, p, s, cells, scal, **kw, **extra)
            plain = lambda: cm.coupled_apply_plain(u, p, s, cells, scal, **kw, **extra)
            got, ref = list(run()), list(plain())
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        max_abs = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        ms = cuda_ms(run)
        plain_ms = cuda_ms(plain, warmup=1, reps=5)
        nbytes, flops, bms, by = bound(
            cells, dname, u.shape[1], p.shape[0], mode == "velocity", variable
        )
        print(
            f"kernel {label}: rel err {err:.3e} (max abs {max_abs:.3e}), "
            f"{ms:.4f} ms/apply, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)",
            flush=True,
        )
        if not err <= TOL[dname]:
            raise AssertionError(f"{label}: relative error {err:.3e} > {TOL[dname]}")
        records[label] = dict(
            max_abs_err=max_abs, rel_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops,
        )
    return records


def run_slice():
    """Phase 3: the Beltrami driver to t = 0.2, held to the anchors."""
    import torch

    from adaflo_tpu_torch.drivers.beltrami import BeltramiProblem
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.parameters import FlowParameters

    par = FlowParameters.from_file(str(ROOT / "tests" / "prms" / "beltrami_3d.prm"))
    par.end_time = 0.2
    out = Tee()
    for k in cm.launches:
        cm.launches[k] = 0
    for k in cm.plain_calls:
        cm.plain_calls[k] = 0
    t0 = time.perf_counter()
    problem = BeltramiProblem(par, out=out)  # the default device, as a user runs it
    problem.setup()
    problem.output_results()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps = []
    while not problem.navier_stokes.time_stepping.at_end():
        before = dict(cm.launches)
        t0 = time.perf_counter()
        nl, lin = problem.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append(dict(
            seconds=dt, newton=nl, krylov=lin,
            launches={k: cm.launches[k] - before[k] for k in cm.launches},
        ))
    launches = dict(cm.launches)
    plain = dict(cm.plain_calls)
    text = out.getvalue()
    lines = text.splitlines()

    def err_pair(line):
        parts = line.split("=")
        return parts[1].split(",")[0].strip(), parts[2].strip()

    err_lines = [ln for ln in lines if ln.startswith("  L2-Errors absolute")]
    first_res = next(
        ln for ln in lines if "AMGl" in ln or "Cheb" in ln or "---" in ln
    ).split()
    checks = {
        "cells": ANCHORS["cells"] in lines,
        "dofs": ANCHORS["dofs"] in lines,
        "err_t0": err_pair(err_lines[0]) == ANCHORS["err_t0"],
        "res_step1": tuple(first_res[:2]) == ANCHORS["res_step1"],
        "err_t02": len(err_lines) == 2 and err_pair(err_lines[1]) == ANCHORS["err_t02"],
        "converged": text.count(" converged.") == 4 and len(steps) == 4,
        "kernel_launched": launches["coupled_apply"] > 0
        and launches["coupled_apply_velocity"] > 0,
        "no_plain_calls": all(v == 0 for v in plain.values()),
    }
    for st in steps:
        print(
            f"step: {st['seconds']:.3f} s, Newton {st['newton']}, Krylov "
            f"{st['krylov']}, launches {st['launches']}", flush=True,
        )
    print(f"slice: setup {setup_s:.3f} s, checks {checks}", flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"slice anchors failed: {failed}")
    return dict(setup_s=setup_s, steps=steps, launches=launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "adaflo_tpu_torch" / "csrc" / "coupled_matvec.cu").is_file():
        print("chip_smoke: adaflo_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # ---- phase 1: device and build -----------------------------------------
    smi = smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from adaflo_tpu_torch.ops import coupled_matvec as cm

    t0 = time.perf_counter()
    cm.load_library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
    for ln in cm.build_info.get("log", "").splitlines():
        if "registers" in ln or "spill" in ln:
            print("ptxas:", ln.strip())

    # ---- phase 2: kernels against the plain version ------------------------
    rec = check_kernels(device)

    # ---- phase 3: the slice --------------------------------------------------
    slice_rec = run_slice()
    launches = slice_rec["launches"]

    def entry(name, replaces, main_label, big_label):
        r, b = rec[main_label], rec[big_label]
        return {
            "name": name, "route": "cuda", "source": K1_SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": main_label,
            "at_48": {k: b[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        }

    kernels = [
        entry("coupled_apply", K1_REPLACES, "3D Q2/Q1 16^3 f64 const+ids",
              "3D Q2/Q1 48^3 f64 const+ids"),
        entry("coupled_apply_velocity", K2_REPLACES, "3D Q2/Q1 16^3 f64 velocity",
              "3D Q2/Q1 48^3 f64 velocity"),
    ]
    steps = slice_rec["steps"]
    n = len(steps)
    print(
        "slice summary: "
        f"{statistics.mean(s['seconds'] for s in steps):.3f} s/step, "
        f"Newton/step {sum(s['newton'] for s in steps) / n:.2f}, "
        f"Krylov/step {sum(s['krylov'] for s in steps) / n:.2f}, "
        f"launches/step " + json.dumps({k: v / n for k, v in launches.items()})
    )
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
