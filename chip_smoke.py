#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (adaflo_tpu_torch) on one NVIDIA GPU.

Phases:
  1. device: nvidia-smi name and power limit, CUDA version; the two kernel
     libraries (csrc/coupled_matvec.cu, csrc/probe_kernels.cu) built by one
     nvcc each, started together, with each build's time and ptxas'
     registers and spills; every production instance of the cell kernel's
     one-shot body (each entry at each table set, float64 and float32): its
     registers, stack and spills (ptxas), cells per block, shared memory per
     block and resident blocks per SM (cm.cell_geometry), and its SASS LDS
     against DFMA/FFMA, at the four table sets (3D Q2/Q1, 2D Q2/Q1, 3D
     Q3/Q2, 2D Q3/Q2); none may spill; K13's three schedules of the cell
     kernel beside the one-shot full apply: the body each runs (all three
     the one-shot body's stages), its cells per group, registers and spills
     (ptxas), shared memory per block and resident blocks per SM (the
     occupancy calculator), none may spill, and their SASS
     (scripts/sass_counts): rowdma and unroll2 must hold cp.async (LDGSTS),
     pipe bulk copies (UBLKCP) and mbarrier operations (SYNCS); K7's six
     instances per type (n_ops 24, 72, 96, aligned and shifted): registers
     and spills (ptxas), none may spill, and SASS whose FP instructions grow
     by 4 x 3 per statement and work item and whose LDS do not grow with
     n_ops (sass_counts.check_fma: no statement merged, none fed from shared
     memory); K8's instances (29 and 89 rows) and K10's, per type: registers
     and spills (none may spill), the launch plan at the scripts' defaults
     (tile, threads, shared memory, blocks per SM, step groups, work items,
     grid; ops/probe_kernels.resident_plan) and SASS: K8's step one LDS and
     one STS per copied row of a work item and no global store in it
     (sass_counts.check_copies), K10's 3 FP instructions for each of a work
     item's 81 statements and at most its 27 operands' LDS
     (sass_counts.check_sfeval);
     the SASS of the dense dot's 17 instances (K5, K9): each
     must hold TMA tile loads (UTMALDG) and mbarrier operations (SYNCS), and
     wgmma (HGMMA) in bf16 and TF32, DMMA in float64, FFMA in float32
     (sass_counts.DOT_OPS); beside it each instance's registers, stack and
     spills (ptxas), shared memory, resident blocks per SM, threads, tile
     columns, parts of A and ring stages (ops/probe_kernels.dot_plan);
     K6's tiled scatter (scatter_tiles_kernel, float64 and float32):
     registers and spills (none may spill), its launch plan at 48^3 (tile,
     threads, shared memory per block, blocks per SM, grid;
     ops/coupled_matvec.scatter_plan) and SASS with global atomics, plain
     stores, shared-memory sums and no shared-memory atomic
     (sass_counts.check_scatter);
  2. kernels against their plain PyTorch versions, on the card, max-abs error
     over max-abs <= 1e-12 (float64) / 1e-5 (float32), with the time per
     apply beside the plain version's time and the bound (bytes over the
     HBM rate against operations over the peak rate of the number type,
     adaflo_tpu_torch.scripts.PEAK_FLOPS): CUDA events around 20 applies
     issued back to back, and the median of 20 single applies each waited
     for (adaflo_tpu_torch.scripts.time_ms); K1 and K3-velocity at 16^3 also
     in a CUDA graph of 20 applies (graph_ms: the device time that the
     back-to-back figure hides behind the host's launch rate);
     - the nodal entries (K1 coupled_apply, K2 coupled_apply_velocity) at
       the 16^3-cell lattice and at the 48^3-cell Q2/Q1 lattice (2,855,668
       dofs), with Dirichlet boundary rows and a pressure-fix dof, in every
       mode (constant coefficients in float64 and float32, variable
       coefficients, identity rows + scale + norm, velocity-only, 2D Q2/Q1,
       3D Q3/Q2);
     - K1/K2's 2D Q3/Q2 instance on the 256 x 512-cell box (2,363,906 +
       525,825 = 2,889,731 dofs, the 2D counterpart of the 48^3 box), with
       Dirichlet rows and a pinned pressure dof, in every mode (constant
       with and without identity rows, variable, variable + identity rows +
       scale + norm, velocity-only constant and variable in float64;
       constant + identity rows, variable + identity rows + scale + norm and
       velocity-only in float32), each also timed in a CUDA graph;
     - the cell-block entries (K3 coupled_apply_cells with the u* dof and
       q-field streams, K4 coupled_apply_gather; coupled and velocity-only)
       at the periodic channel's 16^3 lattice and the 48^3 box, 2D Q2/Q1
       and 3D Q3/Q2, float64 and float32;
     - the operator's routes on the same inputs: K3 behind the lattice
       gather and scatter, and K4 behind the scatter, against K1 (which
       reads the wrapped cell table on the periodic lattice);
     - the probe instances at 16^3 and 48^3 (3D Q2/Q1 box with Dirichlet
       rows, float64 and float32), max-abs error over max-abs of the whole
       output [u | p]: K12's and K13's phase-masked instances and K13's
       three schedules rowdma, pipe and unroll2 (coupled_apply_ablated)
       against coupled_apply_ablated_plain (full's, for a schedule), K11
       (coupled_apply_lattice, no cell table) against coupled_apply_plain,
       K6 (scatter_cells) against scatter_cells_plain into nonzero outputs;
     - K6 also on the channel's periodic 16^3 lattice (x and z wrap), a
       20 x 12 x 9 lattice periodic on every axis and a 17 x 9 x 5 one that
       its tile divides on no axis, float64 and float32, into nonzero
       outputs; cells without a lattice shape must raise ValueError; and
       K6's device time at 48^3 in a CUDA graph of 20 calls (graph_ms);
     - the contraction-rate probes (ops/probe_kernels: K7 row_fma, K8
       row_copies, K9 dense_dot and K5 dense_dot_streamed in f32, tf32, bf16
       and f64, K10 sf_eval) against their plain versions at block 256 and 2
       steps, in every mode, K9 at every (m, k) in every precision, K5 over
       1,024, 64 (one work item) and 1,088 columns (17, an odd count); K7's
       untimed mode and K9 at every (m, k) and precision also at the
       scripts' defaults (block 4096, 29 steps), errors only (phase 4 times
       and checks the rest); the drivers' tolerances (float64 1e-12, float32
       1e-5, TF32 2e-3, K9 bf16 1e-5, K5's bf16 output 8e-3), K8 exact; K7
       also at block 200 (its last 64-column tile cut short) in every mode;
       K8 (block 4096) and K10 (2048) in both types at a step count whose
       step groups on the card are uneven (partial_group_cases), and their
       device times at the scripts' defaults in a CUDA graph of 20 calls
       (resident_graph_ms);
  3. the slice, each path driven with the launch counts set to 0 before it
     and read after it:
     - the port's Beltrami driver on tests/prms/beltrami_3d.prm in float64
       to t = 0.2 (4 steps), held to the reference anchors of
       tests/golden/beltrami_3d.output; it runs K1 and K2;
     - the periodic channel application on the uniform 16^3 lattice
       (4,096 cells, Q2/Q1, float64), CHANNEL_STEPS = 2 of the prm's 3
       coupled-Newton BDF-2 steps of dt = 0.1 (about 120 s a step; the
       third was cut so that the golden paths' children fit), held to
       Newton convergence in every step, exact no-slip
       walls and a finite, bounded velocity; it runs K3;
     - the 3D rising bubble at its flagship size (the rising bubble
       driver's flagship mesh: 32^3 cells, symmetry on the four side faces,
       no-slip bottom and top; tests/prms/rising_bubble_ls_3d_bench.prm at
       global refinements = 0 with its solver tolerances; 859,812 NS and
       35,937 level-set dofs, float64): setup, then phase 2's check of K1
       (identity rows) and K2 in variable mode on its fields (rho/mu from
       the level set's compute_force on the initial bubble, the velocity
       masks differing by component; 1e-12 float64, 1e-5 float32), then
       RB3_STEPS steps, each with its seconds, Newton and Krylov counts and
       launches, and its bubble statistics timed apart; held to the dof
       anchors, Newton convergence, finite statistics, a kept volume, a
       rising bubble, K1 and K2 in every step and no plain call; the peak
       device memory; it runs K1 and K2 in variable mode;
     - the 2D rising bubble (tests/prms/rising_bubble_ls_short.prm, 20 x 40
       cells, 3 steps): setup, then the same check of K1 and K2 in variable
       mode on its fields and symmetry masks, then its steps, held to
       tests/golden/rising_bubble_ls_short.output with the port's
       compare_with_golden; it runs K1 and K2 in variable mode;
     - the Q3 bubble (tests/prms/rising_bubble_ls_q3_short.prm, 10 x 20
       cells, velocity degree 3): setup, then the same check of K1 and K2
       of the 2D Q3/Q2 instance in variable mode on its fields and symmetry
       masks, with their device times in a CUDA graph; its steps run as a
       golden path below;
     - the single-phase lattice drivers: after couette's setup, phase 2's
       check of K1 (identity rows) and K2 in constant mode on its spaces
       and open-boundary masks (the tangential component only on the open
       sides; 1e-12 float64, 1e-5 float32); then the seven goldens
       (couette, poiseuille_ns_small, poiseuille_stokes,
       poiseuille_stationary, poiseuille_ns_proj_small, flow_1d,
       flow_1d_damped), each run by its driver and held to its golden with
       the port's compare_with_golden, and tests/prms/poiseuille_ns.prm to
       t = 2 held to the reference anchor (||e_u|| = 0.1321 +- 2e-4,
       ||e_p|| < 1e-8); with them the nine lattice goldens of the rising
       bubble's variants and of augmented Taylor-Hood (LATTICE_GOLDENS:
       rising_bubble_ls_{q3,picard,imex,expl,augp}_short,
       beltrami_2d_augp_small, beltrami_2d_augp_proj_small,
       beltrami_3d_augp_small, spurious_currents_ls_3d_short) and the
       adaptive forest's paths (FOREST_GOLDENS: beltrami_2d_small and
       beltrami_2d_proj_small, the 2D Taylor vortex on the reference's
       locally refined mesh, held to their goldens; "drivencavity", the
       driven cavity's adaptive round of tests/test_forest_navier_stokes.py,
       held to its checks: two converged solves, cells 64, 82, 106, hanging
       rows, the finest cells near the lid): each in a child process of its
       own with the counts from 0 (`chip_smoke.py --golden <name>`, all
       started together, each host-bound on a small mesh), which prints its
       seconds, steps, Newton and Krylov counts, launches and peak device
       memory; couette, poiseuille_ns_small, the anchor and the Q3 bubble
       run K1 and K2, the others the operator's plain cell route alone (its
       applies counted, no K1-K4 launch); the forest paths' counts must be
       the CPU's (FOREST_COUNTS);
     - before the goldens, the full-width forest path: the Beltrami driver
       on the reference's 2D AMR mesh (global refinements = 4, velocity
       degree 4: 1048 cells, Q4/Q3, 34,158 + 9,663 dofs, float64) with
       beltrami_2d_small.prm's step size and tolerances: the build of the
       native forest library (g++), then setup (the forest and the
       ForestGMG hierarchies timed apart), the t = 0 anchors of
       tests/test_golden_ns.py (9.507e-09 / 8.461e-12, relative 2.291e-08 /
       9.877e-12, divergence below 1e-14), then FOREST_STEPS = 2 steps, each
       with its seconds, Newton and Krylov counts and plain-route applies,
       the counts held to the CPU's (FOREST_COUNTS); no K1-K4 launch
       (forests run the plain cell route, as JAX's eligibility rules), the
       peak device memory;
     - the 3D open-boundary channel at full width (poiseuille_ns.prm with
       dimension = 3 and global refinements = 4: 64 x 16 x 16 cells,
       421,443 + 18,785 dofs, float64): setup, phase 2's check of K1/K2 on
       its open-boundary masks (with their device time in a CUDA graph),
       then CH3_STEPS steps, each with its seconds, Newton and Krylov
       counts, launches and plain-route applies; K1 in every step, the peak
       device memory;
  4. the probes, their path driven with the launch counts set to 0 before it
     and read after it: each probe driver of adaflo_tpu_torch/scripts
     (probe_pr_phases K12, probe_pr_parts K13, probe_pr K6 with K3 and K4
     alone, probe_pr_grouped K11) at the probes' 48^3-cell Q2/Q1 box in
     float64 and float32: per variant ms/apply, bound and plain ms, K12's
     phase attribution, K13's schedules beside full, K6's time beside its
     bound, index_add_ and the lattice scatter; then the
     contraction-rate probes (probe_sf K7-K10 at block 4096 and 29 steps in
     float32 and float64, probe_mxu K5 at 110,592 columns, each precision in
     5 rounds interleaved with its stacked torch.matmul): per configuration
     ms, bound, plain and library ms, and the marginal rates; every entry of
     ops/probe_kernels must launch.

The last line is {"ok": true, "device": {...}}; a "kernels" JSON line and
the nvidia-smi line come before it. Any failed phase raises and the script
exits non-zero without that line. It needs one CUDA device and the
repository checkout around it.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import io
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = {"float64": 1e-12, "float32": 1e-5}
K1_SOURCE = "adaflo_tpu_torch/csrc/coupled_matvec.cu"
K1_REPLACES = "adaflo_tpu/ops/pallas_matvec.py:1145"  # coupled_vmult_pr2
K2_REPLACES = "adaflo_tpu/ops/pallas_matvec.py:685"  # coupled_vmult_pr
K3_REPLACES = "adaflo_tpu/ops/pallas_matvec.py:491"  # coupled_vmult_cells
K4_REPLACES = "adaflo_tpu/ops/pallas_matvec.py:1364"  # coupled_vmult_parity
K6_REPLACES = "scripts/probe_pr.py:144"  # ring_scatter
K11_REPLACES = "scripts/probe_pr_grouped.py:213"  # build_call
K12_REPLACES = "scripts/probe_pr_phases.py:164"  # apply_fn
K13_REPLACES = "scripts/probe_pr_parts.py:363"  # run_variant
K13_SCHEDULE_REPLACES = {  # make_kernel_rowdma, make_kernel_pipe, make_kernel_unroll2
    "rowdma": "scripts/probe_pr_parts.py:35",
    "pipe": "scripts/probe_pr_parts.py:101",
    "unroll2": "scripts/probe_pr_parts.py:170",
}
SF_SOURCE = "adaflo_tpu_torch/csrc/probe_kernels.cu"
K5_REPLACES = "scripts/probe_mxu.py:93"  # pkern (pall)
K7_REPLACES = "scripts/probe_sf.py:83"  # run_vpu kernel
K8_REPLACES = "scripts/probe_sf.py:142"  # run_copies kernel
K9_REPLACES = "scripts/probe_sf.py:169"  # run_mxu kernel
K10_REPLACES = "scripts/probe_sf.py:295"  # run_sfeval kernel
# the main-path instances at 16^3 whose device time phase 2 also takes in
# a CUDA graph of 20 applies (graph_ms): back to back, the host's launch
# rate hides it
GRAPH_TIMED = (
    "3D Q2/Q1 16^3 f64 const+ids",
    "coupled_apply_cells_velocity 3D Q2/Q1 16^3 periodic f64",
)
# K1/K2's 2D Q3/Q2 instance on the 256 x 512-cell box (2,363,906 + 525,825
# = 2,889,731 dofs, the 2D counterpart of the 48^3 probe box), every mode,
# each also timed in a CUDA graph
Q3_2D = (256, 512)
Q3_2D_CASES = (
    ("2D Q3/Q2 256x512 f64 const+ids", "float64", "ids"),
    ("2D Q3/Q2 256x512 f64 const", "float64", "const"),
    ("2D Q3/Q2 256x512 f64 variable", "float64", "variable"),
    ("2D Q3/Q2 256x512 f64 variable+ids+scale+norm", "float64", "all"),
    ("2D Q3/Q2 256x512 f64 velocity", "float64", "velocity"),
    ("2D Q3/Q2 256x512 f64 velocity variable", "float64", "velocity-variable"),
    ("2D Q3/Q2 256x512 f32 const+ids", "float32", "ids"),
    ("2D Q3/Q2 256x512 f32 variable+ids+scale+norm", "float32", "all"),
    ("2D Q3/Q2 256x512 f32 velocity", "float32", "velocity"),
)
# phase 2's cases of the nodal entries K1/K2: (label, dim, degree, cells per
# axis or lattice shape, dtype, mode)
NODAL_CASES = (
    ("3D Q2/Q1 16^3 f64 const+ids", 3, 2, 16, "float64", "ids"),
    ("3D Q2/Q1 16^3 f64 velocity", 3, 2, 16, "float64", "velocity"),
    ("3D Q2/Q1 48^3 f64 const+ids", 3, 2, 48, "float64", "ids"),
    ("3D Q2/Q1 48^3 f64 velocity", 3, 2, 48, "float64", "velocity"),
    ("3D Q2/Q1 48^3 f64 const", 3, 2, 48, "float64", "const"),
    ("3D Q2/Q1 48^3 f32 const", 3, 2, 48, "float32", "const"),
    ("3D Q2/Q1 48^3 f32 const+ids", 3, 2, 48, "float32", "ids"),
    ("3D Q2/Q1 48^3 f64 variable", 3, 2, 48, "float64", "variable"),
    ("3D Q2/Q1 48^3 f64 ids+scale+norm", 3, 2, 48, "float64", "norm"),
    ("2D Q2/Q1 256^2 f64 variable+ids+scale+norm", 2, 2, 256, "float64", "all"),
    ("2D Q2/Q1 256^2 f64 velocity", 2, 2, 256, "float64", "velocity"),
    ("3D Q3/Q2 16^3 f64 variable+ids+scale+norm", 3, 3, 16, "float64", "all"),
    ("3D Q3/Q2 16^3 f32 const+ids", 3, 3, 16, "float32", "ids"),
    ("3D Q3/Q2 16^3 f64 velocity", 3, 3, 16, "float64", "velocity"),
) + tuple((label, 2, 3, Q3_2D, dname, mode) for label, dname, mode in Q3_2D_CASES)
BLOCK_ENTRIES = (
    "coupled_apply_cells",
    "coupled_apply_cells_velocity",
    "coupled_apply_cells_qfields",
    "coupled_apply_cells_qfields_velocity",
    "coupled_apply_gather",
    "coupled_apply_gather_velocity",
)
# the periodic channel of the slice (adaflo_tpu/applications/periodic_channel.py
# on the uniform lattice): the JAX package's graded-channel test parameters
# with the coupled implicit Newton linearization, BDF-2, dt = 0.1 and 3 steps,
# of which phase 3 runs CHANNEL_STEPS; its tolerances (NL 1e-4, linear 1e-5)
# let Newton converge, and NL max iterations is 10 instead of 3 so that
# "converged" is Newton's own verdict
CHANNEL_STEPS = 2
CHANNEL_PRM = """
subsection Time stepping
  set scheme    = bdf_2
  set step size = 0.1
  set end time  = 0.3
end
subsection Navier-Stokes
  set physical type      = incompressible
  set dimension          = 3
  set global refinements = 16
  set velocity degree    = 2
  set viscosity          = 0.001472
  subsection Solver
    set linearization scheme         = coupled implicit Newton
    set NL max iterations            = 10
    set NL tolerance                 = 1.e-4
    set lin max iterations           = 50
    set lin tolerance                = 1.e-5
    set tau grad div                 = 1
  end
end
subsection Output options
  set output verbosity = 3
  set output vtk files = 0
end
"""
CHANNEL_ANCHORS = {
    "cells": " Number of active cells: 4096.",
    # velocity 32 x 33 x 32 nodes per component (x and z wrap), pressure
    # 16 x 17 x 16
    "dofs": " Number of degrees of freedom (velocity/pressure): 105728 (101376 + 4352).",
}
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


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> dict:
    """{"ms": mean of `reps` back-to-back applies, "call_ms": median of
    `reps` waited single applies}, CUDA events (scripts.time_ms)."""
    import torch

    from adaflo_tpu_torch.scripts import time_ms

    return time_ms(fn, torch.device("cuda", 0), reps, warmup)


def bound(cells, dtype: str, n_u: int, n_p: int, velocity_only: bool, variable: bool,
          n_coeffs: int = 3):
    """(bytes, flops, bound_ms, bound_by) of one apply: every input read
    once (`n_coeffs` per-q-point coefficient fields when `variable`), every
    output written once; the operations of scripts.cell_flops at the dtype's
    peak rate."""
    from adaflo_tpu_torch.scripts import cell_flops, roofline

    s = 4 if dtype == "float32" else 8
    dim, E = cells.dim, cells.n_cells
    nl, npl = (cells.degree + 1) ** dim, cells.degree**dim
    nbytes = 2 * dim * n_u * s + E * nl * 4 + dim * n_u  # u, u*, cell table, mask
    nbytes += dim * n_u * s  # output
    if not velocity_only:
        nbytes += n_p * s + E * npl * 4 + n_p + n_p * s
    if variable:
        nbytes += n_coeffs * E * cells.n_q * s
    flops = E * sum(cell_flops(
        dim, cells.degree + 1, cells.degree + 1, cells.degree, variable, velocity_only
    ).values())
    r = roofline(nbytes, flops, dtype)
    return nbytes, flops, r["bound_ms"], r["bound_by"]


def bound_block(name: str, cells, dtype: str, n_u: int, n_p: int):
    """(bytes, flops, bound_ms, bound_by) of one apply of a cell-block entry:
    K3 reads the (E, n_cols) block and the u* stream and writes the block;
    K4 reads K1's nodal inputs (vectors, cell tables, masks) and writes the
    block."""
    from adaflo_tpu_torch.scripts import cell_flops, roofline

    s = 4 if dtype == "float32" else 8
    dim, E, nq = cells.dim, cells.n_cells, cells.n_q
    nl, npl = (cells.degree + 1) ** dim, cells.degree**dim
    velocity = name.endswith("_velocity")
    qfields = "_qfields" in name
    ldx = dim * nl + (0 if velocity else npl)
    if name.startswith("coupled_apply_cells"):
        nbytes = E * (2 * ldx + (dim * (dim + 1) * nq if qfields else dim * nl)) * s
    else:
        nbytes = 2 * dim * n_u * s + E * nl * 4 + E * ldx * s
        nbytes += 0 if cells.mask_u is None else dim * n_u
        if not velocity:
            nbytes += n_p * s + E * npl * 4 + (0 if cells.mask_p is None else n_p)
    flops = E * sum(cell_flops(
        dim, cells.degree + 1, cells.degree + 1, cells.degree, False, velocity, qfields
    ).values())
    r = roofline(nbytes, flops, dtype)
    return nbytes, flops, r["bound_ms"], r["bound_by"]


def operator_case(dim: int, degree: int, n, dtype, device, periodic: bool, seed: int):
    """The port's NavierStokesOperator on an n^dim lattice (n an int) or an
    n[0] x n[1] (x n[2]) one (n a tuple) with random nodal u, p, u* (numpy
    seed) and the linearization at u*: the periodic channel pattern (x and z
    wrap, Dirichlet walls at y = +-1, anisotropic cells) or the box
    [-1, 1]^dim with Dirichlet rows on every side and a pinned pressure
    dof."""
    import torch

    from adaflo_tpu_torch.fe.constraints import Constraints
    from adaflo_tpu_torch.fe.space import ScalarSpace
    from adaflo_tpu_torch.mesh.structured import StructuredMesh
    from adaflo_tpu_torch.ops.navier_stokes import NavierStokesOperator, TimeWeights
    from adaflo_tpu_torch.parameters import FlowParameters

    if periodic:
        lo, hi = (0.0, -1.0, 0.0)[:dim], (2 * np.pi, 1.0, 2 * np.pi / 3)[:dim]
    else:
        lo, hi = (-1.0,) * dim, (1.0,) * dim
    mesh = StructuredMesh(tuple(n) if isinstance(n, tuple) else (n,) * dim, lo, hi)
    if periodic:
        for axis in (0, 2)[: dim - 1]:
            mesh.set_periodic(axis)
    us, ps = ScalarSpace(mesh, degree), ScalarSpace(mesh, degree - 1)
    cu = [Constraints(us.n_dofs) for _ in range(dim)]
    for c in cu:
        c.add_dirichlet(us.boundary_dofs(0))
    cp = Constraints(ps.n_dofs)
    if not periodic:
        cp.add_dirichlet(ps.boundary_dofs(0)[:1])
    for c in cu + [cp]:
        c.close()
    par = FlowParameters.from_string(
        f"subsection Navier-Stokes\n set dimension = {dim}\n"
        f" set velocity degree = {degree}\n set viscosity = 0.05\n"
        " set damping = 0.2\n subsection Solver\n  set tau grad div = 0.3\n"
        " end\nend\n"
    )
    op = NavierStokesOperator(par, us, ps, cu, cp, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    kw = dict(dtype=dtype, device=device)
    u = torch.as_tensor(rng.standard_normal((dim, us.n_dofs_padded)), **kw)
    p = torch.as_tensor(rng.standard_normal(ps.n_dofs_padded), **kw)
    s = torch.as_tensor(rng.standard_normal((dim, us.n_dofs_padded)), **kw)
    tw = TimeWeights(1.5 / 0.1, -2.0 / 0.1, 0.5 / 0.1, 1.0)
    lin = op.residual_assemble(s, p, s, s, tw)[2]
    return op, u, p, s, tw, lin


def rel_err(got, ref) -> float:
    """Largest max-abs error over max-abs among the outputs (velocity,
    pressure, norm), each held to its own scale."""
    return max(
        float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
        for a, b in zip(got, ref)
    )


def check_kernels(device):
    """Phase 2: every mode against the plain version; returns the timing
    records of every case (the main-path mode at 16^3 and 48^3, and K1/K2's
    2D Q3/Q2 instance on the 256 x 512 box, Q3_2D_CASES). Consecutive cases
    on one lattice and dtype share its operator and inputs."""
    import torch

    from adaflo_tpu_torch.ops import coupled_matvec as cm

    sc = cm.ApplyScalars(0.5, 30.0, 1.0, 1.0, 1.0, 0.0, 0.0)
    sc_var = cm.ApplyScalars(0.5, 30.0, 1.0, 1.3, 0.05, -0.2, 0.7)
    records = {}
    built = {}  # the last case's operator and inputs, reused by the next on its lattice
    for label, dim, degree, n, dname, mode in NODAL_CASES:
        dtype = getattr(torch, dname)
        key = (dim, degree, n, dtype)
        if key not in built:
            built.clear()
            seed = 1000 + (n if isinstance(n, int) else n[0])
            built[key] = operator_case(dim, degree, n, dtype, device, False, seed)
        op, u, p, s, _, _ = built[key]
        cells = op.cells
        rng = np.random.default_rng(n if isinstance(n, int) else n[0])
        coeffs = tuple(
            torch.as_tensor(
                rng.uniform(0.5, 2.0, (cells.n_cells, cells.n_q)), dtype=dtype, device=device
            )
            for _ in range(3)
        )
        variable = mode in ("variable", "all", "velocity-variable")
        scal = sc_var if variable else sc
        kw = dict(coeffs=coeffs if variable else None)
        if mode.startswith("velocity"):
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
        t = cuda_ms(run)
        ms = t["ms"]
        if label in GRAPH_TIMED or label.startswith("2D Q3/Q2"):
            t["graph_ms"] = graph_ms(run)
        plain_ms = cuda_ms(plain, warmup=1, reps=5)["ms"]
        nbytes, flops, bms, by = bound(
            cells, dname, u.shape[1], p.shape[0], mode.startswith("velocity"), variable
        )
        print(
            f"kernel {label}: rel err {err:.3e} (max abs {max_abs:.3e}), "
            f"{ms:.4f} ms/apply (one waited call {t['call_ms']:.4f} ms"
            + (f", in a CUDA graph {t['graph_ms']:.4f} ms" if "graph_ms" in t else "")
            + f"), plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)",
            flush=True,
        )
        if not err <= TOL[dname]:
            raise AssertionError(f"{label}: relative error {err:.3e} > {TOL[dname]}")
        records[label] = dict(
            max_abs_err=max_abs, rel_err=err, ms=ms, call_ms=t["call_ms"], plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops,
            graph_ms=t.get("graph_ms"),
        )
    return records


def check_block_entries(device):
    """Phase 2, cell-block entries: K3 (dof and q-field streams) and K4,
    coupled and velocity-only, against their plain versions in every mode,
    and the operator's K3/K4 routes against K1 on the same inputs. Returns
    the timing records by (entry, case label)."""
    import torch

    from adaflo_tpu_torch.ops import coupled_matvec as cm

    records = {}
    cases = [
        # (label, dim, degree, cells per axis, dtype, periodic)
        ("3D Q2/Q1 16^3 periodic f64", 3, 2, 16, torch.float64, True),
        ("3D Q2/Q1 16^3 periodic f32", 3, 2, 16, torch.float32, True),
        ("3D Q2/Q1 48^3 f64", 3, 2, 48, torch.float64, False),
        ("3D Q2/Q1 48^3 f32", 3, 2, 48, torch.float32, False),
        ("2D Q2/Q1 256^2 periodic f64", 2, 2, 256, torch.float64, True),
        ("2D Q2/Q1 256^2 f32", 2, 2, 256, torch.float32, False),
        ("3D Q3/Q2 16^3 f64", 3, 3, 16, torch.float64, False),
        ("3D Q3/Q2 16^3 periodic f32", 3, 3, 16, torch.float32, True),
    ]
    for label, dim, degree, n, dtype, periodic in cases:
        op, u, p, s, tw, lin = operator_case(dim, degree, n, dtype, device, periodic, 2000 + n)
        dname = str(dtype).split(".")[-1]
        cells, sc = op.cells, op._apply_scalars(tw)
        nl = cells.ev_u.n_local
        x = torch.cat(
            [op.lat_u.gather(u[c]) for c in range(dim)] + [op.lat_p.gather(p)], dim=1
        )
        xv = x[:, : dim * nl].contiguous()
        dofs = lin.dofs.reshape(cells.n_cells, -1).contiguous()
        qf = op.qfields(lin)
        args = {
            "coupled_apply_cells": ((x, dofs), {}),
            "coupled_apply_cells_velocity": ((xv, dofs), {"velocity_only": True}),
            "coupled_apply_cells_qfields": ((x, qf), {}),
            "coupled_apply_cells_qfields_velocity": ((xv, qf), {"velocity_only": True}),
            "coupled_apply_gather": ((u, p, s), {}),
            "coupled_apply_gather_velocity": ((u, None, s), {}),
        }
        for name in BLOCK_ENTRIES:
            a, kw = args[name]
            fn = cm.coupled_apply_cells if "_cells" in name else cm.coupled_apply_gather
            plain_fn = (
                cm.coupled_apply_cells_plain if "_cells" in name
                else cm.coupled_apply_gather_plain
            )
            run = lambda: fn(*a, cells, sc, **kw)
            plain = lambda: plain_fn(*a, cells, sc, **kw)
            got, ref = run(), plain()
            torch.cuda.synchronize()
            err = rel_err([got], [ref])
            max_abs = float((got - ref).abs().max())
            t = cuda_ms(run)
            ms = t["ms"]
            if f"{name} {label}" in GRAPH_TIMED:
                t["graph_ms"] = graph_ms(run)
            plain_ms = cuda_ms(plain, warmup=1, reps=5)["ms"]
            nbytes, flops, bms, by = bound_block(name, cells, dname, u.shape[1], p.shape[0])
            print(
                f"kernel {name} {label}: rel err {err:.3e} (max abs {max_abs:.3e}), "
                f"{ms:.4f} ms/apply (one waited call {t['call_ms']:.4f} ms"
                + (f", in a CUDA graph {t['graph_ms']:.4f} ms" if "graph_ms" in t else "")
                + f"), plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
                f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)",
                flush=True,
            )
            if not err <= TOL[dname]:
                raise AssertionError(f"{name} {label}: relative error {err:.3e} > {TOL[dname]}")
            records[(name, label)] = dict(
                max_abs_err=max_abs, rel_err=err, ms=ms, call_ms=t["call_ms"], plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops,
                graph_ms=t.get("graph_ms"),
            )
        if dim == 3 and degree == 2 and dname == "float64":
            check_routes(label, op, u, p, tw, lin)
        del op, u, p, s, lin, x, xv, dofs, qf
        torch.cuda.empty_cache()
    return records


def check_routes(label, op, u, p, tw, lin):
    """The operator's apply through K1 (nodal), K3 behind the lattice gather
    and scatter (dof and q-field streams) and K4 behind the scatter, on the
    same inputs, identity rows included: each against K1, with its time per
    apply (gather and scatter included)."""
    import torch

    for pres in (True, False):
        ref = None
        for route in ("nodal", "cells", "qfields", "gather"):
            run = lambda: op.cell_apply(u, p if pres else None, tw, lin, route)
            got = [r for r in run() if r is not None]
            torch.cuda.synchronize()
            t = cuda_ms(run)
            if ref is None:
                ref = got
            err = rel_err(got, ref)
            print(
                f"route {label} {'vmult' if pres else 'velocity_vmult'} {route}: "
                f"rel err against K1 {err:.3e}, {t['ms']:.4f} ms/apply (one waited call "
                f"{t['call_ms']:.4f} ms)",
                flush=True,
            )
            if not err <= TOL["float64"]:
                raise AssertionError(f"route {route} {label}: relative error {err:.3e}")


def check_probe_entries(device):
    """Phase 2, probe instances: every K12/K13 variant, K11 and K6 against
    their plain versions on the box with Dirichlet rows at 16^3 and 48^3,
    float64 and float32. Returns the records by (entry, case label)."""
    import torch

    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.scripts import joint_err

    records = {}
    for n in (16, 48):
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            label = f"3D Q2/Q1 {n}^3 {dname}"
            op, u, p, s, tw, _ = operator_case(3, 2, n, dtype, device, False, 3000 + n)
            cells, sc = op.cells, op._apply_scalars(tw)
            rng = np.random.default_rng(n)
            block = torch.as_tensor(rng.standard_normal((cells.n_cells, 89)), dtype=dtype,
                                    device=device)
            checks = {
                f"coupled_apply_ablated[{v}]": (
                    lambda v=v: cm.coupled_apply_ablated(u, p, s, cells, sc, v),
                    lambda v=v: cm.coupled_apply_ablated_plain(u, p, s, cells, sc, v),
                )
                for v in cm.VARIANTS
            }
            checks["coupled_apply_lattice"] = (
                lambda: cm.coupled_apply_lattice(u, p, s, cells, sc),
                lambda: cm.coupled_apply_plain(u, p, s, cells, sc),
            )
            # K6 adds into nonzero outputs
            checks["scatter_cells"] = (
                lambda: cm.scatter_cells(block, cells, u.clone(), p.clone()),
                lambda: cm.scatter_cells_plain(block, cells, u.clone(), p.clone()),
            )
            for name, (run, plain) in checks.items():
                got, ref = run(), plain()
                torch.cuda.synchronize()
                max_abs, err = joint_err(got, ref)
                del got, ref
                t = cuda_ms(run)
                plain_ms = cuda_ms(plain, warmup=1, reps=5)["ms"]
                print(
                    f"kernel {name} {label}: rel err {err:.3e} (max abs {max_abs:.3e}), "
                    f"{t['ms']:.4f} ms/apply (one waited call {t['call_ms']:.4f} ms), "
                    f"plain {plain_ms:.4f} ms",
                    flush=True,
                )
                if not err <= TOL[dname]:
                    raise AssertionError(f"{name} {label}: relative error {err:.3e} > {TOL[dname]}")
                records[(name, label)] = dict(max_abs_err=max_abs, rel_err=err, **t,
                                              plain_ms=plain_ms)
            del op, u, p, s, block, checks
            torch.cuda.empty_cache()
    return records


# K6's lattices beyond the probe boxes: the periodic channel's 16^3 (x and z
# wrap), every axis periodic (uneven too), and one that its 8 x 4 x 4 tile
# divides on no axis
SCATTER_LATTICES = {
    "16^3 periodic x, z": ((16, 16, 16), (True, False, True)),
    "20x12x9 periodic x, y, z": ((20, 12, 9), (True, True, True)),
    "17x9x5": ((17, 9, 5), (False, False, False)),
}


def scatter_case(shape, periodic, dtype, device, seed: int):
    """Q2/Q1 cells of a uniform lattice with its periodic axes (tables from
    the port's LatticeOps, lattice shape attached), a random (E, 89) block
    and random nonzero nodal outputs (numpy seed)."""
    import torch

    from adaflo_tpu_torch.fe.space import ScalarSpace
    from adaflo_tpu_torch.mesh.structured import StructuredMesh
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.ops.lattice import LatticeOps
    from adaflo_tpu_torch.ops.tensor import CellEvaluator

    mesh = StructuredMesh(shape, (0.0,) * 3, (1.0,) * 3)
    for axis, wraps in enumerate(periodic):
        if wraps:
            mesh.set_periodic(axis)
    us, ps = ScalarSpace(mesh, 2), ScalarSpace(mesh, 1)
    cells = cm.CoupledCells(
        CellEvaluator(3, us.basis, 3, mesh.h, device=device),
        CellEvaluator(3, ps.basis, 3, mesh.h, device=device),
        LatticeOps.for_space(us).cell_dof_table(), LatticeOps.for_space(ps).cell_dof_table(),
        None, None, device, lattice=(mesh.n_cells_axis, tuple(mesh.periodic)),
    )
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=device)
    return cells, t(cells.n_cells, 89), t(3, us.n_dofs), t(ps.n_dofs)


def check_scatter_lattices(device):
    """Phase 2, K6 beyond the probe boxes (which check_probe_entries holds):
    the tiled scatter against scatter_cells_plain into nonzero outputs on
    SCATTER_LATTICES in float64 (1e-12) and float32 (1e-5); cells without a
    lattice shape must raise ValueError on the card; then K6's device time
    at the probes' 48^3 box in a CUDA graph of 20 calls (graph_ms) in both
    types. Returns {"errors": {label: rel err}, "graph_ms": {dtype: ms}}."""
    import torch

    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.scripts import joint_err

    errors = {}
    for i, (name, (shape, periodic)) in enumerate(SCATTER_LATTICES.items()):
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype)[6:]
            cells, block, u, p = scatter_case(shape, periodic, dtype, device, 700 + i)
            got = cm.scatter_cells(block, cells, u.clone(), p.clone())
            ref = cm.scatter_cells_plain(block, cells, u.clone(), p.clone())
            torch.cuda.synchronize()
            max_abs, err = joint_err(got, ref)
            label = f"{name} {dname}"
            print(f"kernel scatter_cells {label}: rel err {err:.3e} (max abs {max_abs:.3e}), "
                  f"tolerance {TOL[dname]:g}", flush=True)
            if not err <= TOL[dname]:
                raise AssertionError(f"scatter_cells {label}: relative error {err:.3e}")
            errors[label] = err
    cells.lattice = None
    try:
        cm.scatter_cells(block, cells, u, p)
    except ValueError as exc:
        if "no lattice shape" not in str(exc):
            raise
    else:
        raise AssertionError("scatter_cells launched on cells without a lattice shape")
    graph = {}
    for dtype in (torch.float64, torch.float32):
        cells, block, u, p = scatter_case((48, 48, 48), (False,) * 3, dtype, device, 748)
        graph[str(dtype)[6:]] = graph_ms(lambda: cm.scatter_cells(block, cells, u, p))
        del cells, block, u, p
    print("K6 device time at 48^3, CUDA graph of 20 calls (ms): " + json.dumps(graph), flush=True)
    torch.cuda.empty_cache()
    return {"errors": errors, "graph_ms": graph}


def sf_cases(device, block: int, nblk: int, cols, seed: int, timed: bool):
    """Phase 2's cases of ops/probe_kernels: (label, counter, run, plain,
    tolerance). Always K7 at 72 statements, aligned and shifted (a mode the
    drivers do not time), and K9 at every (m, k) of DOT_SHAPES in every
    precision; with `timed`, also the configurations that probe_sf times
    (probe_sf.probes, float32 and float64) and K5 in every precision over
    each of `cols` columns. Tolerances: the drivers' (probe_sf.TOL and
    DOT_TOL, probe_mxu.TOL), K8 exact."""
    import torch

    from adaflo_tpu_torch.ops import probe_kernels as pk
    from adaflo_tpu_torch.scripts import probe_mxu, probe_sf

    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, dtype=torch.float64).to(device=device, dtype=dtype)

    cases = []
    for dtype in (torch.float32, torch.float64):
        d = str(dtype)[6:]
        if timed:
            for _, _, cfgs in probe_sf.probes(block, nblk, dtype, device, seed).values():
                cases += [(f"{c['name']} {d}", c["counter"], c["run"], c["plain"], c["tol"])
                          for c in cfgs]
        x7 = rnd(96, block + 128, dtype=dtype)
        for shifted in (False, True):
            cases.append((f"row_fma n_ops=72{' shifted' if shifted else ''} {d}", "row_fma",
                          lambda sh=shifted, x=x7: pk.row_fma(x, 72, sh, nblk),
                          lambda sh=shifted, x=x7: pk.row_fma_plain(x, 72, sh, nblk),
                          probe_sf.TOL[d]))
        if timed:  # K7 with a tail tile: 200 columns, 3 tiles of 64 and 8
            x7t = rnd(96, 200 + 128, dtype=dtype)
            for n in pk.N_OPS:
                for shifted in (False, True):
                    cases.append((f"row_fma n_ops={n}{' shifted' if shifted else ''} block=200 {d}",
                                  "row_fma",
                                  lambda n=n, sh=shifted, x=x7t: pk.row_fma(x, n, sh, nblk),
                                  lambda n=n, sh=shifted, x=x7t: pk.row_fma_plain(x, n, sh, nblk),
                                  probe_sf.TOL[d]))
    for prec in pk.PRECISIONS:
        dtype = torch.float64 if prec == "f64" else torch.float32
        for m, k in pk.DOT_SHAPES:
            A, x = rnd(m, k, dtype=dtype), rnd(k, block, dtype=dtype)
            cases.append((f"dense_dot {prec} m={m} k={k}", f"dense_dot[{prec}]",
                          lambda A=A, x=x, p=prec: pk.dense_dot(A, x, p, nblk),
                          lambda A=A, x=x, p=prec: pk.dense_dot_plain(A, x, p, nblk),
                          probe_sf.DOT_TOL[prec]))
    if timed:
        for prec in pk.PRECISIONS:
            for n in cols:
                A5, X5 = (rnd(*s, dtype=probe_mxu.TYPES[prec]) for s in ((384, 96), (96, n)))
                cases.append((f"dense_dot_streamed {prec} cols={n}",
                              f"dense_dot_streamed[{prec}]",
                              lambda A=A5, X=X5, p=prec: pk.dense_dot_streamed(A, X, p),
                              lambda A=A5, X=X5, p=prec: pk.dense_dot_streamed_plain(A, X, p),
                              probe_mxu.TOL[prec]))
    return cases


def check_sf_entries(device):
    """Phase 2, the contraction-rate probes (K5, K7-K10): every entry of
    ops/probe_kernels in every mode against its plain version on the card,
    at a small shape (block 256, 2 steps; K5 over 1,024 columns, one tile of
    64 and 1,088, 17 tiles: fewer work items than blocks, and an odd count),
    and K7's untimed mode and K9 at every (m, k) and precision also at the
    scripts' defaults (block 4096, 29 steps); phase 4 holds the timed ones
    to the same tolerances there. Returns the errors by (label, shape)."""
    import torch

    records = {}
    for shape, (block, nblk, cols, timed) in (("small", (256, 2, (1024, 64, 1088), True)),
                                              ("default", (4096, 29, (), False))):
        for label, counter, run, plain, tol in sf_cases(device, block, nblk, cols, 5, timed):
            got, ref = run(), plain()
            torch.cuda.synchronize()
            got, ref = got.double(), ref.double()
            max_abs = float((got - ref).abs().max())
            err = max_abs / max(float(ref.abs().max()), 1e-300)
            print(f"kernel {label} ({shape}): rel err {err:.3e} (max abs {max_abs:.3e}), "
                  f"tolerance {tol:g}", flush=True)
            if not err <= tol:
                raise AssertionError(f"{label} ({shape}): relative error {err:.3e} > {tol:g}")
            records[(label, shape)] = dict(max_abs_err=max_abs, rel_err=err, counter=counter)
            del got, ref
        torch.cuda.empty_cache()
    for label, counter, run, plain in partial_group_cases(device, 5):
        got, ref = run(), plain()
        torch.cuda.synchronize()
        max_abs = float((got.double() - ref.double()).abs().max())
        err = max_abs / max(float(ref.double().abs().max()), 1e-300)
        tol = 0.0 if counter == "row_copies" else TOL[str(got.dtype)[6:]]
        print(f"kernel {label} (partial step group): rel err {err:.3e} (max abs {max_abs:.3e}), "
              f"tolerance {tol:g}", flush=True)
        if not err <= tol:
            raise AssertionError(f"{label} (partial step group): relative error {err:.3e} > {tol:g}")
        records[(label, "partial")] = dict(max_abs_err=max_abs, rel_err=err, counter=counter)
    return records


def resident_graph_ms(device, seed: int = 5) -> dict:
    """Phase 2: the device time of K8 (29 and 89 rows, block 4096, 29 steps)
    and K10 (block 2048, 58 steps), float32 and float64, at the scripts'
    defaults: one replay of a CUDA graph of 20 calls (graph_ms), no host
    work between the kernels; phase 4's back-to-back time also holds the
    host's issue of each call. {"<probe_sf config> <dtype>": ms}."""
    import torch

    from adaflo_tpu_torch.ops import probe_kernels as pk

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for dtype in (torch.float32, torch.float64):
        d = str(dtype)[6:]
        x8 = torch.randn((32, 4096 + pk.SLAB_PAD), generator=gen, dtype=torch.float64).to(
            device=device, dtype=dtype)
        x10 = x8[:, :2048 + pk.SLAB_PAD].contiguous()
        for n in pk.N_ROWS:
            out[f"copies[n_rows={n}] {d}"] = graph_ms(lambda n=n: pk.row_copies(x8, n, 29))
        out[f"sfeval {d}"] = graph_ms(lambda: pk.sf_eval(x10, 58))
        del x8, x10
    print("K8/K10 device time, CUDA graph of 20 calls (ms): " + json.dumps(out), flush=True)
    return out


def partial_group_cases(device, seed: int):
    """K8 (block 4096, both row counts) and K10 (block 2048) in float32 and
    float64 at the first step count from 13 whose step groups on this card
    (ops/probe_kernels.resident_plan) do not all take as many steps: (label,
    counter, run, plain)."""
    import torch

    from adaflo_tpu_torch.ops import probe_kernels as pk

    gen = torch.Generator().manual_seed(seed)
    cases = []
    for dtype in (torch.float32, torch.float64):
        for name, block, n_rows in (("row_copies", 4096, 29), ("row_copies", 4096, 89),
                                    ("sf_eval", 2048, 89)):
            nblk = next((n for n in range(13, 64)
                         if n % pk.resident_plan(name, dtype, block, n, n_rows)["groups"]), None)
            if nblk is None:
                raise AssertionError(f"{name}: no step count in 13..63 with uneven step groups")
            groups = pk.resident_plan(name, dtype, block, nblk, n_rows)["groups"]
            x = torch.randn((32, block + pk.SLAB_PAD), generator=gen, dtype=torch.float64).to(
                device=device, dtype=dtype)
            label = (f"{name}{f' n_rows={n_rows}' if name == 'row_copies' else ''} block={block} "
                     f"nblk={nblk} ({groups} groups) {str(dtype)[6:]}")
            if name == "row_copies":
                cases.append((label, name, lambda x=x, n=n_rows, b=nblk: pk.row_copies(x, n, b),
                              lambda x=x, n=n_rows, b=nblk: pk.row_copies_plain(x, n, b)))
            else:
                cases.append((label, name, lambda x=x, b=nblk: pk.sf_eval(x, b),
                              lambda x=x, b=nblk: pk.sf_eval_plain(x, b)))
    return cases


def run_probes():
    """Phase 4: the four probe drivers at the probes' 48^3 box, float64 and
    float32, with the launch counts from 0; every probe entry must launch."""
    import torch

    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.scripts import (
        probe_pr,
        probe_pr_grouped,
        probe_pr_parts,
        probe_pr_phases,
    )

    reset_counts(cm)
    t0 = time.perf_counter()
    results = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for key, mod in (("K12", probe_pr_phases), ("K13", probe_pr_parts),
                         ("K6", probe_pr), ("K11", probe_pr_grouped)):
            results[(key, dname)] = mod.run(48, 20, dtype)
            sys.stdout.flush()
            torch.cuda.empty_cache()
    for (key, dname), res in results.items():
        if key == "K13":
            full = res["full"]
            print(f"K13 schedules, 48^3 {dname}: " + ", ".join(
                f"{v} {res[v]['ms']:.4f} ms ({res[v]['ms'] / full['ms']:.3f} x full)"
                for v in cm.K13_SCHEDULES
            ) + f"; full {full['ms']:.4f} ms, bound {full['bound_ms']:.4f} ms", flush=True)
    launches, plain = dict(cm.launches), dict(cm.plain_calls)
    probe_entries = [f"coupled_apply_ablated[{v}]" for v in cm.VARIANTS]
    probe_entries += ["coupled_apply_lattice", "scatter_cells"]
    checks = {
        "every_probe_entry": all(launches[k] > 0 for k in probe_entries),
        "errors": all(
            r["rel_err"] <= TOL[dname]
            for (key, dname), res in results.items() for r in res.values()
        ),
    }
    print(
        f"probes: {time.perf_counter() - t0:.1f} s, launches "
        + json.dumps({k: launches[k] for k in probe_entries})
        + f", plain calls {json.dumps({k: v for k, v in plain.items() if v})}, checks {checks}",
        flush=True,
    )
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"probe checks failed: {failed}")
    return dict(results=results, launches=launches)


def run_sf_probes():
    """Phase 4, the contraction-rate probes: probe_sf at its defaults in
    float32 and float64 and probe_mxu at its defaults, with the launch
    counts of ops/probe_kernels from 0; every entry (the dot in every
    precision) must launch, and every configuration meet its tolerance."""
    import torch

    from adaflo_tpu_torch.ops import probe_kernels as pk
    from adaflo_tpu_torch.scripts import probe_mxu, probe_sf

    reset_counts(pk)
    t0 = time.perf_counter()
    sf = {d: probe_sf.run(dtype=getattr(torch, d)) for d in ("float32", "float64")}
    sys.stdout.flush()
    mxu = probe_mxu.run()
    launches = dict(pk.launches)
    records = [r for res in sf.values() for r in res["configs"].values()]
    records += [r for k, r in mxu.items() if k.startswith("K5 ")]
    checks = {
        "every_entry": all(v > 0 for v in launches.values()),
        "errors": all(r["rel_err"] <= r["tol"] for r in records),
    }
    print(f"contraction-rate probes: {time.perf_counter() - t0:.1f} s, launches "
          + json.dumps(launches) + f", checks {checks}", flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"contraction-rate probe checks failed: {failed}")
    return dict(sf=sf, mxu=mxu, launches=launches)


def check_schedule_build(cm):
    """Phase 1: K13's schedules (and the one-shot full apply beside them) in
    the built library: the body each runs and its cells per group, ptxas
    registers, stack and spills, shared memory and resident blocks per SM at
    the probes' 48 cells along x, and SASS counts. Every schedule must hold
    its asynchronous copies (scripts.sass_counts.SCHEDULE_OPS), and no
    instance may spill or be missing from the ptxas report. Returns
    {"<name> <double|float>": record}."""
    import torch

    from adaflo_tpu_torch.scripts import sass_counts

    sass = sass_counts.schedule_counts(cm.library_path())
    ptxas = sass_counts.schedule_ptxas(cm.build_info.get("log", ""))
    out = {}
    for name in ("full",) + tuple(cm.K13_SCHEDULES):
        for t, dtype in (("double", torch.float64), ("float", torch.float32)):
            key = f"{name} {t}"
            c = sass.get(key, {})
            r = out[key] = dict(sass=c, **ptxas.get(key, {}),
                                **cm.schedule_residency(dtype, name, 48))
            print(f"schedule {key}: {r['body']} body, {r['cpb']} cells/group, "
                  f"{r.get('registers')} registers, stack {r.get('stack')} B, spills "
                  f"{r.get('spill_stores')} / {r.get('spill_loads')} B, {r['smem']} B shared, "
                  f"{r['blocks_per_sm']} blocks/SM ({r['cpb'] * r['blocks_per_sm']} cells/SM); "
                  "SASS " + ", ".join(
                      f"{op} {c.get(op, 0)}"
                      for op in ("LDGSTS", "UBLKCP", "SYNCS", "LDG", "LDS", "STS", "DFMA", "FFMA")),
                  flush=True)
    missing = sass_counts.check_schedules(sass)
    if missing:
        raise AssertionError(f"schedules without their asynchronous copies: {missing}")
    bad = [k for k, r in out.items()
           if r.get("registers") is None or r.get("spill_stores") or r.get("spill_loads")]
    if bad:
        raise AssertionError(f"schedule instances missing or spilling registers: {bad}")
    return out


def check_fma_build(pk):
    """Phase 1: K7's instances (row_fma_kernel, float32 and float64, n_ops
    24, 72, 96, aligned and shifted) in the built library: ptxas registers,
    stack and spills, and SASS counts. Each type and shift must show FP
    instructions that grow by 4 x 3 per statement and work item and LDS that
    do not grow with n_ops (sass_counts.check_fma), and no instance may
    spill or be missing. Returns {instance: record}."""
    from adaflo_tpu_torch.scripts import sass_counts

    sass = sass_counts.fma_counts(pk.library_path())
    ptxas = sass_counts.fma_ptxas(pk.build_info.get("log", ""))
    out = {}
    for t, ops in sass_counts.FMA_FP.items():
        for shift in ("aligned", "shifted"):
            for n in pk.N_OPS:
                key = f"{t} n_ops={n} {shift}"
                c = sass.get(key, {})
                r = out[key] = dict(sass=c, **ptxas.get(key, {}))
                shown = ops + ("LOP3", "LDS", "LDG", "STG")
                print(f"K7 {key}: {r.get('registers')} registers, stack {r.get('stack')} B, "
                      f"spills {r.get('spill_stores')} / {r.get('spill_loads')} B; SASS "
                      + ", ".join(f"{op} {c.get(op, 0)}" for op in shown)
                      + f", FP {sum(c.get(op, 0) for op in ops)}", flush=True)
    merged = sass_counts.check_fma(sass)
    if merged:
        raise AssertionError(f"K7 instances whose statements did not all survive: {merged}")
    bad = [k for k, r in out.items()
           if r.get("registers") is None or r.get("spill_stores") or r.get("spill_loads")]
    if bad:
        raise AssertionError(f"K7 instances missing or spilling registers: {bad}")
    return out


def check_resident_build(pk):
    """Phase 1: K8's and K10's instances (row_copies_kernel at 29 and 89
    rows, sf_eval_kernel; float32 and float64) in the built library: ptxas
    registers, stack and spills, the launch plan at the scripts' defaults
    (K8 block 4096, 29 steps; K10 2048, 58: tile columns, threads, shared
    memory, resident blocks per SM, step groups, work items, grid) and SASS
    counts. K8's step must be one LDS and one STS per copied row of a work
    item with no global store in the step loop (sass_counts.check_copies),
    K10's work item must compute every statement from registers
    (sass_counts.check_sfeval), and no instance may spill or be missing.
    Returns {"row_copies" | "sf_eval": {instance: record}}."""
    import torch

    from adaflo_tpu_torch.scripts import sass_counts

    log = pk.build_info.get("log", "")
    found = {"row_copies": (sass_counts.copies_counts(pk.library_path()),
                            sass_counts.copies_ptxas(log)),
             "sf_eval": (sass_counts.sfeval_counts(pk.library_path()),
                         sass_counts.sfeval_ptxas(log))}
    out = {"row_copies": {}, "sf_eval": {}}
    for t, dtype in (("float", torch.float32), ("double", torch.float64)):
        fp = sass_counts.FMA_FP[t]
        for name, key, plan in (
                *((("row_copies", f"{t} n_rows={n}", pk.resident_plan("row_copies", dtype, 4096, 29, n))
                   for n in pk.N_ROWS)),
                ("sf_eval", t, pk.resident_plan("sf_eval", dtype, 2048, 58))):
            sass, ptxas = found[name]
            c = sass.get(key, {})
            r = out[name][key] = dict(sass=c, **ptxas.get(key, {}), plan=plan)
            shown = fp + ("LOP3", "LDS", "STS", "LDG", "STG", "LDGSTS")
            print(f"{'K8' if name == 'row_copies' else 'K10'} {key}: {r.get('registers')} registers, "
                  f"stack {r.get('stack')} B, spills {r.get('spill_stores')} / "
                  f"{r.get('spill_loads')} B; tile {plan['tile_cols']} columns, {plan['threads']} "
                  f"threads, {plan['smem']} B shared, {plan['blocks_per_sm']} blocks/SM, "
                  f"{plan['groups']} step groups, {plan['items']} items, grid {plan['grid']}; SASS "
                  + ", ".join(f"{op} {c.get(op, 0)}" for op in shown)
                  + f", FP {sum(c.get(op, 0) for op in fp)}", flush=True)
    failed = {"K8": sass_counts.check_copies(found["row_copies"][0]),
              "K10": sass_counts.check_sfeval(found["sf_eval"][0])}
    if any(failed.values()):
        raise AssertionError(f"resident kernels whose SASS misses its design: {failed}")
    bad = [k for recs in out.values() for k, r in recs.items()
           if r.get("registers") is None or r.get("spill_stores") or r.get("spill_loads")]
    if bad:
        raise AssertionError(f"K8/K10 instances missing or spilling registers: {bad}")
    return out


def check_scatter_build(cm):
    """Phase 1: K6's instances (scatter_tiles_kernel, float64 and float32) in
    the built library: ptxas registers, stack and spills, SASS counts (the
    tile summed in shared memory without a shared-memory atomic, global
    atomics where tiles meet: sass_counts.check_scatter), and the launch plan
    at the probes' 48^3 box (tile, threads, shared memory per block,
    resident blocks per SM, grid). No instance may spill or be missing.
    Returns {"double" | "float": record}."""
    import torch

    from adaflo_tpu_torch.scripts import sass_counts

    sass = sass_counts.scatter_counts(cm.library_path())
    ptxas = sass_counts.scatter_ptxas(cm.build_info.get("log", ""))
    out = {}
    for t, dtype in (("double", torch.float64), ("float", torch.float32)):
        c = sass.get(t, {})
        plan = cm.scatter_plan(dtype, (48, 48, 48))
        r = out[t] = dict(sass=c, **ptxas.get(t, {}), plan=plan)
        print(f"K6 scatter_tiles_kernel<{t}>: {r.get('registers')} registers, stack "
              f"{r.get('stack')} B, spills {r.get('spill_stores')} / {r.get('spill_loads')} B; "
              f"tile {'x'.join(map(str, plan['tile']))} cells (one tile a block, no pencil), "
              f"{plan['threads']} threads, {plan['smem']} B shared, {plan['blocks_per_sm']} "
              f"blocks/SM, grid {plan['grid']} at 48^3; SASS " + ", ".join(
                  f"{op} {c.get(op, 0)}" for op in ("LDG", "STG", "LDS", "STS", "RED", "REDG",
                                                    "ATOMG", "ATOMS")), flush=True)
    bad = sass_counts.check_scatter(sass)
    if bad:
        raise AssertionError(f"K6 instances whose SASS misses the tiled scatter: {bad}")
    bad = [k for k, r in out.items()
           if r.get("registers") is None or r.get("spill_stores") or r.get("spill_loads")]
    if bad:
        raise AssertionError(f"K6 instances missing or spilling registers: {bad}")
    return out


def check_cell_build(cm):
    """Phase 1: every production instance of the cell kernel's one-shot body
    (each entry at each table set, float64 and float32) in the built
    library: ptxas registers, stack and spills, SASS LDS against DFMA and
    FFMA, and the launch geometry (cells per block, shared memory per block,
    resident blocks per SM). No instance may spill or be missing. Returns
    {instance: record}."""
    import torch

    from adaflo_tpu_torch.scripts import sass_counts

    sass = sass_counts.production_counts(cm.library_path())
    ptxas = sass_counts.production_ptxas(cm.build_info.get("log", ""))
    out = {}
    for dim, degree in cm.TABLE_SETS:
        for entry, mode, pres in cm.PRODUCTION_ENTRIES:
            for t, dtype in (("double", torch.float64), ("float", torch.float32)):
                key = sass_counts.production_name(entry, dim, degree, t)
                c = sass.get(key, {})
                r = out[key] = dict(sass=c, **ptxas.get(key, {}),
                                    **cm.cell_geometry(dtype, mode, pres, dim, degree))
                print(f"cell {key}: {r.get('registers')} registers, stack {r.get('stack')} B, "
                      f"spills {r.get('spill_stores')} / {r.get('spill_loads')} B, {r['cpb']} "
                      f"cells/block, {r['smem']} B shared, {r['blocks_per_sm']} blocks/SM "
                      f"({r['cpb'] * r['blocks_per_sm']} cells/SM); SASS " + ", ".join(
                          f"{op} {c.get(op, 0)}" for op in ("LDS", "STS", "DFMA", "FFMA", "LDG",
                                                            "STG")), flush=True)
    bad = [k for k, r in out.items()
           if r.get("registers") is None or not r["sass"] or r.get("spill_stores")
           or r.get("spill_loads")]
    if bad:
        raise AssertionError(f"cell kernel instances missing or spilling registers: {bad}")
    return out


def graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """The device time of one apply: CUDA events around one replay of a CUDA
    graph of `reps` applies, the median over `rounds` replays, per apply
    (no host work between the applies)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(rounds):
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def check_dot_build(pk):
    """Phase 1: the dense dot's instances (K5, K9) in the built library:
    SASS counts, each instance holding its design's instructions
    (scripts.sass_counts.DOT_OPS: TMA loads UTMALDG and mbarriers SYNCS;
    HGMMA in bf16 and TF32, DMMA in float64), ptxas registers and spills,
    and the launch plan (shared memory, resident blocks per SM, threads,
    tile columns, parts of A, stages). Returns {instance: record}."""
    from adaflo_tpu_torch.scripts import sass_counts

    sass = sass_counts.dot_counts(pk.library_path())
    ptxas = sass_counts.dot_ptxas(pk.build_info.get("log", ""))
    out = {}
    for key in sass_counts.dot_instances():
        prec, rest = key.split(" ", 1)
        m, k = (int(v) for v in rest.split(")")[0].strip("(").split(","))
        c = sass.get(key, {})
        out[key] = dict(sass=c, **ptxas.get(key, {}),
                        **pk.dot_plan(prec, m, k, streamed=rest.endswith("bf16")))
        r = out[key]
        print(f"dot {key}: {r.get('registers')} registers, spills {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} B, {r['smem']} B shared, {r['blocks_per_sm']} blocks/SM, "
              f"{r['threads']} threads, {r['tile_cols']}-column items, {r['parts']} part(s) of A, "
              f"{r['stages']} stages; SASS " + ", ".join(
                  f"{op} {c.get(op, 0)}"
                  for op in ("HGMMA", "DMMA", "FFMA", "UTMALDG", "SYNCS", "LDS", "STS", "STG")),
              flush=True)
    missing = sass_counts.check_dot(sass)
    if missing:
        raise AssertionError(f"dot instances without their design's instructions: {missing}")
    return out


def reset_counts(mod):
    for k in mod.launches:
        mod.launches[k] = 0
    for k in mod.plain_calls:
        mod.plain_calls[k] = 0


def run_steps(problem, n_steps, cm):
    """Time steps of a problem; per step: seconds, Newton and Krylov
    iterations, kernel launches."""
    import torch

    steps = []
    while len(steps) < n_steps and not problem.navier_stokes.time_stepping.at_end():
        before = dict(cm.launches)
        t0 = time.perf_counter()
        nl, lin = problem.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append(dict(
            seconds=dt, newton=nl, krylov=lin,
            launches={k: cm.launches[k] - before[k] for k in cm.launches if cm.launches[k] > before[k]},
        ))
    for st in steps:
        print(
            f"step: {st['seconds']:.3f} s, Newton {st['newton']}, Krylov "
            f"{st['krylov']}, launches {st['launches']}", flush=True,
        )
    return steps


def run_channel():
    """Phase 3, the periodic channel at 16^3 for CHANNEL_STEPS steps."""
    import torch

    from adaflo_tpu_torch.applications.periodic_channel import PeriodicChannelProblem
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.parameters import FlowParameters

    par = FlowParameters.from_string(CHANNEL_PRM)
    out = Tee()
    reset_counts(cm)
    t0 = time.perf_counter()
    problem = PeriodicChannelProblem(par, out=out)  # the default device
    problem.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps = run_steps(problem, CHANNEL_STEPS, cm)
    launches, plain = dict(cm.launches), dict(cm.plain_calls)
    ns = problem.navier_stokes
    u = ns.solution[0]
    walls = torch.as_tensor(ns.u_space.boundary_dofs(0), device=u.device)
    lines = out.getvalue().splitlines()
    k3 = ("coupled_apply_cells", "coupled_apply_cells_velocity")
    checks = {
        "cells": CHANNEL_ANCHORS["cells"] in lines,
        "dofs": CHANNEL_ANCHORS["dofs"] in lines,
        "periodic": list(ns.mesh.periodic) == [True, False, True],
        "converged": out.getvalue().count(" converged.") == CHANNEL_STEPS
        and len(steps) == CHANNEL_STEPS,
        "walls_zero": len(walls) > 0 and float(u[:, walls].abs().max()) == 0.0,
        "finite": bool(torch.isfinite(u).all()) and bool(torch.isfinite(ns.solution[1]).all()),
        "bounded": float(u.abs().max()) < 3.0,
        "k3_every_step": all(st["launches"].get(k, 0) > 0 for st in steps for k in k3),
        "no_other_entry": all(
            v == 0 for k, v in launches.items() if k not in k3
        ),
        "no_plain_calls": all(v == 0 for v in plain.values()),
    }
    print(
        f"channel: setup {setup_s:.3f} s, max |u| {float(u.abs().max()):.6f}, "
        f"checks {checks}", flush=True,
    )
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"periodic channel checks failed: {failed}")
    return dict(setup_s=setup_s, steps=steps, launches=launches)


def run_slice():
    """Phase 3: the Beltrami driver to t = 0.2, held to the anchors."""
    import torch

    from adaflo_tpu_torch.drivers.beltrami import BeltramiProblem
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.parameters import FlowParameters

    par = FlowParameters.from_file(str(ROOT / "tests" / "prms" / "beltrami_3d.prm"))
    par.end_time = 0.2
    out = Tee()
    reset_counts(cm)
    t0 = time.perf_counter()
    problem = BeltramiProblem(par, out=out)  # the default device, as a user runs it
    problem.setup()
    problem.output_results()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps = run_steps(problem, 4, cm)
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
        "no_other_entry": all(
            v == 0 for k, v in launches.items()
            if k not in ("coupled_apply", "coupled_apply_velocity")
        ),
        "no_plain_calls": all(v == 0 for v in plain.values()),
    }
    print(f"slice: setup {setup_s:.3f} s, checks {checks}", flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"slice anchors failed: {failed}")
    return dict(setup_s=setup_s, steps=steps, launches=launches)


RB3_PRM = ROOT / "tests" / "prms" / "rising_bubble_ls_3d_bench.prm"
RB2_PRM = ROOT / "tests" / "prms" / "rising_bubble_ls_short.prm"
RB2_GOLDEN = ROOT / "tests" / "golden" / "rising_bubble_ls_short.output"
RB3_STEPS = 6  # the first step and five more
RB3_ANCHORS = {
    "cells": "Number of active cells: 32768.",
    "ns_dofs": "Number of Navier-Stokes degrees of freedom: 859812 (823875 + 35937).",
    "ls_dofs": "Number of level set degrees of freedom: 35937.",
}
K12 = ("coupled_apply", "coupled_apply_velocity")


def check_flagship_variable(problem, device, label="32^3", graph: bool = False):
    """Phase 2 on a rising bubble's fields, after its setup: K1 (identity
    rows) and K2 in their variable-coefficient mode against their plain
    versions on the problem's spaces and constraints (the symmetric side
    faces make the velocity masks differ by component), rho/mu from the
    level set's compute_force on the initial bubble, random u, p and u*
    (numpy seed); float64 (1e-12) and float32 (1e-5, a float32 operator on
    the same spaces and constraints). Run on the 32^3 box of phase 3, on
    the 2D golden's 20 x 40 lattice and on the Q3 bubble's 10 x 20 (2D
    Q3/Q2). graph: also the device time of each in a CUDA graph."""
    import torch

    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.ops.navier_stokes import (
        Coefficients,
        NavierStokesOperator,
        TimeWeights,
    )

    solver = problem.solver
    ns = solver.navier_stokes
    _, rho, mu = solver.ops.compute_force(solver.heaviside, solver.solution[1])
    par = ns.parameters
    lo, hi = float(rho.min()), float(rho.max())
    band = float(((rho > lo + 1e-3) & (rho < hi - 1e-3)).double().mean())
    masks = ns.operator.cells.mask_u
    per_component = [int(m.sum()) for m in masks]
    print(
        f"rising bubble {label} fields: rho {lo:.6f} .. {hi:.6f} ({100 * band:.3f} % of the "
        f"q-points in the band), mu {float(mu.min()):.6f} .. {float(mu.max()):.6f}, "
        f"constrained velocity dofs per component {per_component}", flush=True,
    )
    checks = {
        "two_valued": abs(lo - (par.density + par.density_diff)) < 1e-2
        and abs(hi - par.density) < 1e-2 and 0.0 < band < 0.5,
        "masks_differ": len(set(per_component)) > 1 and not torch.equal(masks[0], masks[-1]),
    }
    if not all(checks.values()):
        raise AssertionError(f"flagship fields: {checks}")
    rng = np.random.default_rng(32)
    n_u, n_p, dim = ns.u_space.n_dofs_padded, ns.p_space.n_dofs_padded, par.dimension
    base = dict(
        u=rng.standard_normal((dim, n_u)), p=rng.standard_normal(n_p),
        s=rng.standard_normal((dim, n_u)),
    )
    tw = TimeWeights(1.5 / 0.02, -2.0 / 0.02, 0.5 / 0.02, 1.0)
    records = {}
    for dtype in (torch.float64, torch.float32):
        op = ns.operator if dtype == torch.float64 else NavierStokesOperator(
            par, ns.u_space, ns.p_space, ns.constraints_u, ns.constraints_p,
            dtype=dtype, device=device,
        )
        kw = dict(dtype=dtype, device=device)
        u, p, s = (torch.as_tensor(base[k], **kw) for k in "ups")
        cco = op._cell_coeffs(Coefficients(rho.to(dtype), mu.to(dtype), None))
        sc = op._apply_scalars(tw)
        cells = op.cells
        dname = str(dtype).split(".")[-1]
        pairs = {
            "coupled_apply": (
                lambda: cm.coupled_apply(u, p, s, cells, sc, coeffs=cco, identity=True),
                lambda: cm.coupled_apply_plain(u, p, s, cells, sc, coeffs=cco, identity=True),
            ),
            "coupled_apply_velocity": (
                lambda: (cm.coupled_apply_velocity(u, s, cells, sc, coeffs=cco),),
                lambda: (cm.coupled_apply_plain(
                    u, None, s, cells, sc, coeffs=cco, velocity_only=True),),
            ),
        }
        for name, (run, plain) in pairs.items():
            got, ref = list(run()), list(plain())
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            max_abs = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            t = cuda_ms(run)
            plain_ms = cuda_ms(plain, warmup=1, reps=5)["ms"]
            g_ms = graph_ms(run) if graph else None
            nbytes, flops, bms, by = bound(
                cells, dname, n_u, n_p, name.endswith("velocity"), True, n_coeffs=2
            )
            case = f"{name} {label} {dname} variable, symmetry masks"
            print(
                f"kernel {case}: rel err {err:.3e} (max abs {max_abs:.3e}), "
                f"{t['ms']:.4f} ms/apply (one waited call {t['call_ms']:.4f} ms"
                + (f", graph {g_ms:.4f} ms" if g_ms is not None else "")
                + f"), plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)", flush=True,
            )
            if not err <= TOL[dname]:
                raise AssertionError(f"{case}: relative error {err:.3e} > {TOL[dname]}")
            records[f"{name} {dname}"] = dict(
                max_abs_err=max_abs, rel_err=err, ms=t["ms"], call_ms=t["call_ms"],
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, graph_ms=g_ms,
            )
    return records


def run_rising_bubble_3d(device):
    """Phase 3, the 3D rising bubble at its flagship size: the prm's physics
    and solver tolerances on the driver's flagship mesh (32^3 cells, Q2/Q1
    and a Q1 level set, float64); setup, phase 2's check on its fields, then
    RB3_STEPS steps with the counts from 0, each step timed apart from its
    bubble statistics (host diagnostics)."""
    import torch

    from adaflo_tpu_torch.drivers import rising_bubble as rb
    from adaflo_tpu_torch.ops import coupled_matvec as cm

    par = rb.TwoPhaseParameters.from_file(str(RB3_PRM))
    par.global_refinements = 0
    out = Tee()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = rb.MicroFluidicProblem(par, out=out, mesh=rb.flagship_mesh_3d(32))
    problem.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"rising bubble 32^3: setup {setup_s:.3f} s", flush=True)
    var_rec = check_flagship_variable(problem, device)
    solver = problem.solver
    reset_counts(cm)
    steps = []
    for _ in range(RB3_STEPS):
        before = dict(cm.launches)
        t0 = time.perf_counter()
        newton, krylov = solver.advance_time_step()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = solver.compute_bubble_statistics()
        stats_s = time.perf_counter() - t0
        steps.append(dict(
            seconds=step_s, newton=int(newton), krylov=int(krylov), stats_s=stats_s,
            stats=[float(x) for x in stats],
            launches={k: cm.launches[k] - before[k] for k in cm.launches
                      if cm.launches[k] > before[k]},
        ))
        st = steps[-1]
        print(
            f"rising bubble 32^3 step {len(steps)}: {step_s:.3f} s, Newton {st['newton']}, "
            f"Krylov {st['krylov']}, launches {st['launches']}; statistics "
            f"{stats_s:.3f} s: t, volume, area, velocity (3), centre (3), sphericity "
            + json.dumps(st["stats"]), flush=True,
        )
    launches, plain = dict(cm.launches), dict(cm.plain_calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ns = solver.navier_stokes
    sections = {k: [v[0], round(v[1], 3)] for k, v in ns.timer.sections.items()}
    print(
        f"rising bubble 32^3 timer sections (calls, s): {sections}, "
        f"linear solves {round(ns.statistics.counters['lin solver'][1], 3)} s",
        flush=True,
    )
    text = out.getvalue()
    lines = [ln.strip() for ln in text.splitlines()]
    v0 = problem.solution_data[0][1]
    checks = {
        "cells": RB3_ANCHORS["cells"] in lines,
        "ns_dofs": RB3_ANCHORS["ns_dofs"] in lines,
        "ls_dofs": RB3_ANCHORS["ls_dofs"] in lines,
        "converged": text.count("/conv.]") == RB3_STEPS,
        "finite": all(np.isfinite(st["stats"]).all() for st in steps),
        "volume_kept": all(abs(st["stats"][1] - v0) < 0.05 * v0 for st in steps),
        "rising": all(st["stats"][5] > 0 for st in steps),
        "k1_k2_every_step": all(st["launches"].get(k, 0) > 0 for st in steps for k in K12),
        "no_other_entry": all(v == 0 for k, v in launches.items() if k not in K12),
        "no_plain_calls": all(v == 0 for v in plain.values()),
    }
    print(f"rising bubble 32^3: peak device memory {peak_gb:.3f} GB, checks {checks}", flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"3D rising bubble checks failed: {failed}")
    return dict(setup_s=setup_s, steps=steps, launches=launches, peak_gb=peak_gb,
                variable=var_rec)


def run_rising_bubble_2d(device):
    """Phase 3, the 2D golden on the card: the port's driver on
    rising_bubble_ls_short.prm (20 x 40 cells, 3 steps) held to its golden
    output with the port's compare_with_golden; after its setup, phase 2's
    check of K1/K2's variable mode on its fields and symmetry masks."""
    import torch

    from adaflo_tpu_torch.drivers import rising_bubble as rb
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.testing import compare_with_golden

    out = io.StringIO()
    t0 = time.perf_counter()
    problem = rb.MicroFluidicProblem(rb.TwoPhaseParameters.from_file(str(RB2_PRM)), out=out)
    problem.setup()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    var_rec = check_flagship_variable(problem, device, label="2D 20 x 40")
    # the counts from 0 after the check: they hold the time steps only
    reset_counts(cm)
    t0 = time.perf_counter()
    while not problem.solver.get_time_stepping().at_end():
        problem.step()
    torch.cuda.synchronize()
    seconds += time.perf_counter() - t0
    launches, plain = dict(cm.launches), dict(cm.plain_calls)
    compare_with_golden(out.getvalue(), RB2_GOLDEN)
    checks = {
        "steps": out.getvalue().count("Time step #") == 3,
        "k1_k2": all(launches[k] > 0 for k in K12),
        "no_other_entry": all(v == 0 for k, v in launches.items() if k not in K12),
        "no_plain_calls": all(v == 0 for v in plain.values()),
    }
    print(
        f"rising bubble 2D golden: {seconds:.3f} s, golden passed, launches "
        f"{ {k: v for k, v in launches.items() if v} }, checks {checks}", flush=True,
    )
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"2D rising bubble checks failed: {failed}")
    return dict(seconds=seconds, launches=launches, variable=var_rec)


RBQ3_PRM = ROOT / "tests" / "prms" / "rising_bubble_ls_q3_short.prm"


def check_rising_bubble_q3(device):
    """Phase 2 on the Q3 bubble's fields (rising_bubble_ls_q3_short.prm:
    10 x 20 cells, velocity degree 3), after its setup: K1 (identity rows)
    and K2 of the 2D Q3/Q2 instance in their variable mode against their
    plain versions, with their device times in a CUDA graph. Its steps run
    in a golden child of phase 3 (LATTICE_GOLDENS)."""
    import torch

    from adaflo_tpu_torch.drivers import rising_bubble as rb

    t0 = time.perf_counter()
    problem = rb.MicroFluidicProblem(
        rb.TwoPhaseParameters.from_file(str(RBQ3_PRM)), out=io.StringIO()
    )
    problem.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cells = problem.solver.navier_stokes.operator.cells
    if (cells.dim, cells.degree, cells.n_cells) != (2, 3, 200):
        raise AssertionError(f"Q3 bubble: cells {cells.dim}D degree {cells.degree}, "
                             f"{cells.n_cells} cells")
    print(f"rising bubble Q3 10 x 20: setup {setup_s:.3f} s", flush=True)
    return dict(setup_s=setup_s, variable=check_flagship_variable(
        problem, device, label="2D Q3 10 x 20", graph=True))


# the single-phase lattice drivers of the slice and their goldens: (golden,
# driver module, prm); the coupled Newton ones run K1/K2, the others the
# operator's plain cell route
SINGLE_PHASE = (
    ("couette", "couette", "couette"),
    ("poiseuille_ns_small", "poiseuille", "poiseuille_ns_small"),
    ("poiseuille_stokes", "poiseuille", "poiseuille_stokes"),
    ("poiseuille_stationary", "poiseuille", "poiseuille_stationary"),
    ("poiseuille_ns_proj_small", "poiseuille", "poiseuille_ns_proj_small"),
    ("flow_1d", "flow_1d", "flow_1d"),
    ("flow_1d_damped", "flow_1d", "flow_1d_damped"),
)
# the lattice goldens of the rising bubble's variants and of augmented
# Taylor-Hood: (golden = prm, driver module); the Q3 bubble runs K1/K2's 2D
# Q3/Q2 instance in variable mode, the others the plain cell route
LATTICE_GOLDENS = (
    ("spurious_currents_ls_3d_short", "spurious_currents"),
    ("beltrami_3d_augp_small", "beltrami"),
    ("rising_bubble_ls_q3_short", "rising_bubble"),
    ("rising_bubble_ls_picard_short", "rising_bubble"),
    ("rising_bubble_ls_imex_short", "rising_bubble"),
    ("rising_bubble_ls_expl_short", "rising_bubble"),
    ("rising_bubble_ls_augp_short", "rising_bubble"),
    ("beltrami_2d_augp_small", "beltrami"),
    ("beltrami_2d_augp_proj_small", "beltrami"),
)
KERNEL_GOLDENS = ("couette", "poiseuille_ns_small", "rising_bubble_ls_q3_short")
DRIVER_CLASS = {"couette": "CouetteProblem", "poiseuille": "ChannelProblem",
                "flow_1d": "ChannelFlow", "rising_bubble": "MicroFluidicProblem",
                "spurious_currents": "MicroFluidicProblem", "beltrami": "BeltramiProblem"}
# the reference anchor of poiseuille_ns (tests/test_golden_ns.py): ||e_u|| at
# t = 2 within 2e-4 of 0.1321, ||e_p|| < 1e-8
ANCHOR_EU, ANCHOR_EU_TOL, ANCHOR_EP = 0.1321, 2e-4, 1e-8
# the 3D open-boundary channel: poiseuille_ns.prm with dimension = 3 and
# global refinements = 4, 64 x 16 x 16 cells, 3 steps
CH3_STEPS = 3
CH3_ANCHORS = {
    "cells": " Number of active cells: 16384.",
    "dofs": " Number of degrees of freedom (velocity/pressure): 440228 (421443 + 18785).",
}
# the adaptive forest: the forest goldens (the 2D Taylor vortex on the
# reference's locally refined mesh, 280 cells, Q3/Q2) and the driven cavity's
# adaptive round (tests/test_forest_navier_stokes.py's configuration), each a
# golden child, and their (Newton, Krylov) counts per nonlinear solve as the
# port's CPU runs give them, with those of the full-width forest path's
# steps (beltrami_2d_1048, held on the CPU by tests/test_torch_forest_beltrami.py)
FOREST_GOLDENS = (
    ("beltrami_2d_small", "beltrami"),
    ("beltrami_2d_proj_small", "beltrami"),
)
FOREST_COUNTS = {
    "beltrami_2d_small": [(2, 38), (2, 38), (2, 27)],
    "beltrami_2d_proj_small": [(1, 13), (1, 13), (1, 10)],
    "drivencavity": [(3, 68), (2, 42)],
    "beltrami_2d_1048": [(2, 34), (2, 36)],
}
CAVITY_PRM = """
subsection Time stepping
  set end time = 1
  set step size = 1
end
subsection Navier-Stokes
  set physical type      = incompressible stationary
  set dimension          = 2
  set global refinements = 8
  set adaptive refinements = 1
  set velocity degree    = 2
  set viscosity          = 0.05
  subsection Solver
    set NL max iterations  = 15
    set NL tolerance       = 1.e-8
    set lin max iterations = 150
    set lin tolerance      = 1.e-4
  end
end
subsection Output options
  set output verbosity = 1
end
"""
CAVITY_CELLS = [64, 82, 106]  # before each solve, and after the last adaptation
# the full-width forest path: the reference's 2D AMR Beltrami mesh (global
# refinements 4, velocity degree 4: 1048 cells, Q4/Q3), its t = 0 anchors
# (tests/test_golden_ns.py:229-289), then FOREST_STEPS coupled-Newton BDF-2
# steps at beltrami_2d_small.prm's step size and tolerances
FOREST_STEPS = 2


def forest_parameters():
    """The full-width forest path's parameters: beltrami_2d_small.prm at
    global refinements = 4 and velocity degree 4, to FOREST_STEPS steps."""
    from adaflo_tpu_torch.parameters import FlowParameters

    par = FlowParameters.from_file(str(ROOT / "tests" / "prms" / "beltrami_2d_small.prm"))
    par.global_refinements = 4
    par.velocity_degree = 4  # Q4/Q3
    par.end_time = par.start_time + FOREST_STEPS * par.time_step_size_start
    return par

FOREST_ANCHORS = {
    "cells": " Number of active cells: 1048.",
    "dofs": " Number of degrees of freedom (velocity/pressure): 43821 (34158 + 9663).",
    "err_t0": ("9.507e-09", "8.461e-12"),
    "rel_t0": ("2.291e-08", "9.877e-12"),
}


def reset_single_phase_counts(cm):
    from adaflo_tpu_torch.ops import navier_stokes as nso

    reset_counts(cm)
    for k in nso.PLAIN_ROUTE_APPLIES:
        nso.PLAIN_ROUTE_APPLIES[k] = 0


def driver_problem(driver: str, par, out):
    import importlib

    mod = importlib.import_module(f"adaflo_tpu_torch.drivers.{driver}")
    return getattr(mod, DRIVER_CLASS[driver])(par, out=out)  # the default device


def check_open_masks(ns, device, label: str, graph: bool = False):
    """Phase 2 on an open-boundary problem's spaces and constraints, after
    its setup: K1 (identity rows, constant coefficients) and K2 against their
    plain versions on random u, p and u* (numpy seed), float64 (1e-12) and
    float32 (1e-5, a float32 operator on the same spaces and constraints).
    Its velocity masks must be the constraint sets, the tangential
    components only on the open sides (so the components' masks differ).
    graph: also the float64 device time of each in a CUDA graph."""
    import torch

    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.ops.navier_stokes import NavierStokesOperator, TimeWeights

    par = ns.parameters
    masks = ns.operator.cells.mask_u
    per_component = [int(m.sum()) for m in masks]
    open_dofs = ns.u_space.boundary_dofs(1)
    checks = {
        "masks_are_constraints": all(
            np.array_equal(np.flatnonzero(m.cpu().numpy()), con.constrained_dofs)
            for m, con in zip(masks, ns.constraints_u)
        ),
        "masks_differ": len(set(per_component)) > 1,
        "open_normal_free": not bool(masks[0][torch.as_tensor(
            np.setdiff1d(open_dofs, ns.constraints_u[0].constrained_dofs), device=device,
        )].any()) and len(np.setdiff1d(open_dofs, ns.constraints_u[0].constrained_dofs)) > 0,
        "open_tangential_fixed": all(bool(m[torch.as_tensor(open_dofs, device=device)].all())
                                     for m in masks[1:]),
    }
    print(f"open boundaries {label}: constrained velocity dofs per component "
          f"{per_component}, checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"open-boundary masks {label}: {checks}")
    rng = np.random.default_rng(15)
    n_u, n_p, dim = ns.u_space.n_dofs_padded, ns.p_space.n_dofs_padded, ns.dim
    base = dict(u=rng.standard_normal((dim, n_u)), p=rng.standard_normal(n_p),
                s=rng.standard_normal((dim, n_u)))
    tw = TimeWeights(1.5 / 0.5, -2.0 / 0.5, 0.5 / 0.5, 1.0)
    records = {}
    for dtype in (torch.float64, torch.float32):
        op = ns.operator if dtype == torch.float64 else NavierStokesOperator(
            par, ns.u_space, ns.p_space, ns.constraints_u, ns.constraints_p,
            dtype=dtype, device=device,
        )
        kw = dict(dtype=dtype, device=device)
        u, p, s = (torch.as_tensor(base[k], **kw) for k in "ups")
        sc = op._apply_scalars(tw)
        cells = op.cells
        dname = str(dtype).split(".")[-1]
        pairs = {
            "coupled_apply": (
                lambda: cm.coupled_apply(u, p, s, cells, sc, identity=True),
                lambda: cm.coupled_apply_plain(u, p, s, cells, sc, identity=True),
            ),
            "coupled_apply_velocity": (
                lambda: (cm.coupled_apply_velocity(u, s, cells, sc),),
                lambda: (cm.coupled_apply_plain(u, None, s, cells, sc, velocity_only=True),),
            ),
        }
        for name, (run, plain) in pairs.items():
            got, ref = list(run()), list(plain())
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            max_abs = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            t = cuda_ms(run)
            plain_ms = cuda_ms(plain, warmup=1, reps=5)["ms"]
            g_ms = graph_ms(run) if graph and dname == "float64" else None
            nbytes, flops, bms, by = bound(
                cells, dname, n_u, n_p, name.endswith("velocity"), False
            )
            case = f"{name} {label} {dname} open-boundary masks"
            print(
                f"kernel {case}: rel err {err:.3e} (max abs {max_abs:.3e}), "
                f"{t['ms']:.4f} ms/apply (one waited call {t['call_ms']:.4f} ms"
                + (f", graph {g_ms:.4f} ms" if g_ms is not None else "")
                + f"), plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)", flush=True,
            )
            if not err <= TOL[dname]:
                raise AssertionError(f"{case}: relative error {err:.3e} > {TOL[dname]}")
            records[f"{name} {dname}"] = dict(
                max_abs_err=max_abs, rel_err=err, ms=t["ms"], call_ms=t["call_ms"],
                graph_ms=g_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            )
    return records


def route_counts(cm):
    from adaflo_tpu_torch.ops import navier_stokes as nso

    launches = {k: v for k, v in cm.launches.items() if v}
    return launches, dict(cm.plain_calls), dict(nso.PLAIN_ROUTE_APPLIES)


def check_routes_ran(label, kernel: bool, launches, plain, plain_route):
    """The path ran K1/K2 (kernel) or the plain cell route (not kernel),
    nothing else: no other entry, no plain version of a kernel."""
    checks = {
        "no_plain_calls": all(v == 0 for v in plain.values()),
        "no_other_entry": all(k in K12 for k in launches),
    }
    if kernel:
        checks["k1_k2"] = all(launches.get(k, 0) > 0 for k in K12)
        checks["no_plain_route"] = all(v == 0 for v in plain_route.values())
    else:
        # the projection scheme applies the velocity block alone
        checks["no_k1_k2"] = not launches
        checks["plain_route"] = plain_route["velocity_vmult"] > 0
    if not all(checks.values()):
        raise AssertionError(f"{label}: routes {checks}")
    return checks


def golden_child(name: str) -> int:
    """One golden path in a process of its own (`chip_smoke.py --golden
    <name>`): a golden of SINGLE_PHASE or LATTICE_GOLDENS, run by its driver
    on the card with the counts from 0 and held to its golden with the
    port's compare_with_golden, or "anchor", poiseuille_ns.prm to t = 2.
    Prints a line of its seconds, steps, Newton and Krylov counts, launches
    and peak device memory, then one JSON line of the same (with the
    plain-version calls, the plain-route applies and the anchor's
    errors)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from adaflo_tpu_torch.drivers.rising_bubble import TwoPhaseParameters
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.parameters import FlowParameters
    from adaflo_tpu_torch.solvers.navier_stokes_solver import NavierStokes
    from adaflo_tpu_torch.testing import compare_with_golden

    cm.load_library()  # phase 1 built it
    prms = ROOT / "tests" / "prms"
    out = io.StringIO()
    record = {"golden": name}
    # (Newton, Krylov) of every nonlinear solve: the steps' (and an initial
    # Stokes solve's)
    counts = []
    solve = NavierStokes.solve_nonlinear_system

    def counted(self, initial_residual):
        c = solve(self, initial_residual)
        counts.append((int(c[0]), int(c[1])))
        return c

    NavierStokes.solve_nonlinear_system = counted
    reset_single_phase_counts(cm)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if name == "anchor":
        par = FlowParameters.from_file(str(prms / "poiseuille_ns.prm"))
        par.end_time = 2.0
        problem = driver_problem("poiseuille", par, out)
        problem.run()
        record["e_p"], record["e_u"] = problem.errors()
    elif name == "drivencavity":
        record["cavity"] = run_cavity(out)
    else:
        table = {g: (d, p) for g, d, p in SINGLE_PHASE} | {
            g: (d, g) for g, d in LATTICE_GOLDENS + FOREST_GOLDENS}
        driver, prm = table[name]
        Params = TwoPhaseParameters if driver in ("rising_bubble", "spurious_currents") else (
            FlowParameters)
        problem = driver_problem(driver, Params.from_file(str(prms / f"{prm}.prm")), out)
        problem.run()
    torch.cuda.synchronize()
    record["seconds"] = time.perf_counter() - t0
    if name not in ("anchor", "drivencavity"):
        compare_with_golden(out.getvalue(), ROOT / "tests" / "golden" / f"{name}.output")
        record["golden_passed"] = True
    record["steps"] = out.getvalue().count("Time step #")
    record["newton"] = [c[0] for c in counts]
    record["krylov"] = [c[1] for c in counts]
    record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["launches"], record["plain"], record["plain_route"] = route_counts(cm)
    print(f"golden {name}: {record['seconds']:.3f} s, {record['steps']} steps, Newton "
          f"{record['newton']}, Krylov {record['krylov']}, launches {record['launches']}, "
          f"peak device memory {record['peak_gb']:.3f} GB", flush=True)
    print(json.dumps(record), flush=True)
    return 0


def run_cavity(out) -> dict:
    """The driven cavity's adaptive round on the card (golden child
    "drivencavity"): a stationary solve on 8 x 8 cells, the Kelly pressure
    indicators, refine_and_coarsen_fixed_number, adapt_mesh with the
    solution carried over, a solve on the new mesh and one more
    adaptation. Returns its cells before each solve and at the end, the
    cells flagged for refinement in each adaptation, its hanging rows and
    the finest cells' median y (tests/test_forest_navier_stokes.py's
    checks)."""
    import torch

    from adaflo_tpu_torch.applications.drivencavity import DrivenCavityProblem
    from adaflo_tpu_torch.parameters import FlowParameters

    par = FlowParameters.from_string(CAVITY_PRM)
    par.output_filename = ""
    problem = DrivenCavityProblem(par, out=out)  # the default device
    ns = problem.navier_stokes
    refined = []
    adapt = ns.adapt_mesh

    def recorded(flags):
        refined.append(int((np.asarray(flags) == 1).sum()))
        return adapt(flags)

    ns.adapt_mesh = recorded
    problem.run()
    cells = [int(ln.split(":")[1].strip(" .")) for ln in out.getvalue().splitlines()
             if "active cells" in ln] + [problem.mesh.n_cells]
    levels = ns.u_space.levels
    fine = problem.mesh.cell_geometry()[0][levels == levels.max()]
    return dict(
        cells=cells, refined=refined, hanging=int(len(ns.u_space.hanging_slave)),
        median_y_finest=float(np.median(fine[:, 1])),
        converged=out.getvalue().count("conv.]"),
        finite=bool(torch.isfinite(ns.solution[0]).all()),
    )


def run_forest_beltrami(device):
    """Phase 3, the full-width forest path: the port's Beltrami driver on the
    reference's 2D AMR mesh (4 x 4 roots, global refinements = 4, cells 2
    and 3 refined before the last global refinement: 1048 cells, Q4/Q3,
    43,821 dofs, float64), beltrami_2d_small.prm's step size and solver
    tolerances: the native forest library's build timed apart, the setup
    timed in parts (the forest, then the spaces, constraints, operator and
    preconditioner, the ForestGMG hierarchies apart), the t = 0 anchors,
    then FOREST_STEPS steps with the counts from 0, each with its seconds,
    Newton and Krylov counts (held to the CPU's) and plain-route applies;
    K1-K4 never launch (the forest runs the plain cell route); the peak
    device memory."""
    import torch

    from adaflo_tpu_torch.drivers.beltrami import BeltramiProblem
    from adaflo_tpu_torch.mesh import forest as fm
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.ops import navier_stokes as nso
    from adaflo_tpu_torch.solvers import forest_multigrid as fmg

    t0 = time.perf_counter()
    fm.library_path()  # g++ of native/forest.cc, where no library of its hash is built
    build_s = time.perf_counter() - t0
    par = forest_parameters()
    out = Tee()
    gmg_s = []
    init = fmg.ForestGMG.__init__

    def timed(self, *a, **kw):
        t = time.perf_counter()
        init(self, *a, **kw)
        gmg_s.append(time.perf_counter() - t)

    fmg.ForestGMG.__init__ = timed
    reset_single_phase_counts(cm)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        problem = BeltramiProblem(par, out=out)  # the default device
        forest_s = time.perf_counter() - t0
        problem.setup()
        problem.output_results()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    finally:
        fmg.ForestGMG.__init__ = init
    levels = [len(g.levels) for g in problem.navier_stokes.preconditioner.u_gmg_geom]
    print(f"forest 1048: library build {build_s:.3f} s, setup {setup_s:.3f} s (forest "
          f"{forest_s:.3f} s, ForestGMG "
          f"hierarchies {sum(gmg_s):.3f} s: {len(gmg_s)} of {levels} + "
          f"{len(problem.navier_stokes.preconditioner.p_gmg_geom.levels)} levels)", flush=True)
    steps = []
    for _ in range(FOREST_STEPS):
        before, before_route = dict(cm.launches), dict(nso.PLAIN_ROUTE_APPLIES)
        t0 = time.perf_counter()
        newton, krylov = problem.step()
        torch.cuda.synchronize()
        st = dict(
            seconds=time.perf_counter() - t0, newton=int(newton), krylov=int(krylov),
            launches={k: cm.launches[k] - before[k] for k in cm.launches
                      if cm.launches[k] > before[k]},
            plain_route={k: nso.PLAIN_ROUTE_APPLIES[k] - before_route[k]
                         for k in before_route},
        )
        steps.append(st)
        print(f"forest 1048 step {len(steps)}: {st['seconds']:.3f} s, Newton {st['newton']}, "
              f"Krylov {st['krylov']}, launches {st['launches']}, plain-route applies "
              f"{st['plain_route']}", flush=True)
    launches, plain, plain_route = route_counts(cm)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ns = problem.navier_stokes
    text = out.getvalue()
    lines = text.splitlines()

    def pair(prefix):
        ln = next(ln for ln in lines if ln.startswith(prefix))
        parts = ln.split("=")
        return parts[1].split(",")[0].strip(), parts[2].strip()

    div0 = float(next(ln for ln in lines if "Cell divergence" in ln).split("=")[1])
    checks = check_routes_ran("forest 1048", False, launches, plain, plain_route)
    checks.update(
        cells=FOREST_ANCHORS["cells"] in lines,
        dofs=FOREST_ANCHORS["dofs"] in lines,
        err_t0=pair("  L2-Errors absolute") == FOREST_ANCHORS["err_t0"],
        rel_t0=pair("  L2-Errors relative") == FOREST_ANCHORS["rel_t0"],
        div_t0=div0 < 1e-14,
        hanging=len(ns.u_space.hanging_slave) > 0 and len(ns.p_space.hanging_slave) > 0,
        converged=text.count(" converged.") == FOREST_STEPS and len(steps) == FOREST_STEPS,
        cpu_counts=[(st["newton"], st["krylov"]) for st in steps]
        == FOREST_COUNTS["beltrami_2d_1048"],
        finite=bool(torch.isfinite(ns.solution[0]).all())
        and bool(torch.isfinite(ns.solution[1]).all()),
    )
    print(f"forest 1048: peak device memory {peak_gb:.3f} GB, t = 0 ||e_p|| ||e_u|| "
          f"{pair('  L2-Errors absolute')}, relative {pair('  L2-Errors relative')}, "
          f"divergence {div0:.3e}, checks {checks}", flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"forest 1048 checks failed: {failed}")
    return dict(build_s=build_s, setup_s=setup_s, forest_s=forest_s, gmg_s=sum(gmg_s),
                steps=steps, launches=launches, peak_gb=peak_gb)


def run_goldens(device):
    """Phase 3, the golden paths: phase 2's open-boundary check on couette's
    spaces and constraints; then the seven single-phase goldens, the
    poiseuille_ns anchor at t = 2 and the nine lattice goldens of the
    rising bubble's variants and of augmented Taylor-Hood, each in a child
    process of its own (golden_child, all started together: each is
    host-bound on a small lattice), waited for and held to its routes:
    K1/K2 for the coupled Newton paths of Taylor-Hood elements, the plain
    cell route alone for the others."""
    from adaflo_tpu_torch.parameters import FlowParameters

    couette = driver_problem(
        "couette", FlowParameters.from_file(str(ROOT / "tests" / "prms" / "couette.prm")),
        io.StringIO(),
    )
    couette.setup()
    masks_rec = check_open_masks(couette.navier_stokes, device, "couette 64 x 16")
    del couette
    names = ([g for g, _ in LATTICE_GOLDENS] + [g for g, _ in FOREST_GOLDENS]
             + ["drivencavity"] + [g for g, _, _ in SINGLE_PHASE] + ["anchor"])
    t0 = time.perf_counter()
    procs = {
        name: subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--golden", name],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        )
        for name in names
    }
    records, failed = {}, {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=900)
            if proc.returncode != 0:
                failed[name] = stderr.strip().splitlines()[-3:]
                continue
            lines = stdout.strip().splitlines()
            records[name] = json.loads(lines[-1])
            print(lines[-2], flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"golden paths failed: {failed}")
    for name in names:
        r = records[name]
        checks = check_routes_ran(
            name, name in KERNEL_GOLDENS or name == "anchor",
            r["launches"], r["plain"], r["plain_route"],
        )
        extra = ""
        if name in FOREST_COUNTS:
            # the forest paths: the plain cell route, the CPU's counts
            checks["cpu_counts"] = list(zip(r["newton"], r["krylov"])) == [
                tuple(c) for c in FOREST_COUNTS[name]]
        if name == "drivencavity":
            cav = r["cavity"]
            checks.update(
                converged=cav["converged"] == 2,
                cells=cav["cells"] == CAVITY_CELLS,
                more_cells=cav["cells"][1] > cav["cells"][0],
                hanging=cav["hanging"] > 0,
                finest_near_lid=cav["median_y_finest"] > 0.5,
                finite=cav["finite"],
            )
            extra = f" cells {cav['cells']}, refined {cav['refined']},"
        if not all(checks.values()):
            raise AssertionError(f"golden path {name}: {checks}")
        if name == "anchor":
            checks["e_u"] = abs(r["e_u"] - ANCHOR_EU) < ANCHOR_EU_TOL
            checks["e_p"] = r["e_p"] < ANCHOR_EP
            extra = f" ||e_u|| = {r['e_u']:.6f}, ||e_p|| = {r['e_p']:.3e} at t = 2,"
            if not all(checks.values()):
                raise AssertionError(f"poiseuille_ns anchor: {checks}")
        elif name != "drivencavity":
            extra = " golden passed,"
        print(f"golden path {name}: {r['seconds']:.3f} s, {r['steps']} steps,{extra} "
              f"launches {r['launches']}, plain-route applies {r['plain_route']}, "
              f"checks {checks}", flush=True)
    print(f"goldens: {len(names)} paths in parallel processes, {wall:.3f} s", flush=True)
    return dict(goldens=records, masks=masks_rec, wall_s=wall)


def run_channel_3d(device):
    """Phase 3, the 3D open-boundary channel at full width: poiseuille_ns.prm
    with dimension = 3 and global refinements = 4 (64 x 16 x 16 cells,
    421,443 + 18,785 dofs, float64); setup, phase 2's check on its spaces
    and constraints, then CH3_STEPS steps with the counts from 0, each with
    its seconds, Newton and Krylov counts, launches and plain-route
    applies; the peak device memory."""
    import torch

    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.ops import navier_stokes as nso
    from adaflo_tpu_torch.parameters import FlowParameters

    par = FlowParameters.from_file(str(ROOT / "tests" / "prms" / "poiseuille_ns.prm"))
    par.dimension = 3
    par.global_refinements = 4
    out = Tee()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = driver_problem("poiseuille", par, out)
    problem.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"channel 3D: setup {setup_s:.3f} s", flush=True)
    masks_rec = check_open_masks(problem.navier_stokes, device, "channel 3D 64 x 16 x 16",
                                 graph=True)
    reset_single_phase_counts(cm)
    steps = []
    for _ in range(CH3_STEPS):
        before, before_route = dict(cm.launches), dict(nso.PLAIN_ROUTE_APPLIES)
        t0 = time.perf_counter()
        newton, krylov = problem.step()
        torch.cuda.synchronize()
        st = dict(
            seconds=time.perf_counter() - t0, newton=int(newton), krylov=int(krylov),
            launches={k: cm.launches[k] - before[k] for k in cm.launches
                      if cm.launches[k] > before[k]},
            plain_route={k: nso.PLAIN_ROUTE_APPLIES[k] - before_route[k]
                         for k in before_route},
        )
        steps.append(st)
        print(f"channel 3D step {len(steps)}: {st['seconds']:.3f} s, Newton {st['newton']}, "
              f"Krylov {st['krylov']}, launches {st['launches']}, plain-route applies "
              f"{st['plain_route']}", flush=True)
    launches, plain, plain_route = route_counts(cm)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ns = problem.navier_stokes
    ep, eu = problem.errors()
    text = out.getvalue()
    checks = check_routes_ran("channel 3D", True, launches, plain, plain_route)
    checks.update(
        cells=CH3_ANCHORS["cells"] in text.splitlines(),
        dofs=CH3_ANCHORS["dofs"] in text.splitlines(),
        converged=text.count(" converged.") == CH3_STEPS,
        # K2 runs where the preconditioner is rebuilt, K1 in every solve
        k1_every_step=all(st["launches"].get("coupled_apply", 0) > 0 for st in steps),
        finite=bool(torch.isfinite(ns.solution[0]).all())
        and bool(torch.isfinite(ns.solution[1]).all()),
    )
    print(f"channel 3D: peak device memory {peak_gb:.3f} GB, after {len(steps)} steps "
          f"||e_p|| = {ep:.4e}, ||e_u|| = {eu:.4e} against the 2D profile, checks {checks}",
          flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"3D channel checks failed: {failed}")
    return dict(setup_s=setup_s, steps=steps, launches=launches, peak_gb=peak_gb,
                masks=masks_rec)


def sf_kernel_entries(sf_probes, sf_rec, resident_graph):
    """The kernels-line entries of K7, K8, K9, K10 and K5: each at its main
    configuration (float32; K7 at 96 aligned statements, K8 at 89 rows, K9
    at m = 384, k = 96 on the CUDA cores, K5 in f32), launches summed over
    phase 4, and every timed configuration of phase 4 beside it; K8's and
    K10's device times in a CUDA graph (resident_graph_ms) beside them."""
    keys = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "rate",
            "max_abs_err")
    sf32, sf64 = (sf_probes["sf"][d]["configs"] for d in ("float32", "float64"))
    launches = sf_probes["launches"]

    def entry(name, replaces, counter, rec, configs, slopes=None):
        e = {
            "name": name, "route": "cuda", "source": SF_SOURCE, "replaces": replaces,
            "launches": sum(v for k, v in launches.items() if k.split("[")[0] == counter),
            **{k: rec[k] for k in keys},
            "configs": {n: {k: r[k] for k in keys + ("onchip_ms",) if k in r}
                        for n, r in configs.items()},
        }
        if "onchip_ms" in rec:  # K8, K10: the on-chip floor (probe_bounds.onchip_floor_ms)
            e["onchip_ms"] = rec["onchip_ms"]
        if slopes:
            e["slopes"] = slopes
        return e

    def pick(prefixes):
        out = {}
        for tag, confs in (("float32", sf32), ("float64", sf64)):
            out |= {f"{n} {tag}": r for n, r in confs.items() if n.split("[")[0] in prefixes}
        return out

    sl = {d: sf_probes["sf"][d]["slopes"] for d in ("float32", "float64")}
    slopes = lambda names: {f"{n} {d}": sl[d][n] for d in sl for n in names if n in sl[d]}
    mxu = sf_probes["mxu"]
    k5 = {n: r for n, r in mxu.items() if n.startswith("K5 ")}
    entries = [
        entry("row_fma", K7_REPLACES, "row_fma", sf32["vpu[n_ops=96]"],
              pick({"vpu", "vpu_shift"}), slopes(("vpu", "vpu_shift"))),
        entry("row_copies", K8_REPLACES, "row_copies", sf32["copies[n_rows=89]"],
              pick({"copies"}), slopes(("copies",))),
        entry("dense_dot", K9_REPLACES, "dense_dot", sf32["mxu_k96[m=384]"],
              pick({"mxu_k96", "mxu_k96tf", "mxu_k96bf", "mxu_k32"}),
              slopes(("mxu_k96", "mxu_k96tf", "mxu_k96bf", "mxu_k32"))),
        entry("sf_eval", K10_REPLACES, "sf_eval", sf32["sfeval"], pick({"sfeval"})),
        entry("dense_dot_streamed", K5_REPLACES, "dense_dot_streamed", k5["K5 f32"], k5),
    ]
    entries[-1]["library_lines"] = {n: r["ms"] for n, r in mxu.items() if n.startswith("matmul")}
    for e, main in ((entries[1], "copies[n_rows=89] float32"), (entries[3], "sfeval float32")):
        e["graph_ms"] = resident_graph[main]
        e["graph_ms_by_config"] = {k: v for k, v in resident_graph.items()
                                   if k.split("[")[0].split()[0] == main.split("[")[0].split()[0]}
    for e in entries:  # the phase-2 errors of every mode, at both shapes
        e["phase2_max_rel_err"] = max(
            r["rel_err"] for r in sf_rec.values() if r["counter"].split("[")[0] == e["name"])
    return entries


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--golden" and torch.cuda.is_available():
        return golden_child(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not all((ROOT / src).is_file() for src in (K1_SOURCE, SF_SOURCE)):
        print("chip_smoke: adaflo_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # ---- phase 1: device and build -----------------------------------------
    start = time.perf_counter()
    smi = smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.ops import probe_kernels as pk

    # every kernel is built from the checkout's sources in this run, so that
    # phase 1 reads this build's ptxas report (a library left by an earlier
    # run of the same sources would be loaded without one)
    from adaflo_tpu_torch.ops import build as kb

    for src, name in ((K1_SOURCE, "coupled_matvec"), (SF_SOURCE, "probe_kernels")):
        (kb.BUILD_DIR / f"lib{name}_{kb.source_tag(ROOT / src)}.so").unlink(missing_ok=True)
    t0 = time.perf_counter()
    libs = {"coupled_matvec": cm, "probe_kernels": pk}
    with ThreadPoolExecutor(len(libs)) as ex:  # one nvcc per source, together
        for f in [ex.submit(mod.load_library) for mod in libs.values()]:
            f.result()
    print(f"kernel builds + loads, in parallel: {time.perf_counter() - t0:.2f} s")
    for name, mod in libs.items():
        log = mod.build_info.get("log", "").splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in log if "Used " in ln]
        spills = [
            ln.strip() for ln in log
            if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))
        ]
        print(f"{name}: build {mod.build_info.get('seconds', 0.0):.2f} s; ptxas: {len(regs)} "
              f"kernels, {min(regs, default=0)}-{max(regs, default=0)} registers per "
              f"thread, {len(spills)} with spills")
        for ln in spills:
            print(f"ptxas ({name}):", ln)
    cell_build = check_cell_build(cm)
    sched_build = check_schedule_build(cm)
    dot_build = check_dot_build(pk)
    fma_build = check_fma_build(pk)
    resident_build = check_resident_build(pk)
    scatter_build = check_scatter_build(cm)
    marks = [("1", time.perf_counter())]

    # ---- phase 2: kernels against the plain versions -------------------------
    rec = check_kernels(device)
    block_rec = check_block_entries(device)
    probe_rec = check_probe_entries(device)
    scatter_rec = check_scatter_lattices(device)
    sf_rec = check_sf_entries(device)
    resident_graph = resident_graph_ms(device)
    marks.append(("2", time.perf_counter()))

    # ---- phase 3: the slice, each path with the counts from 0 ---------------
    slice_rec = run_slice()
    channel_rec = run_channel()
    rb3_rec = run_rising_bubble_3d(device)
    rb2_rec = run_rising_bubble_2d(device)
    q3_rec = check_rising_bubble_q3(device)
    forest_rec = run_forest_beltrami(device)
    sp_rec = run_goldens(device)
    ch3_rec = run_channel_3d(device)
    marks.append(("3", time.perf_counter()))

    # ---- phase 4: the probes, their path with the counts from 0 -------------
    probes = run_probes()
    sf_probes = run_sf_probes()
    marks.append(("4", time.perf_counter()))
    print("phase seconds: " + ", ".join(
        f"{n} {t - (marks[i - 1][1] if i else start):.1f}" for i, (n, t) in enumerate(marks)))

    def entry(name, replaces, r, b, main_label, launches):
        return {
            "name": name, "route": "cuda", "source": K1_SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": main_label, "call_ms": r["call_ms"], "graph_ms": r["graph_ms"],
            "at_48": {k: b[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
                                        "bound_by")},
            "build": {k: v for k, v in cell_build.items() if k.split()[0] == name},
        }

    kernels = [
        entry("coupled_apply", K1_REPLACES, rec["3D Q2/Q1 16^3 f64 const+ids"],
              rec["3D Q2/Q1 48^3 f64 const+ids"], "3D Q2/Q1 16^3 f64 const+ids",
              slice_rec["launches"]),
        entry("coupled_apply_velocity", K2_REPLACES, rec["3D Q2/Q1 16^3 f64 velocity"],
              rec["3D Q2/Q1 48^3 f64 velocity"], "3D Q2/Q1 16^3 f64 velocity",
              slice_rec["launches"]),
    ]
    for e in kernels:  # the variable mode on the rising bubbles' paths
        e["rising_bubble_3d"] = dict(
            launches=rb3_rec["launches"][e["name"]],
            **{k.split()[1]: v for k, v in rb3_rec["variable"].items()
               if k.split()[0] == e["name"]},
        )
        e["rising_bubble_2d"] = dict(
            launches=rb2_rec["launches"][e["name"]],
            **{k.split()[1]: v for k, v in rb2_rec["variable"].items()
               if k.split()[0] == e["name"]},
        )
    for e in kernels:  # the 2D Q3/Q2 instance: its box, the Q3 bubble, the golden paths
        name = e["name"]
        mine = [lbl for lbl, _, mode in Q3_2D_CASES
                if mode.startswith("velocity") == name.endswith("velocity")]
        e["instances"] = ["3D Q2/Q1", "2D Q2/Q1", "3D Q3/Q2", "2D Q3/Q2"]
        e["q3_2d"] = {lbl.split(" ", 3)[-1]: {k: rec[lbl][k] for k in (
            "max_abs_err", "rel_err", "ms", "call_ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by")} for lbl in mine}
        e["q3_2d"]["shape"] = "2D Q3/Q2 256 x 512 box, 2,889,731 dofs"
        e["rising_bubble_q3"] = dict(
            launches=sp_rec["goldens"]["rising_bubble_ls_q3_short"]["launches"].get(name, 0),
            **{k.split()[1]: v for k, v in q3_rec["variable"].items() if k.split()[0] == name},
        )
        e["lattice_goldens"] = {g: sp_rec["goldens"][g]["launches"].get(name, 0)
                                for g, _ in LATTICE_GOLDENS}
    for e in kernels:  # the open-boundary masks of the single-phase paths
        name = e["name"]
        pick = lambda rec: {k.split()[1]: v for k, v in rec.items() if k.split()[0] == name}
        e["couette"] = dict(launches=sp_rec["goldens"]["couette"]["launches"].get(name, 0),
                            **pick(sp_rec["masks"]))
        e["poiseuille_ns_small"] = dict(
            launches=sp_rec["goldens"]["poiseuille_ns_small"]["launches"].get(name, 0))
        e["poiseuille_ns_anchor"] = dict(
            launches=sp_rec["goldens"]["anchor"]["launches"].get(name, 0))
        e["channel_3d"] = dict(launches=ch3_rec["launches"].get(name, 0),
                               **pick(ch3_rec["masks"]))
        # the forest paths run the plain cell route: no launch
        e["forest"] = {"beltrami_2d_1048": forest_rec["launches"].get(name, 0)} | {
            g: sp_rec["goldens"][g]["launches"].get(name, 0)
            for g in [g for g, _ in FOREST_GOLDENS] + ["drivencavity"]}
    for name in BLOCK_ENTRIES:
        main = "3D Q2/Q1 16^3 periodic f64"
        kernels.append(entry(
            name, K3_REPLACES if "_cells" in name else K4_REPLACES,
            block_rec[(name, main)], block_rec[(name, "3D Q2/Q1 48^3 f64")],
            main, channel_rec["launches"],
        ))
    def probe_entry(name, counter, replaces, key, variant, library=None):
        r64 = probes["results"][(key, "float64")][variant]
        r32 = probes["results"][(key, "float32")][variant]
        return {
            "name": name, "route": "cuda", "source": K1_SOURCE, "replaces": replaces,
            "launches": probes["launches"][counter],
            "max_abs_err": r64["max_abs_err"], "ms": r64["ms"], "plain_ms": r64["plain_ms"],
            "bound_ms": r64["bound_ms"], "bound_by": r64["bound_by"],
            "library_ms": None if library is None else r64[library],
            "shape": "3D Q2/Q1 48^3 f64 (probe driver)", "call_ms": r64["call_ms"],
            "f32": {k: r32[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
                                        "bound_by")},
            "at_16": {k: probe_rec[(counter, "3D Q2/Q1 16^3 float64")][k]
                      for k in ("max_abs_err", "ms", "call_ms", "plain_ms")},
        }

    from adaflo_tpu_torch.ops.coupled_matvec import K12_VARIANTS, K13_VARIANTS

    for v in K12_VARIANTS:
        name = f"coupled_apply_ablated[{v}]"
        kernels.append(probe_entry(name, name, K12_REPLACES, "K12", v))
        if v in K13_VARIANTS:  # "full", one instance for both probes
            kernels[-1]["also_replaces"] = K13_REPLACES
            kernels[-1]["build"] = {t: sched_build[f"full {t}"] for t in ("double", "float")}
    for v in K13_VARIANTS:
        if v in K12_VARIANTS:  # "full": K12's instance and row
            continue
        name = f"coupled_apply_ablated[{v}]"
        kernels.append(probe_entry(name, name, K13_REPLACES, "K13", v))
    for v, replaces in K13_SCHEDULE_REPLACES.items():
        name = f"coupled_apply_ablated[{v}]"
        kernels.append(probe_entry(name, name, replaces, "K13", v))
        kernels[-1]["full_ms"] = probes["results"][("K13", "float64")]["full"]["ms"]
        kernels[-1]["build"] = {t: sched_build[f"{v} {t}"] for t in ("double", "float")}
    kernels.append(probe_entry("coupled_apply_lattice", "coupled_apply_lattice",
                               K11_REPLACES, "K11", "lattice"))
    kernels.append(probe_entry("scatter_cells", "scatter_cells", K6_REPLACES, "K6",
                               "scatter_cells", library="library_ms"))
    k6_32 = probes["results"][("K6", "float32")]["scatter_cells"]
    kernels[-1].update(
        graph_ms=scatter_rec["graph_ms"]["float64"],
        lattice_ms=probes["results"][("K6", "float64")]["scatter_cells"]["lattice_ms"],
        build=scatter_build, lattices=scatter_rec["errors"],
    )
    kernels[-1]["f32"].update(graph_ms=scatter_rec["graph_ms"]["float32"],
                              library_ms=k6_32["library_ms"], lattice_ms=k6_32["lattice_ms"])
    kernels += sf_kernel_entries(sf_probes, sf_rec, resident_graph)
    for e in kernels:  # the dot's instances (phase 1); K5 shares f32, tf32, f64 with K9
        if e["name"] == "row_fma":
            e["build"] = fma_build
        elif e["name"] in resident_build:
            e["build"] = resident_build[e["name"]]
        elif e["name"] == "dense_dot":
            e["build"] = {k: v for k, v in dot_build.items() if k != "bf16 (384, 96) bf16"}
        elif e["name"] == "dense_dot_streamed":
            e["build"] = {k: v for k, v in dot_build.items()
                          if "(384, 96)" in k and k != "bf16 (384, 96) float"}
    for title, r in (("beltrami_3d", slice_rec), ("periodic channel 16^3", channel_rec)):
        steps = r["steps"]
        n = len(steps)
        print(
            f"{title} summary: "
            f"{statistics.mean(s['seconds'] for s in steps):.3f} s/step, "
            f"Newton/step {sum(s['newton'] for s in steps) / n:.2f}, "
            f"Krylov/step {sum(s['krylov'] for s in steps) / n:.2f}, "
            "launches/step "
            + json.dumps({k: v / n for k, v in r["launches"].items() if v})
        )
    steps = rb3_rec["steps"]
    print(
        f"rising bubble 32^3 summary: setup {rb3_rec['setup_s']:.3f} s, "
        f"{statistics.mean(st['seconds'] for st in steps):.3f} s/step "
        f"(steps {[round(st['seconds'], 3) for st in steps]}), Newton "
        f"{[st['newton'] for st in steps]}, Krylov {[st['krylov'] for st in steps]}, "
        f"statistics {statistics.mean(st['stats_s'] for st in steps):.3f} s/step, peak "
        f"device memory {rb3_rec['peak_gb']:.3f} GB; 2D golden {rb2_rec['seconds']:.3f} s"
    )
    steps = ch3_rec["steps"]
    print(
        f"channel 3D summary: setup {ch3_rec['setup_s']:.3f} s, "
        f"{statistics.mean(st['seconds'] for st in steps):.3f} s/step "
        f"(steps {[round(st['seconds'], 3) for st in steps]}), Newton "
        f"{[st['newton'] for st in steps]}, Krylov {[st['krylov'] for st in steps]}, peak "
        f"device memory {ch3_rec['peak_gb']:.3f} GB; goldens "
        + json.dumps({k: round(v["seconds"], 3) for k, v in sp_rec["goldens"].items()})
        + f", {sp_rec['wall_s']:.3f} s in parallel processes"
    )
    steps = forest_rec["steps"]
    print(
        f"forest 1048 summary: library build {forest_rec['build_s']:.3f} s, setup "
        f"{forest_rec['setup_s']:.3f} s (forest "
        f"{forest_rec['forest_s']:.3f} s, ForestGMG hierarchies {forest_rec['gmg_s']:.3f} s), "
        f"{statistics.mean(st['seconds'] for st in steps):.3f} s/step "
        f"(steps {[round(st['seconds'], 3) for st in steps]}), Newton "
        f"{[st['newton'] for st in steps]}, Krylov {[st['krylov'] for st in steps]}, "
        f"plain-route applies {[st['plain_route'] for st in steps]}, K1-K4 launches "
        f"{forest_rec['launches']}, peak device memory {forest_rec['peak_gb']:.3f} GB"
    )
    for g, _ in LATTICE_GOLDENS + FOREST_GOLDENS + (("drivencavity", None),):
        r = sp_rec["goldens"][g]
        n = max(r["steps"], 1)
        print(f"{g} summary: {r['seconds'] / n:.3f} s/step over {r['steps']} steps, Newton "
              f"{r['newton']}, Krylov {r['krylov']}, peak device memory {r['peak_gb']:.3f} GB")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
