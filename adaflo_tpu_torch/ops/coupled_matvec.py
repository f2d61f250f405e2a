"""Coupled Navier-Stokes cell apply: the CUDA kernel, its wrappers and
their plain PyTorch versions.

Counterpart of ``adaflo_tpu/ops/pallas_matvec.py``. The TPU package has four
Pallas kernels for this apply: ``coupled_vmult_pr2`` (K1, the resident apply
inside the Krylov solve, with constraint-identity rows, output scale, a fused
sum(out^2) and variable coefficients), ``coupled_vmult_pr`` (K2, the same
cell math with constant coefficients, used by ``vmult`` and
``velocity_vmult``), ``coupled_vmult_cells`` (K3, the cell math on
pre-gathered cell blocks, behind an outside gather and scatter: the path of
periodic lattices) and ``coupled_vmult_parity`` (K4, K1's gather feeding
K3's unscattered output). Here all four are instances of one CUDA cell
kernel (``csrc/coupled_matvec.cu``), with these entries:

- ``coupled_apply`` (K1): nodal (u, p) -> nodal (r_u, r_p) with the extras;
- ``coupled_apply_velocity`` (K2): u -> r_u, no pressure input and no
  pressure rows, constrained rows +u (identity);
- ``coupled_apply_cells`` (K3): cell block x (E, n_cols) -> cell block
  (E, n_cols), with the u* stream either the u* cell dofs (E, dim n_u) or
  the u* values and gradients at the q points (E, dim (dim+1), n_q);
  ``velocity_only=True`` takes and gives (E, dim n_u) velocity blocks;
- ``coupled_apply_gather`` (K4): nodal (u, p) and u* -> cell block
  (E, n_cols), constrained entries of u and p read as zero; p=None gives
  the velocity block (E, dim n_u).

The measurement probes of the JAX package's ``scripts/`` have entries of
their own, 3D Q2/Q1 only (the probes' configuration), driven by
``adaflo_tpu_torch/scripts/``:

- ``coupled_apply_ablated`` (K12 ``probe_pr_phases.py``, K13
  ``probe_pr_parts.py``): nodal in and out with the phases of a variant
  (``VARIANTS``), a compile-time phase mask of the cell kernel, or the full
  apply under one of K13's TPU schedules (``K13_SCHEDULES``: rowdma, pipe,
  unroll2), a compile-time schedule of its gather against its compute;
- ``coupled_apply_lattice`` (K11 ``probe_pr_grouped.py``): K1's function with
  constant coefficients, its addresses computed from the lattice
  coordinates in place of the cell tables;
- ``scatter_cells`` (K6 ``probe_pr.py``): a cell block added into the nodal
  vectors; the kernel sums lattice tiles in shared memory, its addresses
  from the cells' lattice coordinates (periodic axes wrapped), and reads
  no cell table.

n_cols = dim n_u + n_p per cell, the velocity components first. Nodal
vectors: u (dim, n_u), p (n_p,), the frozen Newton linearization point u*
(dim, n_u). A wrapper given CUDA tensors launches the kernel or raises;
given CPU tensors it runs its plain version, the same function in plain
PyTorch written in the dense-table form of the TPU package's
``build_tables`` (out = M89 x + A_ic n (+ A_ig st)), independent of the
kernel's sum factorization. The kernel library is built with nvcc at first
use into ``build/adaflo_tpu_torch/`` under the repository root.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from adaflo_tpu_torch.ops.build import build_library

# launches of the CUDA kernel per entry, and calls of the plain versions;
# plain integers that a caller may reset (chip_smoke.py reads them around a
# run)
launches = {
    "coupled_apply": 0,
    "coupled_apply_velocity": 0,
    "coupled_apply_cells": 0,
    "coupled_apply_cells_velocity": 0,
    "coupled_apply_cells_qfields": 0,
    "coupled_apply_cells_qfields_velocity": 0,
    "coupled_apply_gather": 0,
    "coupled_apply_gather_velocity": 0,
    "coupled_apply_lattice": 0,
    "scatter_cells": 0,
}
plain_calls = {
    "coupled_apply_plain": 0,
    "coupled_apply_cells_plain": 0,
    "coupled_apply_gather_plain": 0,
    "coupled_apply_ablated_plain": 0,
    "scatter_cells_plain": 0,
}

# the kernel entry (mode of adaflo_coupled_cells in csrc/coupled_matvec.cu)
MODE_NODAL, MODE_CELLS, MODE_CELLS_QFIELDS, MODE_GATHER = 0, 1, 2, 3

# phases of the cell kernel (kPh* in csrc/coupled_matvec.cu) and the probe
# variants built from them: K12's minus-one-phase ablations
# (scripts/probe_pr_phases.py) and K13's whole-apply ablations
# (scripts/probe_pr_parts.py); "noscatter" is K12's "minus_scatter"
PH_GATHER, PH_EVAL_U, PH_EVAL_USTAR, PH_QPOINT, PH_INTEGRATE, PH_SCATTER = (
    1, 2, 4, 8, 16, 32,
)
PH_ALL, PH_CONTIG, PH_MDOT = 63, 64, 128
PHASE_NAMES = {
    "gather": PH_GATHER, "eval_u": PH_EVAL_U, "eval_ustar": PH_EVAL_USTAR,
    "qpoint": PH_QPOINT, "integrate": PH_INTEGRATE, "scatter": PH_SCATTER,
}
K12_VARIANTS = {"full": PH_ALL} | {
    f"minus_{name}": PH_ALL & ~bit for name, bit in PHASE_NAMES.items()
} | {"dma_only": PH_GATHER}
K13_VARIANTS = {
    "datapath": PH_GATHER | PH_SCATTER,
    "noshift": PH_CONTIG | PH_SCATTER,
    "mdot": PH_GATHER | PH_MDOT | PH_SCATTER,
    "evdots": PH_GATHER | PH_EVAL_U | PH_EVAL_USTAR | PH_SCATTER,
    "full": PH_ALL,
    "noscatter": PH_ALL & ~PH_SCATTER,
}
# the schedule of the cell kernel (kSched* in csrc/coupled_matvec.cu): the
# production one-shot block, and K13's TPU schedules (scripts/probe_pr_parts.py
# make_kernel_rowdma, make_kernel_pipe, make_kernel_unroll2), each the full
# apply with its gather overlapped with its compute by asynchronous copies
SCHED_ONCE, SCHED_ROW_ASYNC, SCHED_PIPE, SCHED_PAIR = 0, 1, 2, 3
K13_SCHEDULES = {"rowdma": SCHED_ROW_ASYNC, "pipe": SCHED_PIPE, "unroll2": SCHED_PAIR}
# the body each schedule runs: the one-shot body's stages ("lines": cell_lines,
# and the three schedules through its split gather and compute)
SCHEDULE_BODY = {"full": "lines", "rowdma": "lines", "pipe": "lines", "unroll2": "lines"}
VARIANTS = K12_VARIANTS | K13_VARIANTS | {name: PH_ALL for name in K13_SCHEDULES}
for _name in VARIANTS:
    launches[f"coupled_apply_ablated[{_name}]"] = 0

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "coupled_matvec.cu"
_lib = None
build_info: dict = {}


class ApplyScalars(NamedTuple):
    """Per-step scalars of the coupled apply (host floats)."""

    beta: float  # weight of the divergence terms of the convection
    weight: float  # BDF weight of the new value
    tau1: float  # implicit weight of the spatial terms
    rho: float  # constant density
    mu: float  # constant viscosity
    damping: float  # constant damping (stored with flipped sign)
    tau_grad_div: float


# ---------------------------------------------------------------------------
# host-side tables
# ---------------------------------------------------------------------------
def _tensor_nd(mats):
    """Tensor-product matrix of per-axis 1D matrices (z..x order, x
    fastest)."""
    out = mats[0]
    for m in mats[1:]:
        out = np.einsum("ai,bj->abij", out, m).reshape(
            out.shape[0] * m.shape[0], out.shape[1] * m.shape[1]
        )
    return out


class MatvecTables(NamedTuple):
    # shapes for 3D Q2/Q1 (n_cols = 3*27 + 8 = 89, n_q = 27)
    A_evg: np.ndarray  # (dim (dim+1) n_q, n_cols) values + gradients of u
    M_mass: np.ndarray  # (n_cols, n_cols) sum_c V^T W V
    M_visc: np.ndarray  # (n_cols, n_cols) symmetric-gradient stress
    M_gd: np.ndarray  # (n_cols, n_cols) grad-div
    M_pdiv: np.ndarray  # (n_cols, n_cols) -grad p test + (-div u) pressure row
    A_ic: np.ndarray  # (n_cols, dim n_q) convective integration
    n_u_loc: int
    n_p_loc: int
    n_q: int
    dim: int


def _grad_mats(Vu, Du, inv_h, dim):
    # G[a] = physical derivative along axis a (a = 0 is x)
    return [
        _tensor_nd([Du if dim - 1 - ax == a else Vu for ax in range(dim)])
        * inv_h[a]
        for a in range(dim)
    ]


def build_tables(ev_u, ev_p) -> MatvecTables:
    """Dense cell matrices from the uniform-geometry evaluators of the NS
    operator (float64 numpy). Unlike the TPU package, the q-point rows are
    not padded to a sublane stride."""
    Vu, Du, Vp = ev_u.V_np, ev_u.D_np, ev_p.V_np
    inv_h = 1.0 / np.asarray(ev_u.h, np.float64)
    dim = len(inv_h)
    Vq = _tensor_nd([Vu] * dim)
    G = _grad_mats(Vu, Du, inv_h, dim)
    Vpq = _tensor_nd([Vp] * dim)
    n_u, n_p, n_q = Vq.shape[1], Vpq.shape[1], Vq.shape[0]
    n_cols = dim * n_u + n_p
    W = np.diag(ev_u.jxw_np)
    parts = dim + 1

    A_evg = np.zeros((dim * parts * n_q, n_cols))
    for c in range(dim):
        r0, c0 = c * parts * n_q, c * n_u
        A_evg[r0 : r0 + n_q, c0 : c0 + n_u] = Vq
        for d in range(dim):
            A_evg[r0 + (1 + d) * n_q : r0 + (2 + d) * n_q, c0 : c0 + n_u] = G[d]

    M_mass = np.zeros((n_cols, n_cols))
    M_visc = np.zeros((n_cols, n_cols))
    M_gd = np.zeros((n_cols, n_cols))
    M_pdiv = np.zeros((n_cols, n_cols))
    VtWV = Vq.T @ W @ Vq
    GtWG = [[G[a].T @ W @ G[b] for b in range(dim)] for a in range(dim)]
    sum_GtWG = sum(GtWG[a][a] for a in range(dim))
    for c in range(dim):
        c0 = c * n_u
        M_mass[c0 : c0 + n_u, c0 : c0 + n_u] = VtWV
        for e in range(dim):
            e0 = e * n_u
            # viscous: out_c = sum_d G_d^T W (G_d u_c + G_c u_d)
            blk = GtWG[e][c] + (sum_GtWG if c == e else 0.0)
            M_visc[c0 : c0 + n_u, e0 : e0 + n_u] = blk
            # grad-div: out_c = G_c^T W sum_e G_e u_e
            M_gd[c0 : c0 + n_u, e0 : e0 + n_u] = GtWG[c][e]
        # divergence row: out_p = -Vp^T W sum_e G_e u_e
        M_pdiv[dim * n_u :, c0 : c0 + n_u] = -Vpq.T @ W @ G[c]
        # pressure gradient: out_c = -G_c^T W Vp p
        M_pdiv[c0 : c0 + n_u, dim * n_u :] = -G[c].T @ W @ Vpq

    # convective integration: out_c = V^T W n_c
    A_ic = np.zeros((n_cols, dim * n_q))
    for c in range(dim):
        A_ic[c * n_u : (c + 1) * n_u, c * n_q : (c + 1) * n_q] = Vq.T @ W
    return MatvecTables(A_evg, M_mass, M_visc, M_gd, M_pdiv, A_ic, n_u, n_p, n_q, dim)


def combine_linear(tables: MatvecTables, scalars: ApplyScalars):
    """Per-step combination of the constant-coefficient linear terms:
    (M89, A_ics) with M89 = (rho w - d) M_mass + tau1 mu M_visc + tgd M_gd
    + M_pdiv and A_ics = tau1 rho A_ic."""
    s = scalars
    M = (
        (s.rho * s.weight - s.damping) * tables.M_mass
        + (s.tau1 * s.mu) * tables.M_visc
        + s.tau_grad_div * tables.M_gd
        + tables.M_pdiv
    )
    return M, (s.tau1 * s.rho) * tables.A_ic


def build_tables_ig(tables: MatvecTables, ev_u) -> np.ndarray:
    """Symmetric-stress integration matrix for the variable-coefficient mode:
    out_c = sum_d G_d^T W st_(cd) with st the upper symmetric stress row
    groups ordered (0,0),(0,1),(0,2),(1,1),(1,2),(2,2)."""
    inv_h = 1.0 / np.asarray(ev_u.h, np.float64)
    dim = len(inv_h)
    G = _grad_mats(ev_u.V_np, ev_u.D_np, inv_h, dim)
    W = np.diag(ev_u.jxw_np)
    n_u, n_q = tables.n_u_loc, tables.n_q
    n_cols = dim * n_u + tables.n_p_loc
    pairs = [(a, b) for a in range(dim) for b in range(a, dim)]
    A_ig = np.zeros((n_cols, len(pairs) * n_q))
    for k, (a, b) in enumerate(pairs):
        A_ig[a * n_u : (a + 1) * n_u, k * n_q : (k + 1) * n_q] += G[b].T @ W
        if a != b:
            A_ig[b * n_u : (b + 1) * n_u, k * n_q : (k + 1) * n_q] += G[a].T @ W
    return A_ig


class CoupledCells:
    """What the coupled apply needs of a lattice discretization: the cell ->
    dof tables, the constrained-dof masks, the 1D basis tables for the kernel
    and (built on first use) the dense tables for the plain version.

    ev_u / ev_p: the operator's velocity and pressure evaluators (uniform
    geometry, (degree+1)-point Gauss). cell_u (E, n_loc_u), cell_p
    (E, n_loc_p): int32 tables. mask_u (dim, n_u) / mask_p (n_p,): bool,
    True on constrained (Dirichlet) dofs, or None."""

    def __init__(self, ev_u, ev_p, cell_u, cell_p, mask_u, mask_p, device,
                 lattice=None):
        """lattice: (cells per axis, periodic per axis) of the uniform
        lattice the tables number, for the table-free entry (K11), or
        None."""
        self.dim = ev_u.dim
        self.lattice = lattice
        self.degree = ev_u.n_1d - 1
        if (self.dim, self.degree) not in TABLE_SETS:
            raise NotImplementedError(
                f"coupled apply: no kernel for dim={self.dim}, "
                f"degree={self.degree} (table sets: Q2/Q1 and Q3/Q2 in 2D and 3D)"
            )
        if ev_u.n_q_1d != ev_u.n_1d or ev_p.n_q_1d != ev_u.n_q_1d:
            raise ValueError("coupled apply expects (degree+1)-point Gauss rules")
        self.ev_u, self.ev_p = ev_u, ev_p
        self.device = torch.device(device)
        self.n_cells = int(cell_u.shape[0])
        self.n_q = ev_u.n_q
        # the least vector lengths the tables index into
        self.min_n_u = int(np.max(cell_u)) + 1
        self.min_n_p = int(np.max(cell_p)) + 1
        self.cell_u = torch.as_tensor(
            np.ascontiguousarray(cell_u, np.int32), device=self.device
        )
        self.cell_p = torch.as_tensor(
            np.ascontiguousarray(cell_p, np.int32), device=self.device
        )
        self.device = self.cell_u.device  # with its index: "cuda" -> "cuda:0"
        self.mask_u = (
            None if mask_u is None
            else torch.as_tensor(np.asarray(mask_u, bool), device=self.device)
        )
        self.mask_p = (
            None if mask_p is None
            else torch.as_tensor(np.asarray(mask_p, bool), device=self.device)
        )
        self._mask_u8 = None if mask_u is None else self.mask_u.to(torch.uint8)
        self._mask_p8 = None if mask_p is None else self.mask_p.to(torch.uint8)
        h = np.asarray(ev_u.h, np.float64)
        # [V (Q1 x N1), D (Q1 x N1), Vp (Q1 x P1), w (Q1), 1/h (dim), vol]
        self.tab_host = np.ascontiguousarray(
            np.concatenate(
                [
                    ev_u.V_np.ravel(),
                    ev_u.D_np.ravel(),
                    ev_p.V_np.ravel(),
                    ev_u.w1,
                    1.0 / h,
                    [float(np.prod(h))],
                ]
            ),
            np.float64,
        )
        self._dense = {}
        self._probe = {}
        self._m89 = {}

    def probe_tables(self, device, dtype, sc: Optional[ApplyScalars] = None):
        """The per-axis-product matrices of the probe variants' plain
        version as tensors on (device, dtype): Vq (n_q, n_u), Gref (dim, n_q,
        n_u) reference derivatives on the unit cell, Vpq (n_q, n_p), JxW
        (n_q,), 1/h (dim,); and with sc, M89 (n_cols, n_cols) of
        combine_linear, contiguous (the kernel's kPhMDot reads it)."""
        key = (device, dtype)
        if key not in self._probe:
            ev_u, ev_p, dim = self.ev_u, self.ev_p, self.dim
            Vu, Du = ev_u.V_np, ev_u.D_np
            mats = {
                "Vq": _tensor_nd([Vu] * dim),
                "Gref": np.stack([
                    _tensor_nd([Du if dim - 1 - ax == a else Vu for ax in range(dim)])
                    for a in range(dim)
                ]),
                "Vpq": _tensor_nd([ev_p.V_np] * dim),
                "jxw": np.asarray(ev_u.jxw_np, np.float64),
                "inv_h": 1.0 / np.asarray(ev_u.h, np.float64),
            }
            self._probe[key] = {
                k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in mats.items()
            }
        out = dict(self._probe[key])
        if sc is not None:
            mkey = (device, dtype, sc)
            if mkey not in self._m89:
                M89 = combine_linear(build_tables(self.ev_u, self.ev_p), sc)[0]
                self._m89[mkey] = torch.as_tensor(
                    np.ascontiguousarray(M89), dtype=dtype, device=device
                )
            out["M89"] = self._m89[mkey]
        return out

    def dense(self, device, dtype):
        """Dense tables of the plain version as tensors on (device, dtype)."""
        key = (device, dtype)
        if key not in self._dense:
            t = build_tables(self.ev_u, self.ev_p)
            ig = build_tables_ig(t, self.ev_u)
            self._dense[key] = (t, ig, {
                name: torch.as_tensor(getattr(t, name), dtype=dtype, device=device)
                for name in ("A_evg", "M_mass", "M_visc", "M_gd", "M_pdiv", "A_ic")
            } | {"A_ig": torch.as_tensor(ig, dtype=dtype, device=device)})
        return self._dense[key]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _gather_plain(u, p, u_star, cells: CoupledCells):
    """Index gather of the nodal vectors: x (E, n_cols) with the constrained
    entries of u and p zero (zero pressure columns for p=None) and the u*
    cell dofs (E, dim n_u)."""
    dim, E = cells.dim, cells.n_cells
    npl = cells.ev_p.n_local
    cu = cells.cell_u.to(u.device).long()
    cp = cells.cell_p.to(u.device).long()
    mask_u = None if cells.mask_u is None else cells.mask_u.to(u.device)
    mask_p = None if cells.mask_p is None else cells.mask_p.to(u.device)
    uu = u if mask_u is None else u.masked_fill(mask_u, 0.0)
    cols = [uu[c][cu] for c in range(dim)]
    if p is None:
        cols.append(u.new_zeros((E, npl)))
    else:
        pp = p if mask_p is None else p.masked_fill(mask_p, 0.0)
        cols.append(pp[cp])
    s = torch.cat([u_star[c][cu] for c in range(dim)], dim=1)
    return torch.cat(cols, dim=1), s


def _block_plain(x, s, cells: CoupledCells, sc: ApplyScalars, coeffs=None):
    """The cell math on a cell block: x (E, n_cols) -> (E, n_cols). s: the
    u* cell dofs (E, dim n_u) or the u* q-fields (E, dim (dim+1), n_q)."""
    dim, n_q = cells.dim, cells.n_q
    tabs, _, T = cells.dense(x.device, x.dtype)
    nl = tabs.n_u_loc
    r = x @ T["A_evg"].T
    if s.dim() == 3:
        sq = s.reshape(s.shape[0], -1)  # the rows of A_evg, in its order
    else:
        sq = s @ T["A_evg"][:, : dim * nl].T
    parts = dim + 1

    def rows(block, part, c):
        i0 = (c * parts + part) * n_q
        return block[:, i0 : i0 + n_q]

    val_u = [rows(r, 0, c) for c in range(dim)]
    g_u = [[rows(r, 1 + d, c) for d in range(dim)] for c in range(dim)]
    val_s = [rows(sq, 0, c) for c in range(dim)]
    g_s = [[rows(sq, 1 + d, c) for d in range(dim)] for c in range(dim)]
    div = sum(g_u[a][a] for a in range(dim))
    div_s = sum(g_s[a][a] for a in range(dim))
    conv = []
    for c in range(dim):
        t = sc.beta * (div * val_s[c] + div_s * val_u[c])
        for e in range(dim):
            t = t + val_s[e] * g_u[c][e] + val_u[e] * g_s[c][e]
        conv.append(t)

    coeffs = coeffs if coeffs is not None else (None, None, None)
    rho, mu, damp = coeffs[0], coeffs[1], coeffs[2]
    if rho is None and mu is None and damp is None:
        M89, A_ics = combine_linear(tabs, sc)
        M89 = torch.as_tensor(M89, dtype=x.dtype, device=x.device)
        A_ics = torch.as_tensor(A_ics, dtype=x.dtype, device=x.device)
        out = x @ M89.T + torch.cat(conv, dim=1) @ A_ics.T
    else:
        cr = rho if rho is not None else sc.rho
        cm = mu if mu is not None else sc.mu
        cd = damp if damp is not None else sc.damping
        n = torch.cat(
            [
                cr * (sc.weight * val_u[c] + sc.tau1 * conv[c]) - cd * val_u[c]
                for c in range(dim)
            ],
            dim=1,
        )
        tmu = sc.tau1 * cm
        st = torch.cat(
            [
                tmu * (g_u[a][b] + g_u[b][a])
                for a in range(dim)
                for b in range(a, dim)
            ],
            dim=1,
        )
        M = sc.tau_grad_div * T["M_gd"] + T["M_pdiv"]
        out = x @ M.T + n @ T["A_ic"].T + st @ T["A_ig"].T
    return out


def coupled_apply_plain(
    u, p, u_star, cells: CoupledCells, sc: ApplyScalars, *,
    coeffs=None, identity: bool = True, scale: Optional[float] = None,
    want_norm: bool = False, velocity_only: bool = False,
):
    """The coupled apply in plain PyTorch (dense cell matrices, index
    gather and index_add_ scatter). Same arguments and results as
    coupled_apply (velocity_only=True: as coupled_apply_velocity)."""
    plain_calls["coupled_apply_plain"] += 1
    dim, nl = cells.dim, cells.ev_u.n_local
    x, s = _gather_plain(u, p, u_star, cells)
    out = _block_plain(x, s, cells, sc, coeffs)
    cu = cells.cell_u.to(u.device).long()
    cp = cells.cell_p.to(u.device).long()
    mask_u = None if cells.mask_u is None else cells.mask_u.to(u.device)
    mask_p = None if cells.mask_p is None else cells.mask_p.to(u.device)
    out_u = torch.zeros_like(u)
    for c in range(dim):
        out_u[c].index_add_(
            0, cu.reshape(-1), out[:, c * nl : (c + 1) * nl].reshape(-1)
        )
    out_p = None
    if not velocity_only:
        out_p = torch.zeros_like(p)
        out_p.index_add_(0, cp.reshape(-1), out[:, dim * nl :].reshape(-1))
    # constrained rows: identity (+x velocity, -x pressure) or zero
    if mask_u is not None:
        out_u = torch.where(mask_u, u if identity else 0.0, out_u)
    if out_p is not None and mask_p is not None:
        out_p = torch.where(mask_p, -p if identity else 0.0, out_p)
    if scale is not None:
        out_u = out_u * scale
        out_p = None if out_p is None else out_p * scale
    if velocity_only:
        return out_u
    if want_norm:
        norm = (out_u * out_u).sum() + (out_p * out_p).sum()
        return out_u, out_p, norm
    return out_u, out_p


def coupled_apply_cells_plain(
    x, s, cells: CoupledCells, sc: ApplyScalars, *, velocity_only: bool = False
):
    """K3 in plain PyTorch: same arguments and results as
    coupled_apply_cells."""
    plain_calls["coupled_apply_cells_plain"] += 1
    if velocity_only:
        zp = x.new_zeros((x.shape[0], cells.ev_p.n_local))
        return _block_plain(torch.cat([x, zp], dim=1), s, cells, sc)[:, : x.shape[1]]
    return _block_plain(x, s, cells, sc)


def coupled_apply_gather_plain(u, p, u_star, cells: CoupledCells, sc: ApplyScalars):
    """K4 in plain PyTorch: same arguments and results as
    coupled_apply_gather."""
    plain_calls["coupled_apply_gather_plain"] += 1
    x, s = _gather_plain(u, p, u_star, cells)
    out = _block_plain(x, s, cells, sc)
    return out if p is not None else out[:, : cells.dim * cells.ev_u.n_local]


def _owned(n1: int, dim: int) -> np.ndarray:
    """Local dofs (n1 per axis, x fastest) that a cell owns: no local
    coordinate on the cell's high face (the kernel's owned())."""
    loc = np.arange(n1**dim)
    own = np.ones(n1**dim, bool)
    for a in range(dim):
        own &= (loc // n1**a) % n1 != n1 - 1
    return own


def coupled_apply_ablated_plain(u, p, u_star, cells: CoupledCells, sc: ApplyScalars,
                                phases: str):
    """K12/K13 in plain PyTorch: the cell kernel with the phases of VARIANTS
    [phases], each dropped phase replaced as the kernel replaces it, step by
    step on the kernel's own intermediates (final fields with reference
    gradients, the q-point rows with JxW and 1/h folded in) from the dense
    per-axis-product tables. Nodal (out_u, out_p), no constraint rows. A
    schedule of K13_SCHEDULES computes the full apply, so its plain version
    is full's."""
    plain_calls["coupled_apply_ablated_plain"] += 1
    ph = VARIANTS[phases]
    dim, E = cells.dim, cells.n_cells
    nl, npl, nq = cells.ev_u.n_local, cells.ev_p.n_local, cells.n_q
    T = cells.probe_tables(u.device, u.dtype, sc if ph & PH_MDOT else None)
    cu = cells.cell_u.to(u.device).long()
    cp = cells.cell_p.to(u.device).long()
    mask_u = None if cells.mask_u is None else cells.mask_u.to(u.device)
    mask_p = None if cells.mask_p is None else cells.mask_p.to(u.device)
    uu = u if mask_u is None else u.masked_fill(mask_u, 0.0)
    pp = p if mask_p is None else p.masked_fill(mask_p, 0.0)

    # gather: through the tables, at contiguous addresses, or (dropped) the
    # cell's first dof spread as v (l + 1) over its local dofs l
    ramp_u = ramp_p = 1.0
    if ph & PH_CONTIG:
        e = torch.arange(E, device=u.device)[:, None]
        iu = (e * nl + torch.arange(nl, device=u.device)) % u.shape[1]
        ip = (e * npl + torch.arange(npl, device=u.device)) % p.shape[0]
    elif ph & PH_GATHER:
        iu, ip = cu, cp
    else:
        iu = cu[:, :1].expand(E, nl)
        ip = cp[:, :1].expand(E, npl)
        ramp_u = torch.arange(1, nl + 1, dtype=u.dtype, device=u.device)
        ramp_p = torch.arange(1, npl + 1, dtype=u.dtype, device=u.device)
    xu = torch.stack([uu[c][iu] * ramp_u for c in range(dim)], dim=1)  # (E, dim, nl)
    xs = torch.stack([u_star[c][iu] * ramp_u for c in range(dim)], dim=1)
    xp = pp[ip] * ramp_p  # (E, npl)

    if ph & PH_MDOT:
        x = torch.cat([xu.reshape(E, -1), xp], dim=1)
        out = x @ T["M89"].T
        ou, op = out[:, : dim * nl].reshape(E, dim, nl), out[:, dim * nl :]
    else:
        # final fields (E, dim, dim + 1, n_q): value, reference derivatives
        def evaluate(xc):
            return torch.stack(
                [xc @ T["Vq"].T] + [xc @ T["Gref"][d].T for d in range(dim)], dim=2
            )

        def copied(xc):
            return xc[:, :, None, :nq].expand(E, dim, dim + 1, nq)

        Fu = evaluate(xu) if ph & PH_EVAL_U else copied(xu)
        Fs = evaluate(xs) if ph & PH_EVAL_USTAR else copied(xs)
        if ph & PH_EVAL_U:
            Fp = xp @ T["Vpq"].T
        else:
            Fp = xp[:, torch.arange(nq, device=u.device) % npl]
        inv_h, jxw = T["inv_h"], T["jxw"]
        if ph & PH_QPOINT:
            uv, sv = Fu[:, :, 0], Fs[:, :, 0]
            ug = Fu[:, :, 1:] * inv_h[None, None, :, None]
            sg = Fs[:, :, 1:] * inv_h[None, None, :, None]
            div = sum(ug[:, a, a] for a in range(dim))
            div_s = sum(sg[:, a, a] for a in range(dim))
            value, stress = [], []
            for c in range(dim):
                conv = sc.beta * (div * sv[:, c] + div_s * uv[:, c])
                for e_ in range(dim):
                    conv = conv + sv[:, e_] * ug[:, c, e_] + uv[:, e_] * sg[:, c, e_]
                v = (sc.rho * sc.weight - sc.damping) * uv[:, c] + sc.tau1 * sc.rho * conv
                value.append(v * jxw)
                row = []
                for d in range(dim):
                    st = sc.tau1 * sc.mu * (ug[:, c, d] + ug[:, d, c])
                    if c == d:
                        st = st + sc.tau_grad_div * div - Fp
                    row.append(st * jxw * inv_h[d])
                stress.append(torch.stack(row, dim=1))
            value = torch.stack(value, dim=1)  # (E, dim, n_q)
            stress = torch.stack(stress, dim=1)  # (E, dim, dim, n_q)
            prow = -div * jxw
        else:
            value, stress, prow = Fu[:, :, 0], Fs[:, :, 1:], Fp
        if ph & PH_INTEGRATE:
            ou = value @ T["Vq"] + sum(
                stress[:, :, d] @ T["Gref"][d] for d in range(dim)
            )
            op = prow @ T["Vpq"]
        else:
            ou, op = value[:, :, :nl], prow[:, :npl]

    out_u, out_p = torch.zeros_like(u), torch.zeros_like(p)
    if ph & PH_SCATTER:
        for c in range(dim):
            out_u[c].index_add_(0, cu.reshape(-1), ou[:, c].reshape(-1))
        out_p.index_add_(0, cp.reshape(-1), op.reshape(-1))
    else:
        n1 = cells.degree + 1
        own_u = torch.as_tensor(_owned(n1, dim), device=u.device)
        own_p = torch.as_tensor(_owned(n1 - 1, dim), device=u.device)
        for c in range(dim):
            out_u[c][cu[:, own_u].reshape(-1)] = ou[:, c][:, own_u].reshape(-1)
        out_p[cp[:, own_p].reshape(-1)] = op[:, own_p].reshape(-1)
    return out_u, out_p


def scatter_cells_plain(block, cells: CoupledCells, out_u, out_p):
    """K6 in plain PyTorch: index_add_ of the (E, n_cols) block into out_u
    and out_p (in place) through the cell tables; returns (out_u, out_p)."""
    plain_calls["scatter_cells_plain"] += 1
    dim, nl = cells.dim, cells.ev_u.n_local
    cu = cells.cell_u.to(block.device).long().reshape(-1)
    cp = cells.cell_p.to(block.device).long().reshape(-1)
    for c in range(dim):
        out_u[c].index_add_(0, cu, block[:, c * nl : (c + 1) * nl].reshape(-1))
    out_p.index_add_(0, cp, block[:, dim * nl :].reshape(-1))
    return out_u, out_p


def lattice_cell_dofs(n_cells_axis, degree: int, periodic=(False, False, False)) -> np.ndarray:
    """(E, (degree+1)^3) int64: the dof of each cell's local dof on the
    uniform 3D lattice, from the cell's lattice coordinates, as the K11 and
    K6 kernels compute it (lattice_dof and scatter_tiles_kernel in
    csrc/coupled_matvec.cu): a periodic axis has degree n_c nodes, and its
    node degree n_c is node 0. Equals LatticeOps.cell_dof_table() there."""
    ncx, ncy, ncz = n_cells_axis
    n1 = degree + 1
    e = np.arange(ncx * ncy * ncz)[:, None]
    cx, cy, cz = e % ncx, (e // ncx) % ncy, e // (ncx * ncy)
    loc = np.arange(n1**3)[None, :]
    lx, ly, lz = loc % n1, (loc // n1) % n1, loc // (n1 * n1)
    nx, ny, nz = (degree * n + (0 if w else 1) for n, w in zip(n_cells_axis, periodic))
    return ((degree * cz + lz) % nz * ny + (degree * cy + ly) % ny) * nx + (degree * cx + lx) % nx


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------
def library_path() -> Path:
    """The built kernel library (built here when its source's hash is new)."""
    return build_library(_SOURCE, "coupled_matvec", build_info)


def load_library():
    """Build (once, keyed by the source's hash) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(library_path())))
    return _lib


def bind(lib):
    """Declare the C entries' argument and result types on a loaded
    library of csrc/coupled_matvec.cu."""
    vp, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.adaflo_coupled_cells.argtypes = [i] * 5 + [vp] * 12 + [ll, ll, vp, vp, vp]
    lib.adaflo_coupled_cells.restype = i
    lib.adaflo_coupled_epilogue.argtypes = [i] + [vp] * 6 + [ll, ll, i, d, vp, vp]
    lib.adaflo_coupled_epilogue.restype = i
    lib.adaflo_coupled_variant.argtypes = [i] * 4 + [vp] * 10 + [ll, ll, ll, i, i, vp, vp, vp]
    lib.adaflo_coupled_variant.restype = i
    lib.adaflo_scatter_cells.argtypes = [i] + [vp] * 3 + [ll] + [i] * 4 + [vp]
    lib.adaflo_scatter_cells.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.adaflo_scatter_plan.argtypes = [i] * 4 + [ip] * 4 + [ctypes.POINTER(ll)]
    lib.adaflo_scatter_plan.restype = i
    lib.adaflo_coupled_residency.argtypes = [i, i, i, ip, ip, ip]
    lib.adaflo_coupled_residency.restype = i
    lib.adaflo_coupled_geometry.argtypes = [i] * 5 + [ip] * 3
    lib.adaflo_coupled_geometry.restype = i
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    """The current CUDA stream of `device`, as the handle the C entries take."""
    return torch.cuda.current_stream(device).cuda_stream


def _check(u, p, u_star, cells: CoupledCells, coeffs):
    dim = cells.dim
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"coupled apply: dtype {u.dtype} not supported")
    if u.dim() != 2 or u.shape[0] != dim:
        raise ValueError(f"coupled apply: u must be (dim, n_u), got {tuple(u.shape)}")
    tensors = [u, u_star] + ([p] if p is not None else [])
    tensors += [c for c in (coeffs or ()) if c is not None]
    for t in tensors:
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError("coupled apply: all tensors need one device and dtype")
        if not t.is_contiguous():
            raise ValueError("coupled apply: tensors must be contiguous")
    if u_star.shape != u.shape:
        raise ValueError("coupled apply: u_star must have the shape of u")
    if p is not None and p.dim() != 1:
        raise ValueError("coupled apply: p must be (n_p,)")
    if u.shape[1] < cells.min_n_u or (p is not None and p.shape[0] < cells.min_n_p):
        raise ValueError("coupled apply: vectors shorter than the cell tables' dofs")
    if cells.mask_u is not None and tuple(cells.mask_u.shape) != tuple(u.shape):
        raise ValueError("coupled apply: velocity mask must have the shape of u")
    if p is not None and cells.mask_p is not None and tuple(cells.mask_p.shape) != tuple(p.shape):
        raise ValueError("coupled apply: pressure mask must have the shape of p")
    for c in coeffs or ():
        if c is not None and tuple(c.shape) != (cells.n_cells, cells.n_q):
            raise ValueError("coupled apply: coefficients must be (n_cells, n_q)")
    if u.is_cuda and cells.device != u.device:
        raise ValueError("coupled apply: cell tables live on another device")


def _launch_cells(mode, pres, u, p, u_star, cells, sc, coeffs, out_u, out_p):
    """One launch of the cell kernel. MODE_NODAL / MODE_GATHER: u, p, u_star
    nodal, read through the cell tables; MODE_CELLS(_QFIELDS): u is the cell
    block x, u_star the stream, p None. pres: the entry has a pressure."""
    lib = load_library()
    nodal = mode in (MODE_NODAL, MODE_GATHER)
    coeffs = coeffs if coeffs is not None else (None, None, None)
    scal = np.asarray(
        [sc.beta, sc.weight, sc.tau1, sc.rho, sc.mu, sc.damping, sc.tau_grad_div],
        np.float64,
    )
    stream = _stream(u.device)
    rc = lib.adaflo_coupled_cells(
        1 if u.dtype == torch.float64 else 0, mode, 1 if pres else 0,
        cells.dim, cells.degree, _ptr(u), _ptr(p), _ptr(u_star),
        _ptr(cells.cell_u if nodal else None), _ptr(cells.cell_p if nodal else None),
        _ptr(cells._mask_u8 if nodal else None),
        _ptr(cells._mask_p8 if nodal and p is not None else None),
        _ptr(coeffs[0]), _ptr(coeffs[1]), _ptr(coeffs[2]),
        _ptr(out_u), _ptr(out_p), u.shape[1] if nodal else 0, cells.n_cells,
        cells.tab_host.ctypes.data, scal.ctypes.data, stream,
    )
    if rc != 0:
        raise RuntimeError(f"coupled apply kernel launch failed (CUDA error {rc})")


def _launch_epilogue(u, p, cells, out_u, out_p, identity, scale, norm):
    lib = load_library()
    stream = _stream(u.device)
    rc = lib.adaflo_coupled_epilogue(
        1 if u.dtype == torch.float64 else 0,
        _ptr(out_u), _ptr(out_p), _ptr(u), _ptr(p),
        _ptr(cells._mask_u8), _ptr(cells._mask_p8 if out_p is not None else None),
        out_u.numel(), 0 if out_p is None else out_p.numel(),
        1 if identity else 0, 1.0 if scale is None else float(scale),
        _ptr(norm), stream,
    )
    if rc != 0:
        raise RuntimeError(f"coupled apply epilogue failed (CUDA error {rc})")


def coupled_apply(
    u, p, u_star, cells: CoupledCells, sc: ApplyScalars, *,
    coeffs=None, identity: bool = True, scale: Optional[float] = None,
    want_norm: bool = False,
):
    """K1: coupled Newton apply (r_u, r_p) = A(u*) (u, p), nodal in and out.

    coeffs: optional (rho, mu, damping), each (n_cells, n_q) or None.
    identity: constrained rows read +u / -p (else 0). scale: output factor.
    want_norm: also return sum(out^2) as a 0-d tensor."""
    _check(u, p, u_star, cells, coeffs)
    if p is None:
        raise ValueError("coupled_apply needs a pressure vector")
    if u.device.type == "cpu":
        return coupled_apply_plain(
            u, p, u_star, cells, sc, coeffs=coeffs, identity=identity,
            scale=scale, want_norm=want_norm,
        )
    if not u.is_cuda:
        raise RuntimeError(f"coupled apply: no kernel for device {u.device}")
    out_u = torch.zeros_like(u)
    out_p = torch.zeros_like(p)
    _launch_cells(MODE_NODAL, True, u, p, u_star, cells, sc, coeffs, out_u, out_p)
    launches["coupled_apply"] += 1
    norm = torch.zeros((), dtype=u.dtype, device=u.device) if want_norm else None
    _launch_epilogue(u, p, cells, out_u, out_p, identity, scale, norm)
    return (out_u, out_p, norm) if want_norm else (out_u, out_p)


def coupled_apply_velocity(
    u, u_star, cells: CoupledCells, sc: ApplyScalars, *, coeffs=None
):
    """K2: velocity-block apply r_u = A_uu(u*) u with no pressure input and
    no pressure rows; constrained rows read +u (identity)."""
    _check(u, None, u_star, cells, coeffs)
    if u.device.type == "cpu":
        return coupled_apply_plain(
            u, None, u_star, cells, sc, coeffs=coeffs, velocity_only=True
        )
    if not u.is_cuda:
        raise RuntimeError(f"coupled apply: no kernel for device {u.device}")
    out_u = torch.zeros_like(u)
    _launch_cells(MODE_NODAL, False, u, None, u_star, cells, sc, coeffs, out_u, None)
    launches["coupled_apply_velocity"] += 1
    if cells.mask_u is not None:
        _launch_epilogue(u, None, cells, out_u, None, True, None, None)
    return out_u


def _check_cells(x, s, cells: CoupledCells, velocity_only: bool):
    dim, E = cells.dim, cells.n_cells
    nl, npl = cells.ev_u.n_local, cells.ev_p.n_local
    n_cols = dim * nl + (0 if velocity_only else npl)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"coupled apply: dtype {x.dtype} not supported")
    if tuple(x.shape) != (E, n_cols):
        raise ValueError(
            f"coupled apply: the cell block must be {(E, n_cols)}, got {tuple(x.shape)}"
        )
    if tuple(s.shape) not in ((E, dim * nl), (E, dim * (dim + 1), cells.n_q)):
        raise ValueError(
            f"coupled apply: the u* stream must be the cell dofs {(E, dim * nl)} "
            f"or the q-fields {(E, dim * (dim + 1), cells.n_q)}, got {tuple(s.shape)}"
        )
    if s.device != x.device or s.dtype != x.dtype:
        raise ValueError("coupled apply: all tensors need one device and dtype")
    if not (x.is_contiguous() and s.is_contiguous()):
        raise ValueError("coupled apply: tensors must be contiguous")


def coupled_apply_cells(
    x, s, cells: CoupledCells, sc: ApplyScalars, *, velocity_only: bool = False
):
    """K3: the coupled apply of cell blocks, constant coefficients, no
    scatter and no constraint rows (the caller gathers and scatters).

    x: (E, n_cols) cell dofs [u_0 .. u_(dim-1) | p] (velocity_only: the
    (E, dim n_u) velocity dofs, with a zero pressure). s: the u* cell dofs
    (E, dim n_u) or the u* values and physical gradients at the q points
    (E, dim (dim+1), n_q), [value, d/dx_0, ..] per component. Returns a
    block shaped like x."""
    _check_cells(x, s, cells, velocity_only)
    if x.device.type == "cpu":
        return coupled_apply_cells_plain(x, s, cells, sc, velocity_only=velocity_only)
    if not x.is_cuda:
        raise RuntimeError(f"coupled apply: no kernel for device {x.device}")
    qfields = s.dim() == 3
    out = torch.empty_like(x)
    mode = MODE_CELLS_QFIELDS if qfields else MODE_CELLS
    _launch_cells(mode, not velocity_only, x, None, s, cells, sc, None, out, None)
    key = "coupled_apply_cells" + ("_qfields" if qfields else "")
    launches[key + ("_velocity" if velocity_only else "")] += 1
    return out


def coupled_apply_gather(u, p, u_star, cells: CoupledCells, sc: ApplyScalars):
    """K4: the coupled apply with K1's gather from the nodal u, p and u*
    (constrained entries of u and p read as zero) and K3's unscattered
    output: the (E, n_cols) cell block, or the (E, dim n_u) velocity block
    for p=None. Constant coefficients."""
    _check(u, p, u_star, cells, None)
    if u.device.type == "cpu":
        return coupled_apply_gather_plain(u, p, u_star, cells, sc)
    if not u.is_cuda:
        raise RuntimeError(f"coupled apply: no kernel for device {u.device}")
    n_cols = cells.dim * cells.ev_u.n_local + (0 if p is None else cells.ev_p.n_local)
    out = torch.empty((cells.n_cells, n_cols), dtype=u.dtype, device=u.device)
    _launch_cells(MODE_GATHER, p is not None, u, p, u_star, cells, sc, None, out, None)
    launches["coupled_apply_gather" + ("_velocity" if p is None else "")] += 1
    return out


def _probe_cells(cells: CoupledCells, what: str):
    if (cells.dim, cells.degree) != (3, 2):
        raise NotImplementedError(
            f"{what}: instanced for 3D Q2/Q1 only (the probes' configuration), "
            f"got dim={cells.dim}, degree={cells.degree}"
        )


def _launch_variant(phases: int, lattice, u, p, u_star, cells, sc, M, out_u, out_p,
                    sched: int = SCHED_ONCE):
    """One launch of a probe instance of the cell kernel (K12/K13 by phase
    mask, K13's schedules by `sched`, or K11 with lattice = (ncx, ncy) and no
    cell tables). The cells per axis of cells.lattice go with every launch
    (the pipe schedule's bulk copies address the lattice)."""
    lib = load_library()
    scal = np.asarray(
        [sc.beta, sc.weight, sc.tau1, sc.rho, sc.mu, sc.damping, sc.tau_grad_div],
        np.float64,
    )
    if lattice is not None:
        ncx, ncy = lattice
    elif cells.lattice is not None:
        ncx, ncy = cells.lattice[0][:2]
    else:
        ncx, ncy = 0, 0
    rc = lib.adaflo_coupled_variant(
        1 if u.dtype == torch.float64 else 0, phases, 0 if lattice is None else 1, sched,
        _ptr(u), _ptr(p), _ptr(u_star),
        None if lattice is not None else _ptr(cells.cell_u),
        None if lattice is not None else _ptr(cells.cell_p),
        _ptr(cells._mask_u8), _ptr(cells._mask_p8), _ptr(M), _ptr(out_u), _ptr(out_p),
        u.shape[1], p.shape[0], cells.n_cells, ncx, ncy,
        cells.tab_host.ctypes.data, scal.ctypes.data, _stream(u.device),
    )
    if rc != 0:
        raise RuntimeError(f"coupled apply probe kernel launch failed (CUDA error {rc})")


def coupled_apply_ablated(u, p, u_star, cells: CoupledCells, sc: ApplyScalars, phases: str):
    """K12/K13: the coupled apply (nodal in and out, constant coefficients,
    no constraint rows) with the phases of VARIANTS[phases]; a dropped
    phase is replaced by copies of its inputs (csrc/coupled_matvec.cu,
    kPh*). A name of K13_SCHEDULES is the full apply under that schedule
    (kSched*); "pipe" copies x-runs of the lattice, so it takes the
    uniform, non-periodic probe box only. 3D Q2/Q1. Returns (out_u, out_p)."""
    if phases not in VARIANTS:
        raise ValueError(f"unknown probe variant {phases!r}: one of {sorted(VARIANTS)}")
    _probe_cells(cells, "coupled_apply_ablated")
    sched = K13_SCHEDULES.get(phases, SCHED_ONCE)
    if sched == SCHED_PIPE:
        if cells.lattice is None:
            raise ValueError("coupled_apply_ablated('pipe'): the cells carry no lattice shape")
        if any(cells.lattice[1]):
            raise NotImplementedError(
                "the pipe schedule copies x-runs of the non-periodic probe box; periodic "
                "lattices wrap their cell tables, use 'rowdma' or 'unroll2'"
            )
    _check(u, p, u_star, cells, None)
    if p is None:
        raise ValueError("coupled_apply_ablated needs a pressure vector")
    if u.device.type == "cpu":
        return coupled_apply_ablated_plain(u, p, u_star, cells, sc, phases)
    if not u.is_cuda:
        raise RuntimeError(f"coupled apply: no kernel for device {u.device}")
    ph = VARIANTS[phases]
    M = cells.probe_tables(u.device, u.dtype, sc)["M89"] if ph & PH_MDOT else None
    out_u, out_p = torch.zeros_like(u), torch.zeros_like(p)
    _launch_variant(ph, None, u, p, u_star, cells, sc, M, out_u, out_p, sched)
    launches[f"coupled_apply_ablated[{phases}]"] += 1
    return out_u, out_p


def schedule_residency(dtype, name: str, ncx: int) -> dict:
    """The cell kernel in the probe configuration under K13's schedule
    `name` (or "full", the one-shot body of K1's instance): the body it runs
    ("body", SCHEDULE_BODY), its cells per group ("cpb", a compile-time
    constant), the shared memory of one block in bytes ("smem") and the
    blocks of 128 threads one SM holds ("blocks_per_sm", the CUDA occupancy
    calculator), on a lattice of ncx cells along x. Needs the kernel library
    (a CUDA device)."""
    if name == "full":
        return {"body": SCHEDULE_BODY[name], **cell_geometry(dtype, MODE_NODAL, True, 3, 2)}
    cpb, smem, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = load_library().adaflo_coupled_residency(
        1 if dtype == torch.float64 else 0, K13_SCHEDULES[name], ncx,
        ctypes.byref(cpb), ctypes.byref(smem), ctypes.byref(blocks),
    )
    if rc != 0:
        raise RuntimeError(f"coupled apply residency query failed (CUDA error {rc})")
    return {"body": SCHEDULE_BODY[name], "cpb": cpb.value, "smem": smem.value,
            "blocks_per_sm": blocks.value}


# the production instances of the cell kernel: (entry, mode, pres) per table
# set (dim, degree) and dtype; their launch counters are the entries' names
PRODUCTION_ENTRIES = (
    ("coupled_apply", MODE_NODAL, True),
    ("coupled_apply_velocity", MODE_NODAL, False),
    ("coupled_apply_cells", MODE_CELLS, True),
    ("coupled_apply_cells_velocity", MODE_CELLS, False),
    ("coupled_apply_cells_qfields", MODE_CELLS_QFIELDS, True),
    ("coupled_apply_cells_qfields_velocity", MODE_CELLS_QFIELDS, False),
    ("coupled_apply_gather", MODE_GATHER, True),
    ("coupled_apply_gather_velocity", MODE_GATHER, False),
)
TABLE_SETS = ((3, 2), (2, 2), (3, 3), (2, 3))


def cell_geometry(dtype, mode: int, pres: bool, dim: int, degree: int) -> dict:
    """The launch geometry of a production instance of the cell kernel (an
    entry of PRODUCTION_ENTRIES at a table set): its cells per block
    ("cpb", a compile-time constant of the instance), the shared memory of
    one block in bytes ("smem") and the blocks of 128 threads one SM holds
    ("blocks_per_sm", the CUDA occupancy calculator). Needs the kernel
    library."""
    cpb, smem, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = load_library().adaflo_coupled_geometry(
        1 if dtype == torch.float64 else 0, mode, 1 if pres else 0, dim, degree,
        ctypes.byref(cpb), ctypes.byref(smem), ctypes.byref(blocks),
    )
    if rc != 0:
        raise RuntimeError(f"coupled apply geometry query failed (CUDA error {rc})")
    return {"cpb": cpb.value, "smem": smem.value, "blocks_per_sm": blocks.value}


def coupled_apply_lattice(u, p, u_star, cells: CoupledCells, sc: ApplyScalars):
    """K11: coupled_apply with constant coefficients and identity rows (+u /
    -p on the constrained dofs) whose kernel reads no cell table: each dof's
    address comes from the cell's lattice coordinates. The uniform,
    non-periodic 3D Q2/Q1 lattice only (cells.lattice). Returns (r_u, r_p)."""
    _probe_cells(cells, "coupled_apply_lattice")
    if cells.lattice is None:
        raise ValueError("coupled_apply_lattice: the cells carry no lattice shape")
    n_cells_axis, periodic = cells.lattice
    if any(periodic):
        raise NotImplementedError(
            "coupled_apply_lattice computes addresses on a non-periodic lattice; "
            "periodic lattices wrap their cell tables, use coupled_apply"
        )
    _check(u, p, u_star, cells, None)
    if p is None:
        raise ValueError("coupled_apply_lattice needs a pressure vector")
    if u.device.type == "cpu":
        return coupled_apply_plain(u, p, u_star, cells, sc)
    if not u.is_cuda:
        raise RuntimeError(f"coupled apply: no kernel for device {u.device}")
    out_u, out_p = torch.zeros_like(u), torch.zeros_like(p)
    _launch_variant(PH_ALL, tuple(n_cells_axis[:2]), u, p, u_star, cells, sc, None,
                    out_u, out_p)
    launches["coupled_apply_lattice"] += 1
    _launch_epilogue(u, p, cells, out_u, out_p, True, None, None)
    return out_u, out_p


def _lattice_of(cells: CoupledCells):
    """(cells per axis, periodic-axis bit mask) of cells.lattice, checked
    against the cell tables that the plain version reads."""
    n_cells_axis, periodic = cells.lattice
    n_u, n_p = (
        int(np.prod([d * n + (0 if w else 1) for n, w in zip(n_cells_axis, periodic)]))
        for d in (2, 1)
    )
    if int(np.prod(n_cells_axis)) != cells.n_cells or (n_u, n_p) != (cells.min_n_u, cells.min_n_p):
        raise ValueError("scatter_cells: the lattice shape does not match the cell tables")
    return tuple(int(n) for n in n_cells_axis), sum(1 << a for a, w in enumerate(periodic) if w)


def _launch_scatter(block, cells: CoupledCells, out_u, out_p):
    """One launch of K6 (adaflo_scatter_cells) on cells.lattice."""
    (ncx, ncy, ncz), periodic = _lattice_of(cells)
    rc = load_library().adaflo_scatter_cells(
        1 if block.dtype == torch.float64 else 0, _ptr(block), _ptr(out_u), _ptr(out_p),
        out_u.shape[1], ncx, ncy, ncz, periodic, _stream(block.device),
    )
    if rc != 0:
        raise RuntimeError(f"scatter_cells kernel launch failed (CUDA error {rc})")


def scatter_plan(dtype, n_cells_axis) -> dict:
    """K6's launch on a lattice of n_cells_axis cells: the tile (cells per
    axis), threads per block, shared memory per block (bytes), resident
    blocks per SM (the occupancy calculator) and grid (one block per tile)."""
    ip = ctypes.c_int
    tile, threads, smem, blocks = (ip * 3)(), ip(), ip(), ip()
    grid = ctypes.c_longlong()
    rc = load_library().adaflo_scatter_plan(
        1 if dtype == torch.float64 else 0, *(int(n) for n in n_cells_axis), tile,
        ctypes.byref(threads), ctypes.byref(smem), ctypes.byref(blocks), ctypes.byref(grid),
    )
    if rc != 0:
        raise RuntimeError(f"scatter_cells plan query failed (CUDA error {rc})")
    return {"tile": tuple(tile), "threads": threads.value, "smem": smem.value,
            "blocks_per_sm": blocks.value, "grid": grid.value}


def scatter_cells(block, cells: CoupledCells, out_u, out_p):
    """K6: add the cell-major block (E, n_cols) [u_0 .. u_2 | p] into the
    nodal out_u (dim, n_u) and out_p (n_p,) in place. 3D Q2/Q1. The kernel
    reads no cell table: it takes the lattice shape and periodic axes of
    cells.lattice (every CoupledCells of the operator carries them).
    Returns (out_u, out_p)."""
    _probe_cells(cells, "scatter_cells")
    n_cols = cells.dim * cells.ev_u.n_local + cells.ev_p.n_local
    if block.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scatter_cells: dtype {block.dtype} not supported")
    if tuple(block.shape) != (cells.n_cells, n_cols):
        raise ValueError(
            f"scatter_cells: the block must be {(cells.n_cells, n_cols)}, got {tuple(block.shape)}"
        )
    if out_u.dim() != 2 or out_u.shape[0] != cells.dim or out_u.shape[1] < cells.min_n_u:
        raise ValueError(f"scatter_cells: out_u must be (dim, n_u), got {tuple(out_u.shape)}")
    if out_p.dim() != 1 or out_p.shape[0] < cells.min_n_p:
        raise ValueError("scatter_cells: out_p must be (n_p,) covering the pressure table")
    for t in (out_u, out_p):
        if t.device != block.device or t.dtype != block.dtype:
            raise ValueError("scatter_cells: all tensors need one device and dtype")
    if not all(t.is_contiguous() for t in (block, out_u, out_p)):
        raise ValueError("scatter_cells: tensors must be contiguous")
    if block.device.type == "cpu":
        return scatter_cells_plain(block, cells, out_u, out_p)
    if not block.is_cuda:
        raise RuntimeError(f"scatter_cells: no kernel for device {block.device}")
    if cells.lattice is None:
        raise ValueError("scatter_cells: the cells carry no lattice shape")
    _launch_scatter(block, cells, out_u, out_p)
    launches["scatter_cells"] += 1
    return out_u, out_p
