"""Coupled Navier-Stokes cell apply: the CUDA kernel, its wrapper and its
plain PyTorch version.

Counterpart of ``adaflo_tpu/ops/pallas_matvec.py``. The TPU package has two
Pallas entries on this path: ``coupled_vmult_pr2`` (K1, the resident apply
inside the Krylov solve, with constraint-identity rows, output scale, a fused
sum(out^2) and variable coefficients) and ``coupled_vmult_pr`` (K2, the same
cell math with constant coefficients, used by ``vmult`` and
``velocity_vmult``). Here both are one CUDA kernel
(``csrc/coupled_matvec.cu``) with two entries:

- ``coupled_apply`` (K1): (u, p) -> (r_u, r_p) with the extras;
- ``coupled_apply_velocity`` (K2): u -> r_u, no pressure input and no
  pressure rows, constrained rows +u (identity).

Vectors stay nodal: u (dim, n_u), p (n_p,), and the frozen Newton
linearization point u* (dim, n_u). A wrapper given CUDA tensors launches the
kernel or raises; given CPU tensors it runs ``coupled_apply_plain``, the same
function in plain PyTorch written in the dense-table form of the TPU
package's ``build_tables`` (out = M89 x + A_ic n (+ A_ig st)), independent of
the kernel's sum factorization. The kernel library is built with nvcc at
first use into ``build/adaflo_tpu_torch/`` under the repository root.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

# launches of the CUDA kernel per entry, and calls of the plain version; plain
# integers that a caller may reset (chip_smoke.py reads them around a run)
launches = {"coupled_apply": 0, "coupled_apply_velocity": 0}
plain_calls = {"coupled_apply_plain": 0}

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "coupled_matvec.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "adaflo_tpu_torch"
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

    def __init__(self, ev_u, ev_p, cell_u, cell_p, mask_u, mask_p, device):
        self.dim = ev_u.dim
        self.degree = ev_u.n_1d - 1
        if (self.dim, self.degree) not in ((3, 2), (2, 2), (3, 3)):
            raise NotImplementedError(
                f"coupled apply: no kernel for dim={self.dim}, "
                f"degree={self.degree} (table sets: 3D Q2/Q1, 2D Q2/Q1, 3D Q3/Q2)"
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
# plain version
# ---------------------------------------------------------------------------
def coupled_apply_plain(
    u, p, u_star, cells: CoupledCells, sc: ApplyScalars, *,
    coeffs=None, identity: bool = True, scale: Optional[float] = None,
    want_norm: bool = False, velocity_only: bool = False,
):
    """The coupled apply in plain PyTorch (dense cell matrices, index
    gather and index_add_ scatter). Same arguments and results as
    coupled_apply (velocity_only=True: as coupled_apply_velocity)."""
    plain_calls["coupled_apply_plain"] += 1
    dim, E, n_q = cells.dim, cells.n_cells, cells.n_q
    tabs, _, T = cells.dense(u.device, u.dtype)
    nl, npl = tabs.n_u_loc, tabs.n_p_loc
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
    x = torch.cat(cols, dim=1)  # (E, n_cols)
    s = torch.cat([u_star[c][cu] for c in range(dim)], dim=1)
    r = x @ T["A_evg"].T
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
        M89 = torch.as_tensor(M89, dtype=u.dtype, device=u.device)
        A_ics = torch.as_tensor(A_ics, dtype=u.dtype, device=u.device)
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


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the coupled apply kernel cannot be built")


def load_library():
    """Build (once, keyed by the source's hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SOURCE.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / f"libcoupled_matvec_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(_SOURCE),
        ]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info["seconds"] = time.perf_counter() - t0
        build_info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed to build coupled_matvec.cu:\n" + build_info["log"]
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.adaflo_coupled_cells.argtypes = [i, i, i] + [vp] * 12 + [ll, ll, vp, vp, vp]
    lib.adaflo_coupled_cells.restype = i
    lib.adaflo_coupled_epilogue.argtypes = [i] + [vp] * 6 + [ll, ll, i, d, vp, vp]
    lib.adaflo_coupled_epilogue.restype = i
    _lib = lib
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


def _launch_cells(u, p, u_star, cells, sc, coeffs, out_u, out_p):
    lib = load_library()
    coeffs = coeffs if coeffs is not None else (None, None, None)
    scal = np.asarray(
        [sc.beta, sc.weight, sc.tau1, sc.rho, sc.mu, sc.damping, sc.tau_grad_div],
        np.float64,
    )
    stream = _stream(u.device)
    rc = lib.adaflo_coupled_cells(
        1 if u.dtype == torch.float64 else 0, cells.dim, cells.degree,
        _ptr(u), _ptr(p), _ptr(u_star), _ptr(cells.cell_u), _ptr(cells.cell_p),
        _ptr(cells._mask_u8), _ptr(cells._mask_p8 if p is not None else None),
        _ptr(coeffs[0]), _ptr(coeffs[1]), _ptr(coeffs[2]),
        _ptr(out_u), _ptr(out_p), u.shape[1], cells.n_cells,
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
    _launch_cells(u, p, u_star, cells, sc, coeffs, out_u, out_p)
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
    _launch_cells(u, None, u_star, cells, sc, coeffs, out_u, None)
    launches["coupled_apply_velocity"] += 1
    if cells.mask_u is not None:
        _launch_epilogue(u, None, cells, out_u, None, True, None, None)
    return out_u

