"""Contraction-rate and matrix-unit probes: the CUDA kernels, their wrappers
and their plain PyTorch versions.

Counterparts of the TPU kernels of the JAX package's probe scripts, which
measure the rates that decide between dense cell matrices and sum
factorization for the cell apply (``csrc/probe_kernels.cu``):

- ``row_fma`` (K7, ``scripts/probe_sf.py`` ``run_vpu``): n_ops three-term
  row statements ``acc += 0.31 a_k + 0.47 b_k + 0.22 c_k`` on (24, block)
  row slices of a (96, block + 128) input, ``a_k`` lane-shifted when
  ``shifted``;
- ``row_copies`` (K8, ``run_copies``): the first n_rows single-row shifted
  copies of the 89-entry parity rows table (``copy_table``) from a
  (32, block + 2560) input;
- ``dense_dot`` (K9, ``run_mxu``): o = A x, A (m, k), x (k, block),
  accumulated in float32 (float64 for "f64");
- ``dense_dot_streamed`` (K5, ``scripts/probe_mxu.py`` ``pall``): O = A X
  over all columns of X (384, 96) @ (96, E), output in the input type;
- ``sf_eval`` (K10, ``run_sfeval``): the three-stage sum-factorized
  evaluation of the (32, block + 2560) parity slab into the (384, block) q
  rows (kind 96 + c 32 + q); rows 0..31 are the JAX call's output, and its
  unwritten pad rows q = 27..31 are 0 here.

The resident probes (K7-K10) take ``nblk``, the JAX grid's steps: the kernel
does the step's work nblk times over, as the TPU kernel re-runs its
resident block, and writes the same output each time; the plain versions do
the same. K8 and K10 keep a column tile's slab and output in shared memory
for a group of steps (``resident_plan``: their tile, step groups and
persistent grid on this card). Precisions of the dot: "f32" (float32 on the CUDA cores), "tf32"
(TF32 tensor cores, float32 accumulation; its plain version is the float32
product), "bf16" (inputs rounded to bf16, float32 accumulation), "f64"
(float64 on the tensor cores). A wrapper given CUDA tensors launches its
kernel or raises; given CPU tensors it runs the plain version. The library
is built with nvcc at first use into ``build/adaflo_tpu_torch/``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from adaflo_tpu_torch.ops.build import build_library

PRECISIONS = ("f32", "tf32", "bf16", "f64")
N_OPS = (24, 72, 96)  # K7 statement counts
N_ROWS = (29, 89)  # K8 row counts
DOT_SHAPES = ((96, 96), (384, 96), (96, 32), (384, 32))  # K9 (m, k)
STREAMED_SHAPE = (384, 96)  # K5 (m, k)
FMA_ROWS, FMA_IN, FMA_PAD = 24, 96, 128  # K7 output rows, input rows, halo
SLAB_ROWS, SLAB_PAD = 32, 2560  # K8/K10 input rows and halo
SF_ROWS = 384  # K10 q rows: 4 kinds x 3 components x 32
TILE = 64  # block columns must be a multiple of the kernels' tile (K7: any width)
SY, SX = 2401, 49  # flat z and y strides of the probes' anchor raster
# K10's 1D coefficients per axis (z, y, x): value (V) and derivative (D),
# the arbitrary ones of run_sfeval
SF_COEFFS = (((0.3, 0.5, 0.2),) * 3, ((-1.0, 0.0, 1.0),) * 3)

# launches of the CUDA kernels per entry (the dot per precision) and calls of
# the plain versions; plain integers that a caller may reset
launches = {"row_fma": 0, "row_copies": 0, "sf_eval": 0}
launches |= {f"dense_dot[{p}]": 0 for p in PRECISIONS}
launches |= {f"dense_dot_streamed[{p}]": 0 for p in PRECISIONS}
plain_calls = {"row_fma_plain": 0, "row_copies_plain": 0, "dense_dot_plain": 0,
               "sf_eval_plain": 0}

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "probe_kernels.cu"
_lib = None
build_info: dict = {}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def copy_table(n_rows: int = 89):
    """K8's (source row, column offset) per output row: the parity rows table
    of scripts/probe_sf.py run_copies, 3 components x 27 Q2 nodes, then 8 Q1
    nodes of row 24; its first n_rows entries."""
    table = []
    for c in range(3):
        for loc in range(27):
            z, r = divmod(loc, 9)
            y, x = divmod(r, 3)
            sub = 4 * (z % 2) + 2 * (y % 2) + (x % 2)
            table.append((c * 8 + sub, (z // 2) * SY + (y // 2) * SX + (x // 2)))
    for loc in range(8):
        z, r = divmod(loc, 4)
        y, x = divmod(r, 2)
        table.append((24, z * SY + y * SX + x))
    return table[:n_rows]


def row_fma_plain(x, n_ops: int, shifted: bool, nblk: int = 1):
    plain_calls["row_fma_plain"] += 1
    block = x.shape[1] - FMA_PAD
    for _ in range(nblk):
        acc = None
        for k in range(n_ops):
            r0 = (k * FMA_ROWS) % 64
            sh = 1 + k % 3 if shifted else 0
            a = x[r0:r0 + FMA_ROWS, sh:sh + block]
            b = x[r0 + 8:r0 + 8 + FMA_ROWS, :block]
            c = x[r0 + 16:r0 + 16 + FMA_ROWS, :block]
            v = 0.31 * a + 0.47 * b + 0.22 * c
            acc = v if acc is None else acc + v
    return acc


def row_copies_plain(x, n_rows: int, nblk: int = 1):
    plain_calls["row_copies_plain"] += 1
    block = x.shape[1] - SLAB_PAD
    out = x.new_empty((n_rows, block))
    for _ in range(nblk):
        for k, (row, off) in enumerate(copy_table(n_rows)):
            out[k] = x[row, off:off + block]
    return out


def _dot_plain(A, X, precision: str):
    """A @ X as a sum over k of rank-one updates, in float32 (float64 for
    "f64"); bf16 rounds its inputs first, whose products are then exact in
    float32; TF32's plain version is the float32 product."""
    work = torch.float64 if precision == "f64" else torch.float32
    if precision == "bf16":
        A, X = A.to(torch.bfloat16), X.to(torch.bfloat16)
    A, X = A.to(work), X.to(work)
    acc = torch.zeros((A.shape[0], X.shape[1]), dtype=work, device=X.device)
    for k in range(A.shape[1]):
        acc.addcmul_(A[:, k:k + 1], X[k:k + 1, :])
    return acc


def dense_dot_plain(A, x, precision: str = "f32", nblk: int = 1):
    plain_calls["dense_dot_plain"] += 1
    for _ in range(nblk):
        out = _dot_plain(A, x, precision)
    return out


def dense_dot_streamed_plain(A, X, precision: str = "f32"):
    plain_calls["dense_dot_plain"] += 1
    return _dot_plain(A, X, precision).to(X.dtype)


def _sf_step(x, block: int, coeffs):
    """One step of run_sfeval's kernel (_sf_eval_body), statement by
    statement at its widths, into the (384, block) q rows."""
    V, D = coeffs
    w1, w2 = block + 64, block + 8
    zbuf = x.new_zeros((144, w1))
    ybuf = x.new_zeros((648, w2))
    rbuf = x.new_zeros((SF_ROWS, block))

    def stmt(C, a, b, a2):
        return C[0] * a + C[1] * b + C[2] * a2

    for qz in range(3):
        for kind in range(2):
            C = V[0] if kind == 0 else D[0]
            dst = (qz * 2 + kind) * 24
            for c in range(3):
                zbuf[dst + c * 8:dst + c * 8 + 4] = stmt(
                    C, x[c * 8:c * 8 + 4, :w1], x[c * 8 + 4:c * 8 + 8, :w1],
                    x[c * 8:c * 8 + 4, SY:SY + w1])
    for qz in range(3):
        for qy in range(3):
            plane = (qz * 3 + qy) * 72
            for kind_in, kinds_out in ((0, (0, 1)), (1, (2,))):
                src = (qz * 2 + kind_in) * 24
                for ko in kinds_out:
                    C = D[1] if (kind_in == 0 and ko == 1) else V[1]
                    dst = plane + ko * 24
                    for c in range(3):
                        s = src + c * 8
                        ybuf[dst + c * 8:dst + c * 8 + 2] = stmt(
                            C, zbuf[s:s + 2, :w2], zbuf[s + 2:s + 4, :w2],
                            zbuf[s:s + 2, SX:SX + w2])
    for qz in range(3):
        for qy in range(3):
            plane = (qz * 3 + qy) * 72
            for qx in range(3):
                q = qz * 9 + qy * 3 + qx
                for kind_in, kinds_out in ((0, (0, 1)), (1, (2,)), (2, (3,))):
                    src = plane + kind_in * 24
                    for ko in kinds_out:
                        C = D[2] if (kind_in == 0 and ko == 1) else V[2]
                        for c in range(3):
                            s = src + c * 8
                            rbuf[ko * 96 + c * 32 + q] = stmt(
                                C, ybuf[s, :block], ybuf[s + 1, :block],
                                ybuf[s, 1:1 + block])
    return rbuf


def sf_eval_plain(x, nblk: int = 1, coeffs=SF_COEFFS):
    plain_calls["sf_eval_plain"] += 1
    block = x.shape[1] - SLAB_PAD
    for _ in range(nblk):
        out = _sf_step(x, block, coeffs)
    return out


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------
def library_path() -> Path:
    """The built probe library (built here when its source's hash is new)."""
    return build_library(_SOURCE, "probe_kernels", build_info)


def load_library():
    """Build (once, keyed by the source's hash) and load the probe library."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(library_path())))
    return _lib


def bind(lib):
    """Declare the C entries' argument and result types on a loaded library
    of csrc/probe_kernels.cu."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.adaflo_row_fma.argtypes = [i, i, i, vp, vp, i, i, vp]
    lib.adaflo_row_copies.argtypes = [i, i, vp, vp, i, i, vp]
    lib.adaflo_dense_dot.argtypes = [i, i, i, i, vp, vp, vp, ll, i, vp]
    lib.adaflo_dense_dot_plan.argtypes = [i, i, i, i, vp]
    lib.adaflo_sf_eval.argtypes = [i, vp, vp, i, i, vp, vp]
    lib.adaflo_resident_plan.argtypes = [i, i, i, i, i, vp]
    for fn in (lib.adaflo_row_fma, lib.adaflo_row_copies, lib.adaflo_dense_dot,
               lib.adaflo_dense_dot_plan, lib.adaflo_sf_eval, lib.adaflo_resident_plan):
        fn.restype = i
    return lib


def _stream(device) -> int:
    """The current CUDA stream of `device`, as the handle the C entries take."""
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed (CUDA error {rc})")


def _dtype_code(t) -> int:
    return 1 if t.dtype == torch.float64 else 0


def _launch_row_fma(x, out, n_ops, shifted, nblk):
    block = out.shape[1]
    _raise_on(load_library().adaflo_row_fma(
        _dtype_code(x), n_ops, int(shifted), x.data_ptr(), out.data_ptr(), block, nblk,
        _stream(x.device)), "row_fma")


def _launch_row_copies(x, out, nblk):
    _raise_on(load_library().adaflo_row_copies(
        _dtype_code(x), out.shape[0], x.data_ptr(), out.data_ptr(), out.shape[1], nblk,
        _stream(x.device)), "row_copies")


def _launch_dense_dot(A, X, out, precision, nblk, streamed):
    _raise_on(load_library().adaflo_dense_dot(
        PRECISIONS.index(precision), A.shape[0], A.shape[1], int(streamed), A.data_ptr(),
        X.data_ptr(), out.data_ptr(), X.shape[1], nblk, _stream(X.device)),
        f"dense_dot[{precision}]")


DOT_PLAN_KEYS = ("smem", "blocks_per_sm", "threads", "tile_cols", "parts", "stages")


def dot_plan(precision: str, m: int, k: int, streamed: bool) -> dict:
    """The dot instance's launch plan (DOT_PLAN_KEYS): shared memory per
    block, resident blocks per SM (the occupancy calculator), threads per
    block, columns of a work item, parts of A's rows over the blocks, ring
    stages."""
    out = np.zeros(len(DOT_PLAN_KEYS), np.int32)
    _raise_on(load_library().adaflo_dense_dot_plan(
        PRECISIONS.index(precision), m, k, int(streamed), out.ctypes.data),
        f"dense_dot[{precision}] plan")
    return dict(zip(DOT_PLAN_KEYS, (int(v) for v in out)))


RESIDENT_PLAN_KEYS = ("tile_cols", "threads", "smem", "blocks_per_sm", "slots", "groups", "items",
                      "grid")
RESIDENT = ("row_copies", "sf_eval")  # the kernels whose tiles stay on the SM for a step group


def resident_plan(name: str, dtype, block: int, nblk: int, n_rows: int = 89) -> dict:
    """The launch plan of K8 ("row_copies", n_rows) or K10 ("sf_eval") at
    (dtype, block, nblk) (RESIDENT_PLAN_KEYS): columns of a tile, threads
    per block, shared memory per block, resident blocks per SM (the
    occupancy calculator), slots (blocks per SM x SMs), step groups, work
    items (tiles x groups) and the persistent grid."""
    out = np.zeros(len(RESIDENT_PLAN_KEYS), np.int32)
    code = 1 if dtype == torch.float64 else 0
    _raise_on(load_library().adaflo_resident_plan(
        RESIDENT.index(name), code, n_rows, block, nblk, out.ctypes.data), f"{name} plan")
    return dict(zip(RESIDENT_PLAN_KEYS, (int(v) for v in out)))


def _launch_sf_eval(x, out, nblk, coeffs):
    co = np.asarray(coeffs, np.float64).reshape(-1)
    _raise_on(load_library().adaflo_sf_eval(
        _dtype_code(x), x.data_ptr(), out.data_ptr(), out.shape[1], nblk, co.ctypes.data,
        _stream(x.device)), "sf_eval")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check(name, tensors, dtypes):
    for t in tensors:
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype} not supported here ({dtypes})")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous 2D tensors")
        if t.device != tensors[0].device or t.dtype != tensors[0].dtype:
            raise ValueError(f"{name}: all inputs need one device and dtype")
    if tensors[0].device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {tensors[0].device}")


def _block(name, x, rows: int, pad: int, nblk: int, multiple: int = TILE) -> int:
    block = x.shape[1] - pad
    if x.shape[0] != rows or block <= 0 or block % multiple:
        raise ValueError(
            f"{name}: input must be ({rows}, block + {pad}) with block a positive "
            f"multiple of {multiple}, got {tuple(x.shape)}")
    if nblk < 1:
        raise ValueError(f"{name}: nblk must be at least 1")
    return block


_REAL = (torch.float32, torch.float64)


def row_fma(x, n_ops: int = 72, shifted: bool = False, nblk: int = 1):
    """K7: the (24, block) sum of n_ops row statements of x (96, block + 128),
    block any positive width (the kernel skips its last tile's columns past
    the block)."""
    _check("row_fma", [x], _REAL)
    block = _block("row_fma", x, FMA_IN, FMA_PAD, nblk, multiple=1)
    if n_ops not in N_OPS:
        raise ValueError(f"row_fma: n_ops must be one of {N_OPS}")
    if x.device.type == "cpu":
        return row_fma_plain(x, n_ops, shifted, nblk)
    out = torch.empty((FMA_ROWS, block), dtype=x.dtype, device=x.device)
    _launch_row_fma(x, out, n_ops, shifted, nblk)
    launches["row_fma"] += 1
    return out


def row_copies(x, n_rows: int = 89, nblk: int = 1):
    """K8: the (n_rows, block) rows copied from x (32, block + 2560) through
    copy_table."""
    _check("row_copies", [x], _REAL)
    block = _block("row_copies", x, SLAB_ROWS, SLAB_PAD, nblk)
    if n_rows not in N_ROWS:
        raise ValueError(f"row_copies: n_rows must be one of {N_ROWS}")
    if x.device.type == "cpu":
        return row_copies_plain(x, n_rows, nblk)
    out = torch.empty((n_rows, block), dtype=x.dtype, device=x.device)
    _launch_row_copies(x, out, nblk)
    launches["row_copies"] += 1
    return out


def _dot_checks(name, A, X, precision, shapes):
    if precision not in PRECISIONS:
        raise ValueError(f"{name}: precision must be one of {PRECISIONS}")
    if A.dim() != 2 or X.dim() != 2 or (A.shape[0], A.shape[1]) not in shapes:
        raise ValueError(f"{name}: A must be (m, k) with (m, k) in {shapes}")
    if X.shape[0] != A.shape[1] or X.shape[1] <= 0 or X.shape[1] % TILE:
        raise ValueError(
            f"{name}: X must be (k, n) with n a positive multiple of {TILE}, "
            f"got {tuple(X.shape)}")


def dense_dot(A, x, precision: str = "f32", nblk: int = 1):
    """K9: A (m, k) @ x (k, block), float32 inputs and output ("f64": float64),
    nblk grid steps over the same x."""
    _dot_checks("dense_dot", A, x, precision, DOT_SHAPES)
    _check("dense_dot", [A, x], (torch.float64,) if precision == "f64" else (torch.float32,))
    if nblk < 1:
        raise ValueError("dense_dot: nblk must be at least 1")
    if x.device.type == "cpu":
        return dense_dot_plain(A, x, precision, nblk)
    out = torch.empty((A.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    _launch_dense_dot(A, x, out, precision, nblk, False)
    launches[f"dense_dot[{precision}]"] += 1
    return out


_STREAMED_TYPES = {"f32": torch.float32, "tf32": torch.float32, "bf16": torch.bfloat16,
                   "f64": torch.float64}


def dense_dot_streamed(A, X, precision: str = "f32"):
    """K5: A (384, 96) @ X (96, E), output in the inputs' type: float32 for
    "f32" and "tf32", bfloat16 for "bf16", float64 for "f64"."""
    _dot_checks("dense_dot_streamed", A, X, precision, (STREAMED_SHAPE,))
    _check("dense_dot_streamed", [A, X], (_STREAMED_TYPES[precision],))
    if X.device.type == "cpu":
        return dense_dot_streamed_plain(A, X, precision)
    out = torch.empty((A.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    _launch_dense_dot(A, X, out, precision, 1, True)
    launches[f"dense_dot_streamed[{precision}]"] += 1
    return out


def sf_eval(x, nblk: int = 1, coeffs=SF_COEFFS):
    """K10: the (384, block) q rows of the sum-factorized evaluation of the
    parity slab x (32, block + 2560); rows [0:32] are the JAX call's output.
    coeffs: (V, D), each three axes (z, y, x) of three terms."""
    _check("sf_eval", [x], _REAL)
    block = _block("sf_eval", x, SLAB_ROWS, SLAB_PAD, nblk)
    if np.shape(coeffs) != (2, 3, 3):
        raise ValueError("sf_eval: coeffs must be (V, D), each 3 axes x 3 terms")
    if x.device.type == "cpu":
        return sf_eval_plain(x, nblk, coeffs)
    out = torch.empty((SF_ROWS, block), dtype=x.dtype, device=x.device)
    _launch_sf_eval(x, out, nblk, coeffs)
    launches["sf_eval"] += 1
    return out
