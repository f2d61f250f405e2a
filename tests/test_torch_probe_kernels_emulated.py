"""The CUDA source of the contraction-rate probes, run on the CPU.

`csrc/probe_kernels.cu` is compiled with g++ against the emulation header of
`tests/torch_emulation.py` (one thread per block) and driven through the
port's own ctypes packing (`ops/probe_kernels._launch_*`) on CPU tensors at
block 128 and 2 grid steps, against the plain versions: K7 (`row_fma`, every
n_ops, aligned and shifted), K8 (`row_copies`, exact), the float32 entries of
K9 and K5 (`dense_dot`, the SIMT product, resident at every (m, k) and
streamed) and K10 (`sf_eval`, every q row and the zeroed pad rows); float64
1e-12 and float32 1e-5, max-abs error over max-abs. The tensor-core entries
(TF32, bf16, float64 DMMA) are inline PTX, which the emulation leaves out:
their emulated calls raise, and they meet their plain versions only on the
card, in chip_smoke.py phase 2. Skips where g++ is missing."""

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
@pytest.mark.parametrize("n_rows", pk.N_ROWS)
def test_emulated_row_copies_equal_plain_version(emulated, n_rows, dtype):
    x = _randn(8, 32, BLOCK + 2560, dtype=dtype)
    out = torch.full((n_rows, BLOCK), float("nan"), dtype=dtype)
    pk._launch_row_copies(x, out, NBLK)
    assert torch.equal(out, pk.row_copies_plain(x, n_rows, NBLK))


@pytest.mark.parametrize("m,k", pk.DOT_SHAPES)
def test_emulated_dense_dot_f32_matches_plain_version(emulated, m, k):
    A, x = _randn(9, m, k, dtype=torch.float32), _randn(10, k, BLOCK, dtype=torch.float32)
    out = torch.full((m, BLOCK), float("nan"))
    pk._launch_dense_dot(A, x, out, "f32", NBLK, False)
    assert _rel(out, pk.dense_dot_plain(A, x, "f32", NBLK)) <= 1e-5


def test_emulated_streamed_dot_f32_matches_plain_version(emulated):
    A, X = _randn(11, 384, 96, dtype=torch.float32), _randn(12, 96, 256, dtype=torch.float32)
    out = torch.full((384, 256), float("nan"))
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


@DTYPES
def test_emulated_sf_eval_matches_plain_version(emulated, dtype):
    """Every q row of the three stages, and the pad rows q = 27..31 zero."""
    x = _randn(15, 32, BLOCK + 2560, dtype=dtype)
    coeffs = ((0.3, 0.5, 0.2), (0.25, 0.6, 0.15), (0.1, 0.7, 0.2)), ((-1.0, 0.0, 1.0),
                                                                   (-0.5, 0.1, 0.4),
                                                                   (-0.8, -0.2, 1.0))
    out = torch.full((384, BLOCK), float("nan"), dtype=dtype)
    pk._launch_sf_eval(x, out, NBLK, coeffs)
    ref = pk.sf_eval_plain(x, NBLK, coeffs)
    assert _rel(out, ref) <= TOL[dtype]
    pad = out.reshape(12, 32, BLOCK)[:, 27:]
    assert torch.equal(pad, torch.zeros_like(pad))
