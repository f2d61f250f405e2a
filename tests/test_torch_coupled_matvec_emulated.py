"""The CUDA source of the coupled cell apply, run on the CPU.

There is no nvcc on a CPU host, but the kernel's arithmetic and indexing can
still be held against the plain version: `csrc/coupled_matvec.cu` is
compiled with g++ against a small header that defines the CUDA keywords,
gives each block one thread (every stage of the kernel is a strided loop
over its work items, so one thread does all of them), turns `__syncthreads`
into a no-op and each `<<<...>>>` launch into a loop over the blocks. The
library is driven through the port's own ctypes argument packing
(`ops/coupled_matvec._launch_cells` / `_launch_epilogue`) on CPU tensors and
compared with `coupled_apply_plain` in every mode, float64 (1e-12 relative)
and float32 (1e-5). What this cannot show: that nvcc accepts the source,
and what many threads do; `chip_smoke.py` checks both on the card. Skips
where g++ is missing."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from adaflo_tpu_torch.fe.space import ScalarSpace
from adaflo_tpu_torch.mesh.structured import StructuredMesh
from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops.lattice import LatticeOps
from adaflo_tpu_torch.ops.tensor import CellEvaluator

torch.set_num_threads(2)

SOURCE = Path(cm.__file__).resolve().parents[1] / "csrc" / "coupled_matvec.cu"

HEADER = r"""
#pragma once
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
static emu_dim3 threadIdx, blockIdx, blockDim, gridDim;
inline void __syncthreads() {}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }
template <class T> T atomicAdd(T* p, T v) { T o = *p; *p += v; return o; }
alignas(16) static unsigned char emu_smem[1 << 22];
inline void emu_launch(unsigned grid, size_t smem, const std::function<void()>& f) {
  if (smem > sizeof(emu_smem)) throw 1;
  blockDim.x = 1; gridDim.x = grid; threadIdx.x = 0;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::memset(emu_smem, 0xff, smem);  // garbage, as on the card
    f();
  }
}
"""


def _translate(src: str) -> str:
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace(
        "extern __shared__ unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu_smem;",
    )
    src = src.replace("__shared__ T part[256];", "static T part[256];")

    def launch(m):
        cfg = [c.strip() for c in m.group(2).split(",")]
        smem = cfg[2] if len(cfg) > 2 else "0"
        return f"emu_launch({cfg[0]}, {smem}, [&]() {{ {m.group(1)}({m.group(3)}); }});"

    src = re.sub(r"([\w:<>]+)<<<(.*?)>>>\((.*?)\);", launch, src, flags=re.S)
    assert "<<<" not in src and "__shared__" not in src
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory, monkeypatch_module):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to compile the emulated kernel source")
    d = tmp_path_factory.mktemp("coupled_matvec_emu")
    (d / "cuda_emu.h").write_text(HEADER)
    (d / "emu.cpp").write_text(_translate(SOURCE.read_text()))
    so = d / "libemu.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-o", str(so), str(d / "emu.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(so))
    vp, i, ll, dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.adaflo_coupled_cells.argtypes = [i, i, i] + [vp] * 12 + [ll, ll, vp, vp, vp]
    lib.adaflo_coupled_cells.restype = i
    lib.adaflo_coupled_epilogue.argtypes = [i] + [vp] * 6 + [ll, ll, i, dbl, vp, vp]
    lib.adaflo_coupled_epilogue.restype = i
    # the wrapper's launch helpers, pointed at the emulated library and a
    # null stream, for this module only
    monkeypatch_module.setattr(cm, "load_library", lambda: lib)
    monkeypatch_module.setattr(cm, "_stream", lambda device: 0)
    return lib


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def _case(dim, degree, dtype, constrained):
    rng = np.random.default_rng(dim * 10 + degree)
    if dim == 3:
        mesh = StructuredMesh((3, 4, 2), (0.0, 0.0, 0.0), (1.0, 1.3, 0.7))
    else:
        mesh = StructuredMesh((4, 3), (0.0, 0.0), (1.0, 1.3))
    us, ps = ScalarSpace(mesh, degree), ScalarSpace(mesh, degree - 1)
    ev_u = CellEvaluator(dim, us.basis, degree + 1, mesh.h)
    ev_p = CellEvaluator(dim, ps.basis, degree + 1, mesh.h)
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
        cm._launch_cells(u, None, s, cells, sc, None, out_u, None)
        cm._launch_epilogue(u, None, cells, out_u, None, True, None, None)
        got = [out_u]
    else:
        kw = dict(identity=mode != "const", scale=0.37 if mode != "const" else None)
        ref = list(cm.coupled_apply_plain(u, p, s, cells, sc, coeffs=co, want_norm=True, **kw))
        out_u, out_p = torch.zeros_like(u), torch.zeros_like(p)
        norm = torch.zeros((), dtype=dtype)
        cm._launch_cells(u, p, s, cells, sc, co, out_u, out_p)
        cm._launch_epilogue(u, p, cells, out_u, out_p, kw["identity"], kw["scale"], norm)
        got = [out_u, out_p, norm]
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    scale = max(float(b.abs().max()) for b in ref)
    assert err <= (1e-12 if dtype == torch.float64 else 1e-5) * scale
