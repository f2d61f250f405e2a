"""The port's CUDA sources compiled for the CPU, for the emulated tests
(test_torch_*_emulated.py).

There is no nvcc on a CPU host, but a kernel's arithmetic and indexing can
still be held against its plain version: a source is compiled with g++
against a small header that defines the CUDA keywords, gives each block one
thread (every kernel is a strided loop over its work items, so one thread
does all of them), turns `__syncthreads` into a no-op and each `<<<...>>>`
launch into a loop over the blocks. The header defines ADAFLO_EMULATED, under
which a source leaves out what g++ cannot run (inline PTX) and makes its
asynchronous copies (cp.async, bulk copies) plain copies and their barriers
no-ops. The occupancy and SM-count queries report one block on each of
EMU_SMS SMs, so that a persistent grid is smaller than the work and each
block loops. What this cannot show: that nvcc accepts the source, and what
many threads do; chip_smoke.py checks both on the card.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "adaflo_tpu_torch" / "csrc"
EMU_SMS = 2  # SMs of the emulated card, one resident block each

HEADER = r"""
#pragma once
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#define ADAFLO_EMULATED 1
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __grid_constant__
struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
static emu_dim3 threadIdx, blockIdx, blockDim, gridDim;
inline void __syncthreads() {}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
constexpr int EMU_SMS = %d;
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = EMU_SMS; return 0; }
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
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


def translate(src: str) -> str:
    """A CUDA source rewritten for g++ against HEADER."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = re.sub(
        r"extern __shared__ (__align__\(\d+\) )?unsigned char smem_raw\[\];",
        "unsigned char* smem_raw = emu_smem;", src,
    )
    src = src.replace("__shared__ T part[256];", "static T part[256];")

    def launch(m):
        cfg = [c.strip() for c in m.group(2).split(",")]
        smem = cfg[2] if len(cfg) > 2 else "0"
        return f"emu_launch({cfg[0]}, {smem}, [&]() {{ {m.group(1)}({m.group(3)}); }});"

    src = re.sub(r"([\w:<>]+)<<<(.*?)>>>\((.*?)\);", launch, src, flags=re.S)
    assert "<<<" not in src and "__shared__" not in src
    return src


def build_emulated(source_name: str, workdir: Path) -> ctypes.CDLL:
    """csrc/<source_name> compiled with g++ into a library in `workdir`,
    loaded; skips the test where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to compile the emulated kernel source")
    (workdir / "cuda_emu.h").write_text(HEADER % EMU_SMS)
    (workdir / "emu.cpp").write_text(translate((CSRC / source_name).read_text()))
    so = workdir / "libemu.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-I", str(CSRC), "-o", str(so),
         str(workdir / "emu.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return ctypes.CDLL(str(so))
