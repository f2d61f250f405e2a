"""Build of the port's CUDA sources into shared libraries with a plain C
interface (loaded with ctypes by the modules that wrap them).

Each library is built with nvcc for sm_90a at first use, into
``build/adaflo_tpu_torch/`` under the repository root, as
``lib<name>_<hash>.so``, the hash that of the source, so that an edited
source is built anew and an unchanged one is built once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "adaflo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build_library(source: Path, name: str, info: dict) -> Path:
    """The path of the library built from `source`, building it when no
    library of this source's hash exists; a build records its seconds and
    nvcc's output (ptxas' registers and spills) in `info`."""
    tag = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source.name}:\n" + info["log"])
        os.replace(tmp, so)
    return so
