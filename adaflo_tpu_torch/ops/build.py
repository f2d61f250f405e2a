"""Build of the port's CUDA sources into shared libraries with a plain C
interface (loaded with ctypes by the modules that wrap them).

Each library is built with nvcc for sm_90a at first use, into
``build/adaflo_tpu_torch/`` under the repository root, as
``lib<name>_<hash>.so``, the hash that of the source and of every file it
includes from ``csrc/`` (``#include "..."``, followed through the headers),
so that an edited source or header is built anew and an unchanged one is
built once. The libraries link the CUDA runtime only: the driver functions
they need (cuTensorMapEncodeTiled) come through the runtime's entry-point
query.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "adaflo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_files(source: Path) -> list:
    """`source` and the files it includes with ``#include "..."`` from its
    own directory, their includes followed in turn, each once."""
    files, todo = [], [Path(source)]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        todo += [f.parent / n for n in _INCLUDE.findall(f.read_text())
                 if (f.parent / n).is_file()]
    return files


def source_tag(source: Path) -> str:
    """The hash that names a library: of `source` and its included files
    (source_files), each by name and content."""
    h = hashlib.sha1()
    for f in source_files(source):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()[:12]


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
    library of this source's hash (source_tag) exists; a build records its
    seconds and nvcc's output (ptxas' registers and spills) in `info`."""
    tag = source_tag(source)
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
