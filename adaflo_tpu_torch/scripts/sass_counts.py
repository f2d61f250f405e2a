"""Instruction counts of the probe kernels in the built library's SASS.

The probes time statements that repeat themselves, which a compiler may
merge or delete; the counts show that the work survived: the FMA and
tensor-core instructions of each instance must grow with its statement
count (K7 n_ops), row count (K8 n_rows) and rows of A (K9/K5 M) as the work
does. Runs ``cuobjdump -sass`` (CUDA toolkit) on the library of
``csrc/probe_kernels.cu``, building it first if needed, and prints, per
kernel instance, the counts of FFMA, FMUL, FADD, DFMA, DMUL, DADD, HMMA,
DMMA, LDS, LDG and STG.

Run: python -m adaflo_tpu_torch.scripts.sass_counts
"""

from __future__ import annotations

import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

from adaflo_tpu_torch.ops import probe_kernels as pk

OPS = ("FFMA", "FMUL", "FADD", "DFMA", "DMUL", "DADD", "HMMA", "DMMA", "LDS", "LDG", "STG")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def _tool(name: str) -> str:
    found = shutil.which(name) or str(Path("/usr/local/cuda/bin") / name)
    if not Path(found).exists():
        raise RuntimeError(f"{name} not found (CUDA toolkit)")
    return found


def _demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def counts(library: Path) -> dict:
    """{kernel instance (demangled): {opcode: count}} of `library`."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    per, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            per[name] = Counter()
        elif name is not None:
            m = _INSN.search(line)
            if m:
                per[name][m.group(1).split(".")[0]] += 1
    names = list(per)
    return {d: {op: per[n][op] for op in OPS} for n, d in zip(names, _demangle(names))}


def main() -> None:
    res = counts(pk.library_path())
    for name in sorted(res):
        c = res[name]
        print(f"{name}: " + ", ".join(f"{op} {c[op]}" for op in OPS if c[op]), flush=True)


if __name__ == "__main__":
    main()
