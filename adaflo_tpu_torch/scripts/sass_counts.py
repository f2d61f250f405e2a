"""Instruction counts of the probe kernels in the built libraries' SASS.

The probes time statements that repeat themselves, which a compiler may
merge or delete; the counts show that the work survived: the FMA and
tensor-core instructions of each instance must grow with its statement
count (K7 n_ops), row count (K8 n_rows) and rows of A (K9/K5 M) as the work
does. K7's register-fed statements are checked (check_fma): at each type
and shift its FP instructions (FFMA + FMUL + FADD, or DFMA + DMUL + DADD)
grow by 4 x 3 per statement and work item of the code (a multiply, two
FMAs and an add for each of an item's three output rows), and its LDS do
not grow with n_ops (no operand comes from shared memory). K8's step must
be one LDS and one STS per copied row of a work item, with no global store
growing with the rows (check_copies), and K10's work item must compute
every statement, 3 FP instructions each, from the 27 operands it loads
from shared memory once (check_sfeval). K13's schedules
of the cell kernel must copy asynchronously: rowdma
and unroll2 through cp.async (LDGSTS), pipe through bulk copies (UBLKCP)
completing on an mbarrier (SYNCS); if nvcc turned a schedule's copies into
plain loads, the counts show it. The dense dot's instances (K5, K9) must
hold their design: TMA tile loads (UTMALDG) and mbarriers (SYNCS) in every
precision, wgmma (HGMMA) in bf16 and TF32, DMMA in float64. Runs
``cuobjdump -sass`` (CUDA toolkit) on the libraries of
``csrc/probe_kernels.cu`` and ``csrc/coupled_matvec.cu``, building them
first if needed, and prints, per probe kernel instance and per schedule
instance of the cell kernel (beside the production one-shot instance,
"full"), the counts of FFMA, FMUL, FADD, DFMA, DMUL, DADD, HMMA, HGMMA,
DMMA, LDS, STS, LDG, STG, LDGSTS, UBLKCP, UTMALDG, UTMASTG, SYNCS and LOP3
(K7's salted coefficients), and the
same of every production instance of the cell kernel (each entry at each
table set, float64 and float32; their LDS against DFMA or FFMA show how many
of the one-shot body's operands come from shared memory); it fails if a
schedule lacks its asynchronous copies, a dot instance its instructions, K7
or K10 its statements, or K8 its one LDS and STS a row.

Run: python -m adaflo_tpu_torch.scripts.sass_counts
"""

from __future__ import annotations

import functools
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.ops import probe_kernels as pk

OPS = ("FFMA", "FMUL", "FADD", "DFMA", "DMUL", "DADD", "HMMA", "HGMMA", "DMMA", "LDS", "STS",
       "LDG", "STG", "LDGSTS", "UBLKCP", "UTMALDG", "UTMASTG", "SYNCS", "LOP3")
# the asynchronous copies each schedule must show
SCHEDULE_OPS = {"rowdma": ("LDGSTS",), "pipe": ("UBLKCP", "SYNCS"), "unroll2": ("LDGSTS",)}
# the mangled cell kernel <3, 3, 3, 2, true, kSrcTable, kStreamDofs,
# kOutScatter, T, kPhAll, SCHED>: the probe configuration with every phase
_CELL_KERNEL = re.compile(r"coupled_cell_kernelILi3ELi3ELi3ELi2ELb1ELi0ELi0ELi0E([df])Li63ELi(\d)EE")
# the mangled cell kernel's production instances <DIM, N1, Q1, P1, PRES, SRC,
# STREAM, DST, T, kPhAll, kSchedOnce>
_PRODUCTION = re.compile(r"coupled_cell_kernelILi(\d)ELi(\d)ELi(\d)ELi(\d)ELb([01])ELi(\d)ELi(\d)"
                         r"ELi(\d)E([df])Li63ELi0EE")
# (SRC, STREAM, DST) of each entry mode (csrc/coupled_matvec.cu with_mode)
_MODE_OF = {(0, 0, 0): cm.MODE_NODAL, (1, 0, 1): cm.MODE_CELLS, (1, 1, 1): cm.MODE_CELLS_QFIELDS,
            (0, 0, 1): cm.MODE_GATHER}
# the mangled dot kernel <PREC, M, K, TX, TO>: "<precision> (M, K) <X type>"
_DOT_KERNEL = re.compile(r"dense_dot_kernelILi(\d)ELi(\d+)ELi(\d+)E(f|d|13__nv_bfloat16)")
_DOT_TYPES = {"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}
# the instructions each dot instance must hold, by precision
DOT_OPS = {"f32": ("UTMALDG", "SYNCS", "FFMA"), "tf32": ("UTMALDG", "SYNCS", "HGMMA"),
           "bf16": ("UTMALDG", "SYNCS", "HGMMA"), "f64": ("UTMALDG", "SYNCS", "DMMA")}
# the mangled K7 instance <T, N_OPS, SHIFTED>: "<float|double> n_ops=<n> <aligned|shifted>"
_FMA_KERNEL = re.compile(r"row_fma_kernelI([fd])Li(\d+)ELb([01])E")
# K7's FP instructions per type, and their growth per statement and work item
FMA_FP = {"float": ("FFMA", "FMUL", "FADD"), "double": ("DFMA", "DMUL", "DADD")}
FMA_PER_STATEMENT = 4 * 3
# the mangled K8 instance <T, N_ROWS>: "<float|double> n_rows=<n>"
_COPIES_KERNEL = re.compile(r"row_copies_kernelI([fd])Li(\d+)E")
# the mangled K10 instance <T>: "<float|double>"
_SFEVAL_KERNEL = re.compile(r"sf_eval_kernelI([fd])E")
# a K10 work item (column, c, qz) and step: 81 statements' elements (stage z
# 2 kinds x 9 places, y 3 qy x 3 kinds x 3 places, x 3 qy x 3 qx x 4 kinds),
# 3 FP instructions each (a multiply, two FMAs), from 27 operands
SF_ITEM_STATEMENTS, SF_ITEM_LOADS, SF_ITEM_ROWS = 81, 27, 36
SF_PER_STATEMENT = 3
SF_OTHER_LDS = 1  # LDS outside the items: the output tile's loads for its store
# an instruction and its opcode; one under the never-true predicate @!PT (the
# placeholders that nvcc puts before each LDGSTS: @!PT LDS RZ, [RZ]) never
# runs and is not counted
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?!@!PT\s)(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


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


@functools.lru_cache(maxsize=None)
def _dump(library: Path) -> str:
    """cuobjdump -sass of `library`, once per process: a built library's file
    name carries the hash of its sources, so its SASS does not change."""
    return subprocess.run([_tool("cuobjdump"), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout


def _sass(library: Path) -> dict:
    """{kernel instance (mangled): {opcode: count}} of `library`."""
    per, name = {}, None
    for line in _dump(Path(library)).splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            per[name] = Counter()
        elif name is not None:
            m = _INSN.search(line)
            if m:
                per[name][m.group(1).split(".")[0]] += 1
    return {n: {op: c[op] for op in OPS} for n, c in per.items()}


def counts(library: Path) -> dict:
    """{kernel instance (demangled): {opcode: count}} of `library`."""
    per = _sass(library)
    names = list(per)
    return {d: per[n] for n, d in zip(names, _demangle(names))}


def _schedule_key(mangled: str):
    """"<schedule> <double|float>" of a mangled instance of _CELL_KERNEL
    ("full" for the one-shot schedule), or None for another kernel."""
    m = _CELL_KERNEL.search(mangled)
    if m is None:
        return None
    names = {v: k for k, v in cm.K13_SCHEDULES.items()} | {cm.SCHED_ONCE: "full"}
    return f"{names[int(m.group(2))]} {'double' if m.group(1) == 'd' else 'float'}"


def schedule_counts(library: Path) -> dict:
    """{"<schedule> <dtype>": {opcode: count}} of the cell kernel's K13
    schedule instances in `library` (coupled_matvec's), and of the
    production one-shot full apply ("full <dtype>") beside them."""
    return {_schedule_key(n): c for n, c in _sass(library).items() if _schedule_key(n)}


def _ptxas(log: str, key_of) -> dict:
    """{key: {"registers", "stack", "spill_stores", "spill_loads"}} of the
    kernels of an nvcc -Xptxas -v build log that key_of (a mangled name ->
    key or None) names; "stack" is the stack frame in bytes (local arrays
    that did not stay in registers, and spills)."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            key = key_of(line)
            if key is not None:
                out.setdefault(key, {"registers": None, "stack": 0, "spill_stores": 0,
                                     "spill_loads": 0})
        elif key is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            out[key]["stack"], out[key]["spill_stores"], out[key]["spill_loads"] = (
                int(m.group(1)), int(m.group(2)), int(m.group(3)))
        elif key is not None and "Used " in line:
            out[key]["registers"] = int(line.split("Used ")[1].split()[0])
            key = None
    return out


def schedule_ptxas(log: str) -> dict:
    """{"<schedule> <dtype>": {"registers", "stack", "spill_stores",
    "spill_loads"}} of the instances of schedule_counts, from the ptxas
    lines of an nvcc -Xptxas -v build log."""
    return _ptxas(log, _schedule_key)


def production_name(entry: str, dim: int, degree: int, dtype: str) -> str:
    """The key of a production instance: "<entry> <dim>D Q<degree>/Q<degree - 1>
    <double|float>"."""
    return f"{entry} {dim}D Q{degree}/Q{degree - 1} {dtype}"


def production_key(mangled: str):
    """The production_name of a mangled production instance of the cell
    kernel, or None for another kernel."""
    m = _PRODUCTION.search(mangled)
    if m is None:
        return None
    dim, n1, pres = int(m.group(1)), int(m.group(2)), m.group(5) == "1"
    mode = _MODE_OF.get(tuple(int(m.group(i)) for i in (6, 7, 8)))
    entry = next((e for e, md, pr in cm.PRODUCTION_ENTRIES if md == mode and pr == pres), None)
    if entry is None:
        return None
    return production_name(entry, dim, n1 - 1, "double" if m.group(9) == "d" else "float")


def production_counts(library: Path) -> dict:
    """{production_key: {opcode: count}} of the cell kernel's production
    instances in `library` (coupled_matvec's)."""
    return {production_key(n): c for n, c in _sass(library).items() if production_key(n)}


def production_ptxas(log: str) -> dict:
    """{production_key: {"registers", "stack", "spill_stores", "spill_loads"}}
    from the ptxas lines of the coupled_matvec library's build log."""
    return _ptxas(log, production_key)


def dot_key(mangled: str):
    """"<precision> (M, K) <X type>" of a mangled dense_dot_kernel instance
    (e.g. "bf16 (384, 96) bf16", K5's bf16 instance), or None."""
    m = _DOT_KERNEL.search(mangled)
    if m is None:
        return None
    prec = pk.PRECISIONS[int(m.group(1))]
    return f"{prec} ({m.group(2)}, {m.group(3)}) {_DOT_TYPES[m.group(4)]}"


def dot_counts(library: Path) -> dict:
    """{dot_key: {opcode: count}} of the dense dot's instances in `library`
    (probe_kernels')."""
    return {dot_key(n): c for n, c in _sass(library).items() if dot_key(n)}


def dot_ptxas(log: str) -> dict:
    """{dot_key: {"registers", "stack", "spill_stores", "spill_loads"}} from
    the ptxas lines of the probe library's build log."""
    return _ptxas(log, dot_key)


def dot_instances() -> list:
    """The dot's instances: every precision at every (m, k) of DOT_SHAPES
    (float32 inputs; float64 for f64), and K5's bf16 one, (384, 96) bf16."""
    keys = [f"{p} ({m}, {k}) {'double' if p == 'f64' else 'float'}"
            for p in pk.PRECISIONS for m, k in pk.DOT_SHAPES]
    return keys + ["bf16 (384, 96) bf16"]


def fma_key(mangled: str):
    """"<float|double> n_ops=<n> <aligned|shifted>" of a mangled K7 instance,
    or None for another kernel."""
    m = _FMA_KERNEL.search(mangled)
    if m is None:
        return None
    return (f"{'double' if m.group(1) == 'd' else 'float'} n_ops={m.group(2)} "
            f"{'shifted' if m.group(3) == '1' else 'aligned'}")


def fma_counts(library: Path) -> dict:
    """{fma_key: {opcode: count}} of K7's instances in `library`
    (probe_kernels')."""
    return {fma_key(n): c for n, c in _sass(library).items() if fma_key(n)}


def fma_ptxas(log: str) -> dict:
    """{fma_key: {"registers", "stack", "spill_stores", "spill_loads"}} from
    the ptxas lines of the probe library's build log."""
    return _ptxas(log, fma_key)


def check_fma(res: dict) -> list:
    """The K7 instance families ("<type> <shift>") whose instances are
    missing from `res`, whose LDS count changes with n_ops, or whose FP
    instructions (FMA_FP) do not grow between consecutive n_ops by the same
    positive multiple u of FMA_PER_STATEMENT per statement (u: the work
    items whose code the instance holds, 1 for a loop that is not
    unrolled)."""
    bad = []
    for t, ops in FMA_FP.items():
        for shift in ("aligned", "shifted"):
            c = [res.get(f"{t} n_ops={n} {shift}") for n in pk.N_OPS]
            if any(x is None for x in c):
                bad.append(f"{t} {shift}")
                continue
            fp = [sum(x.get(op, 0) for op in ops) for x in c]
            per = {(fp[i + 1] - fp[i]) / (pk.N_OPS[i + 1] - pk.N_OPS[i])
                   for i in range(len(fp) - 1)}
            lds = {x.get("LDS", 0) for x in c}
            (g,) = per if len(per) == 1 else (0,)
            if len(lds) != 1 or g < FMA_PER_STATEMENT or g % FMA_PER_STATEMENT:
                bad.append(f"{t} {shift}")
    return bad


def copies_key(mangled: str):
    """"<float|double> n_rows=<n>" of a mangled K8 instance, or None."""
    m = _COPIES_KERNEL.search(mangled)
    if m is None:
        return None
    return f"{'double' if m.group(1) == 'd' else 'float'} n_rows={m.group(2)}"


def copies_counts(library: Path) -> dict:
    """{copies_key: {opcode: count}} of K8's instances in `library`."""
    return {copies_key(n): c for n, c in _sass(library).items() if copies_key(n)}


def copies_ptxas(log: str) -> dict:
    """{copies_key: {"registers", "stack", "spill_stores", "spill_loads"}}
    from the ptxas lines of the probe library's build log."""
    return _ptxas(log, copies_key)


def check_copies(res: dict) -> list:
    """The K8 types ("float", "double") whose instances are missing from
    `res`, or whose step is not one LDS and one STS per copied row of a
    work item: STS n_rows x u at both row counts (u, the work items whose
    code the instance holds, >= 1), the LDS growing by the same amount
    between them; or whose global stores (STG) grow with the rows (a store
    inside the step loop), or without the slab's cp.async (LDGSTS)."""
    bad = []
    lo, hi = pk.N_ROWS
    for t in FMA_FP:
        a, b = res.get(f"{t} n_rows={lo}"), res.get(f"{t} n_rows={hi}")
        if a is None or b is None:
            bad.append(t)
            continue
        u, rem = divmod(b.get("STS", 0), hi)
        ok = (u >= 1 and rem == 0 and a.get("STS", 0) == lo * u
              and b.get("LDS", 0) - a.get("LDS", 0) == (hi - lo) * u
              and a.get("LDS", 0) >= lo * u
              and a.get("STG", 0) == b.get("STG", 0)
              and a.get("LDGSTS", 0) > 0 and b.get("LDGSTS", 0) > 0)
        if not ok:
            bad.append(t)
    return bad


def sfeval_key(mangled: str):
    """"<float|double>" of a mangled K10 instance, or None."""
    m = _SFEVAL_KERNEL.search(mangled)
    if m is None:
        return None
    return "double" if m.group(1) == "d" else "float"


def sfeval_counts(library: Path) -> dict:
    """{sfeval_key: {opcode: count}} of K10's instances in `library`."""
    return {sfeval_key(n): c for n, c in _sass(library).items() if sfeval_key(n)}


def sfeval_ptxas(log: str) -> dict:
    """{sfeval_key: {"registers", "stack", "spill_stores", "spill_loads"}}
    from the ptxas lines of the probe library's build log."""
    return _ptxas(log, sfeval_key)


def check_sfeval(res: dict) -> list:
    """The K10 types missing from `res`, or whose work item does not compute
    every statement from registers: FP instructions (FMA_FP) a positive
    multiple u of SF_PER_STATEMENT x SF_ITEM_STATEMENTS (u, the work items
    whose code the instance holds; a merged qy or qx plane takes some
    away), at least SF_ITEM_ROWS STS an item (its q rows), and at most
    SF_ITEM_LOADS LDS an item besides SF_OTHER_LDS (an operand read from
    shared memory per statement would take 3 each)."""
    bad = []
    per_item = SF_PER_STATEMENT * SF_ITEM_STATEMENTS
    for t, ops in FMA_FP.items():
        c = res.get(t)
        if c is None:
            bad.append(t)
            continue
        u, rem = divmod(sum(c.get(op, 0) for op in ops), per_item)
        if (u < 1 or rem or c.get("STS", 0) < SF_ITEM_ROWS * u
                or c.get("LDS", 0) > SF_ITEM_LOADS * u + SF_OTHER_LDS):
            bad.append(t)
    return bad


def check_dot(res: dict) -> list:
    """The dot instances missing from `res` or without the instructions of
    their design (DOT_OPS)."""
    return [k for k in dot_instances()
            if not all(res.get(k, {}).get(op, 0) > 0 for op in DOT_OPS[k.split()[0]])]


def check_schedules(res: dict) -> list:
    """The schedules (float32 and float64) missing from `res` or without
    their asynchronous copies (SCHEDULE_OPS)."""
    return [f"{name} {t}" for name, ops in SCHEDULE_OPS.items() for t in ("float", "double")
            if not all(res.get(f"{name} {t}", {}).get(op, 0) > 0 for op in ops)]


def show(res: dict) -> None:
    for name in sorted(res):
        c = res[name]
        print(f"{name}: " + ", ".join(f"{op} {c[op]}" for op in OPS if c[op]), flush=True)


def main() -> None:
    show(production_counts(cm.library_path()))
    show(counts(pk.library_path()))
    missing_dot = check_dot(dot_counts(pk.library_path()))
    merged = check_fma(fma_counts(pk.library_path()))
    copies = check_copies(copies_counts(pk.library_path()))
    sfeval = check_sfeval(sfeval_counts(pk.library_path()))
    sched = schedule_counts(cm.library_path())
    show(sched)
    missing = check_schedules(sched)
    if missing:
        raise SystemExit(f"schedules without their asynchronous copies: {missing}")
    if missing_dot:
        raise SystemExit(f"dot instances without their design's instructions: {missing_dot}")
    if merged:
        raise SystemExit(f"K7 instances whose statements did not all survive: {merged}")
    if copies:
        raise SystemExit(f"K8 types whose steps are not one LDS and STS a row: {copies}")
    if sfeval:
        raise SystemExit(f"K10 types whose statements are not all fed from registers: {sfeval}")


if __name__ == "__main__":
    main()
