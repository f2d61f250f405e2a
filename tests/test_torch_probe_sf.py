"""The contraction-rate and matrix-unit probes (K5, K7-K10) against the JAX
package's probe kernels, on the CPU.

- The plain versions of ``ops/probe_kernels`` against the Pallas kernels of
  ``scripts/probe_sf.py`` (``run_vpu`` K7, ``run_copies`` K8, ``run_mxu`` K9,
  ``run_sfeval`` K10) at block 128 and 2 grid steps, and of
  ``scripts/probe_mxu.py`` (``pall`` K5) at its full 110,592 columns, each run
  in TPU interpret mode: the scripts' ``pl`` is replaced by a shim whose
  ``pallas_call`` runs the call in interpret mode and records its inputs and
  output, their ``timed`` by a single call; the port's plain version gets the
  recorded inputs. Tolerances, max-abs error over max-abs: K7 1e-6, K8 exact,
  K9 1e-6 (f32 and bf16 inputs; bf16 products are exact in float32), K10
  1e-6 on rows 0-26 (the JAX kernel leaves its pad rows 27-31 unwritten,
  NaN in interpret mode), K5 f32 "highest" and "default" (the port's tf32
  entry, whose plain version is the float32 product) 1e-6, bf16 output 8e-3
  (two bf16 ulps: sums in another order can round to neighbouring bf16
  values).
- The work counts behind the bounds: K10's elements written by the JAX body
  (F10: stage z is 18 statements of (4, w1)), K7's operands read and the
  slab elements K8's copies read.
- The drivers: CUDA needed unless ``--device cpu``, their CPU runs, and no
  import of JAX, the JAX package or ``scripts/``.
- The build and SASS tooling of the dense dot (K5, K9): the library's hash
  follows the headers a source includes (``ops/build.source_tag``), and
  ``scripts/sass_counts`` keys the dot's instances and flags one without its
  design's instructions; it keys K7's instances and flags a family whose
  statements were merged or whose operands come from shared memory; it
  keys K8's and K10's instances, counts no never-executed (@!PT)
  instruction, and flags a K8 step that is not one LDS and STS a row or
  stores to global memory, and a K10 work item whose statements were
  merged or read from shared memory.

The JAX probe scripts set ADAFLO_* variables and sys.path when imported;
they are loaded with both restored afterwards.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from adaflo_tpu_torch.ops import probe_kernels as pk
from adaflo_tpu_torch.scripts import probe_bounds as pb

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BLOCK, NBLK = 128, 2


class PallasShim:
    """Stands in for a script's `pl`: pallas_call runs in TPU interpret mode
    and records (kernel, inputs, output) of every call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, kernel, **kw):
        with pltpu.force_tpu_interpret_mode():
            call = pl.pallas_call(kernel, **kw)

        def run(*args):
            with pltpu.force_tpu_interpret_mode():
                out = call(*args)
            self.calls.append((kernel, [np.asarray(a) for a in args], np.asarray(out)))
            return out

        return run


def _load(name):
    """scripts/<name>.py imported without ADAFLO_BENCH and ADAFLO_TPU_NO_X64,
    which it sets when imported; sys.path and the environment are restored
    exactly afterwards, so that nothing stays set for the JAX tests that the
    same worker runs next."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    path, env = list(sys.path), dict(os.environ)
    try:
        for k in ("ADAFLO_BENCH", "ADAFLO_TPU_NO_X64"):
            os.environ.pop(k, None)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        os.environ.clear()
        os.environ.update(env)
    return mod


@pytest.fixture
def sf():
    """scripts/probe_sf.py with the shim and a single untimed call."""
    mod = _load("probe_sf")
    mod.pl = PallasShim()
    mod.timed = lambda call, x, reps: (call(x), 0.0)[1]
    return mod


def _t(a):
    """A recorded JAX array as a tensor (bf16 through float32, exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / float(np.abs(ref).max())


@pytest.mark.parametrize("shifted", [False, True], ids=["aligned", "shifted"])
def test_k7_plain_matches_jax_probe_kernel(sf, shifted):
    sf.run_vpu(BLOCK, NBLK, 1, shifted=shifted, n_ops=24)
    (_, (x,), out), = sf.pl.calls
    assert _rel(pk.row_fma_plain(_t(x), 24, shifted), out) <= 1e-6


@pytest.mark.parametrize("n_rows", pk.N_ROWS)
def test_k8_plain_equals_jax_probe_kernel(sf, n_rows):
    sf.run_copies(BLOCK, NBLK, 1, n_rows=n_rows)
    (_, (x,), out), = sf.pl.calls
    np.testing.assert_array_equal(pk.row_copies_plain(_t(x), n_rows).numpy(), out)


@pytest.mark.parametrize("k,bf16", [(96, False), (32, False), (96, True)],
                         ids=["k96-f32", "k32-f32", "k96-bf16"])
def test_k9_plain_matches_jax_probe_kernel(sf, k, bf16):
    sf.run_mxu(BLOCK, NBLK, 1, m=96, k=k, bf16=bf16)
    (_, (A, x), out), = sf.pl.calls
    got = pk.dense_dot_plain(_t(A), _t(x), "bf16" if bf16 else "f32")
    assert got.dtype == torch.float32
    assert _rel(got, out) <= 1e-6


def test_k10_plain_matches_jax_probe_kernel_on_the_written_rows(sf):
    sf.run_sfeval(BLOCK, NBLK, 1)
    (_, (x,), out), = sf.pl.calls
    got = pk.sf_eval_plain(_t(x))
    assert got.shape == (384, BLOCK)
    assert _rel(got[:27], out[:27]) <= 1e-6
    assert torch.equal(got.reshape(12, 32, BLOCK)[:, 27:], torch.zeros(12, 5, BLOCK))


def test_k5_plain_matches_jax_probe_kernel():
    """pall at f32 "highest", f32 "default" and bf16 (bf16 in and out), in
    that order, over the full 110,592 columns; the xla lines are skipped."""
    mod = _load("probe_mxu")
    mod.pl = PallasShim()
    mod.timed = lambda name, fn, *args, flops=None: (
        fn(*args) if name.startswith("pallas") else None)
    mod.main()
    assert len(mod.pl.calls) == 3
    for (_, (A, X), out), prec, tol in zip(mod.pl.calls, ("f32", "tf32", "bf16"),
                                          (1e-6, 1e-6, 8e-3)):
        A, X = _t(A), _t(X)
        got = pk.dense_dot_streamed_plain(A, X, prec)
        assert got.dtype == A.dtype and got.shape == (384, 110592)
        assert _rel(got.float(), np.asarray(out, np.float32)) <= tol


class Counting:
    """A numpy array behind refs that count the elements read and written."""

    def __init__(self, a):
        self.a, self.read, self.written = a, 0, 0

    def __getitem__(self, k):
        v = self.a[k]
        self.read += v.size
        return v

    def __setitem__(self, k, v):
        self.a[k] = v
        self.written += self.a[k].size


def test_k10_bound_counts_the_jax_body_work():
    """F10: the JAX body writes 152,064 + 333,072 + 663,552 elements per step
    at block 2048 (stage z 18 x 4 x w1, not 18 x 3 x 4 x w1), 5 flops each."""
    sf = _load("probe_sf")
    block = 2048
    w1, w2 = block + 64, block + 8
    rng = np.random.default_rng(3)
    x = Counting(rng.standard_normal((32, block + 2560)).astype(np.float32))
    z, y, r = (Counting(np.zeros(s, np.float32))
               for s in ((144, w1), (648, w2), (384, block)))
    V, D = (0.3, 0.5, 0.2), (-1.0, 0.0, 1.0)
    sf._sf_eval_body(x, z, y, r, block, w1, w2, V, D, V, D, V, D)
    assert (z.written, y.written, r.written) == (152064, 333072, 663552)
    assert pb.k10_elements_per_step(block) == z.written + y.written + r.written == 1148688
    assert pb.k10_bound(block, 1)["flops"] == 5743440
    assert pb.k10_bound(block, 58)["flops"] == 58 * 5743440


@pytest.mark.parametrize("n_ops", pk.N_OPS)
def test_k7_bound_counts_the_jax_kernel_operands(n_ops):
    """K7's kernel reads three (24, block) operands per statement; each is
    multiplied and added once (the first statement starts the sum)."""
    sf = _load("probe_sf")
    shim = PallasShim()
    shim.pallas_call = lambda kernel, **kw: shim.calls.append(kernel) or (lambda x: x)
    sf.pl, sf.timed = shim, lambda call, x, reps: 0.0
    block = 256
    sf.run_vpu(block, 1, 1, n_ops=n_ops)
    x = Counting(np.random.default_rng(4).standard_normal((96, block + 128)))
    o = np.zeros((24, block))
    shim.calls[0](x, o)
    assert x.read == 3 * n_ops * 24 * block
    assert pb.k7_bound(block, 1, n_ops)["flops"] == 2 * x.read - 24 * block


class Marking:
    """A numpy array behind a ref that marks every element read."""

    def __init__(self, a):
        self.a, self.seen = a, np.zeros(a.shape, bool)

    def __getitem__(self, k):
        self.seen[k] = True
        return self.a[k]


@pytest.mark.parametrize("block", [256, 4096])
@pytest.mark.parametrize("n_rows", pk.N_ROWS)
def test_k8_bound_counts_the_slab_elements_the_jax_kernel_reads(n_rows, block):
    """K8's bytes: the slab elements the JAX copies read (each once, however
    many copies share it) and the (n_rows, block) rows they write."""
    sf = _load("probe_sf")
    shim = PallasShim()
    shim.pallas_call = lambda kernel, **kw: shim.calls.append(kernel) or (lambda x: x)
    sf.pl, sf.timed = shim, lambda call, x, reps: 0.0
    sf.run_copies(block, 1, 1, n_rows=n_rows)
    x = Marking(np.random.default_rng(5).standard_normal((32, block + 2560)).astype(np.float32))
    o = np.zeros((n_rows, block), np.float32)
    shim.calls[0](x, o)
    read = int(x.seen.sum())
    assert pb.k8_read_elements(block, n_rows) == read
    assert pb.k8_bound(block, 29, n_rows)["bytes"] == 4 * (read + n_rows * block)
    assert pb.k8_bound(block, 29, n_rows, "float64")["bytes"] == 8 * (read + n_rows * block)


def test_probe_bounds_name_their_rates():
    """F11: K7 and K10 in float64 run on the CUDA cores (34 TFLOP/s); the
    dot's float64 on the tensor cores (67 TFLOP/s)."""
    from adaflo_tpu_torch.scripts import PEAK_FLOPS

    assert PEAK_FLOPS["float64_simt"] == 34e12 and PEAK_FLOPS["float64"] == 67e12
    assert pb.k7_bound(4096, 29, 96, "float64")["rate"] == "float64_simt"
    assert pb.k10_bound(2048, 58, "float64")["rate"] == "float64_simt"
    assert pb.k9_bound(4096, 29, 384, 96, "f64")["rate"] == "float64"
    assert pb.k10_bound(2048, 58)["bound_ms"] == pytest.approx(1e3 * 58 * 5743440 / 67e12)
    assert pb.k8_bound(4096, 29, 89)["bound_by"] == "bytes"
    b = pb.bounds()
    assert {k.split()[0] for k in b} == {"K5", "K7", "K8", "K9", "K10"}
    assert all(v["bound_ms"] > 0 for v in b.values())


DRIVERS = {"probe_sf": ["--block", "128", "--nblk", "1", "--reps", "1"],
           "probe_mxu": ["--n", "128", "--cols", "1024", "--reps", "1"]}


@pytest.mark.parametrize("name", DRIVERS)
def test_probe_driver_raises_without_cuda_unless_the_cpu_is_asked_for(monkeypatch, capsys,
                                                                       name):
    mod = importlib.import_module(f"adaflo_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(DRIVERS[name])
    mod.main(DRIVERS[name] + ["--device", "cpu"])
    assert "cpu" in capsys.readouterr().out


def test_probe_sf_driver_holds_every_configuration_to_its_plain_version_on_the_cpu():
    """On the CPU every entry runs its plain version, so every error is 0;
    the slopes of the two-level probes and their bounds are reported."""
    from adaflo_tpu_torch.scripts import probe_sf

    res = probe_sf.run(128, 1, 1, torch.float32, "cpu", out=lambda *a: None)
    assert set(res["slopes"]) == {"vpu", "vpu_shift", "copies", "mxu_k96", "mxu_k96tf",
                                  "mxu_k96bf", "mxu_k32"}
    assert all(r["rel_err"] == 0.0 for r in res["configs"].values())
    assert res["configs"]["copies[n_rows=89]"]["library_ms"] is not None
    assert res["configs"]["sfeval"]["library_ms"] is None
    r64 = probe_sf.run(128, 1, 1, torch.float64, "cpu", out=lambda *a: None)
    assert r64["configs"]["mxu_k96[m=384]"]["rate"] == "float64"
    assert r64["configs"]["vpu[n_ops=96]"]["rate"] == "float64_simt"


_ISOLATION = """
import sys
from adaflo_tpu_torch.scripts import probe_mxu, probe_sf
probe_sf.main(["--device", "cpu", "--block", "128", "--nblk", "1", "--reps", "1"])
probe_mxu.main(["--device", "cpu", "--n", "128", "--cols", "1024", "--reps", "1"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "adaflo_tpu", "scripts"))
assert not bad, bad
"""


def test_probe_drivers_run_without_jax_the_jax_package_or_its_scripts():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "sfeval" in proc.stdout and "dense_dot_streamed (K5) bf16" in proc.stdout


def test_library_hash_covers_the_headers_a_source_includes(tmp_path):
    """build.source_tag hashes the source and every file it includes from
    its directory (followed through the headers): an edited header names a
    new library, an unrelated file does not; the port's sources include the
    shared Hopper header."""
    from adaflo_tpu_torch.ops import build

    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n#include "missing.cuh"\n')
    assert [f.name for f in build.source_files(src)] == ["k.cu", "a.cuh", "b.cuh"]
    tag = build.source_tag(src)
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert build.source_tag(src) == tag
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert build.source_tag(src) != tag
    csrc = Path(build.__file__).resolve().parents[1] / "csrc"
    for name in ("probe_kernels.cu", "coupled_matvec.cu"):
        assert [f.name for f in build.source_files(csrc / name)] == [name, "hopper.cuh"]


def test_sass_counts_find_the_dot_instances():
    """sass_counts keys the dense dot's instances by precision, (m, k) and X
    type from their mangled names, reads their registers, stack and spills
    from the ptxas lines, and flags an instance whose SASS lacks its
    design's instructions (TMA loads and mbarriers everywhere, HGMMA for
    bf16 and TF32, DMMA for float64, FFMA for float32)."""
    from adaflo_tpu_torch.scripts import sass_counts as sc

    name = "_ZN12_GLOBAL__N_116dense_dot_kernelILi{}ELi{}ELi{}E{}EEv14CUtensorMap_stS1_PKT2_PT3_xxx"
    k5 = name.format(2, 384, 96, "13__nv_bfloat16S2_")
    k9 = name.format(3, 96, 32, "dd")
    assert sc.dot_key(k5) == "bf16 (384, 96) bf16"
    assert sc.dot_key(k9) == "f64 (96, 32) double"
    assert sc.dot_key(name.format(1, 384, 96, "ff")) == "tf32 (384, 96) float"
    assert sc.dot_key("_ZN12_GLOBAL__N_114row_fma_kernelIfLi24ELb0EEEvPKT_PS1_iii") is None
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{k5}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k5}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 119 registers, used 1 barriers, 384 bytes cmem[0]",
        f"ptxas info    : Function properties for {k9}",
        "    96 bytes stack frame, 92 bytes spill stores, 88 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]",
    ])
    assert sc.dot_ptxas(log) == {
        "bf16 (384, 96) bf16": {"registers": 119, "stack": 0, "spill_stores": 0, "spill_loads": 0},
        "f64 (96, 32) double": {"registers": 168, "stack": 96, "spill_stores": 92,
                                "spill_loads": 88}}
    keys = sc.dot_instances()
    assert len(keys) == 4 * len(pk.DOT_SHAPES) + 1 and "bf16 (384, 96) bf16" in keys
    ok = {k: {op: 1 for op in sc.DOT_OPS[k.split()[0]]} for k in keys}
    assert sc.check_dot(ok) == []
    ok["bf16 (384, 96) bf16"]["HGMMA"] = 0
    ok["f64 (96, 32) double"] = {"UTMALDG": 2, "SYNCS": 9, "DMMA": 0, "HMMA": 8}
    del ok["f32 (384, 96) float"]
    assert sc.check_dot(ok) == ["f32 (384, 96) float", "f64 (96, 32) double",
                                "bf16 (384, 96) bf16"]


# K7's SASS counts (FMA, MUL, ADD of the type; LOP3; LDS) at n_ops 24, 72, 96,
# as recorded on an H100 (sm_90a, float32 aligned) for four forms of the
# register-fed kernel: the kernel's, no two terms on the same data sharing a
# salted 0.31, and every statement's 0.31 salted apart (both keep every
# statement); the operands through an empty asm register pass, and one salt
# per period of the statement sequence (both merged by ptxas)
K7_RECORDED = {
    "salt per shared data": ((144, 72, 69, 12, 0), (432, 216, 213, 30, 0), (576, 288, 285, 39, 0)),
    "salt per statement": ((144, 72, 69, 27, 0), (432, 216, 213, 75, 0), (576, 288, 285, 99, 0)),
    "empty asm pass": ((20, 10, 69, 0, 0), (20, 10, 213, 0, 0), (20, 10, 285, 0, 0)),
    "salt per period": ((60, 30, 69, 6, 0), (180, 90, 213, 11, 0), (240, 120, 285, 14, 0)),
}


def _k7(t, shift, form, lds=None):
    """The K7 family (type t, shift) with the recorded counts of `form`;
    lds(n) in place of its LDS when given."""
    from adaflo_tpu_torch.scripts import sass_counts as sc

    fma, mul, add = sc.FMA_FP[t]
    return {f"{t} n_ops={n} {shift}": {fma: c[0], mul: c[1], add: c[2], "LOP3": c[3],
                                        "LDS": c[4] if lds is None else lds(n)}
            for n, c in zip(pk.N_OPS, K7_RECORDED[form])}


def test_sass_counts_hold_k7_statements_to_registers():
    """sass_counts keys K7's instances by type, n_ops and shift, reads their
    registers from the ptxas lines, and passes a family (type and shift)
    only if its FP instructions grow by 4 x 3 per statement (or a multiple:
    unrolled work items) and its LDS do not grow. On counts recorded on the
    card it passes the forms that keep every statement and flags the forms
    that ptxas merged (K7_RECORDED); it flags operands read from
    shared memory (LDS growing with the statements, 3 per statement and row
    group, as the earlier design read them) and a missing instance."""
    from adaflo_tpu_torch.scripts import sass_counts as sc

    name = "_ZN12_GLOBAL__N_114row_fma_kernelI{}Li{}ELb{}EEEvPKT_PS1_iiij"
    assert sc.fma_key(name.format("f", 96, 0)) == "float n_ops=96 aligned"
    assert sc.fma_key(name.format("d", 24, 1)) == "double n_ops=24 shifted"
    assert sc.fma_key("_ZN12_GLOBAL__N_117row_copies_kernelIfLi29EEEvPKT_PS1_iii") is None
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name.format('d', 96, 1)}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name.format('d', 96, 1)}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 124 registers, 384 bytes cmem[0]",
    ])
    assert sc.fma_ptxas(log) == {"double n_ops=96 shifted": {
        "registers": 124, "stack": 0, "spill_stores": 0, "spill_loads": 0}}

    good = {}
    for t in sc.FMA_FP:
        good |= _k7(t, "aligned", "salt per shared data")
        good |= _k7(t, "shifted", "salt per statement")
    assert sc.check_fma(good) == []
    unrolled = {k: {op: 2 * v for op, v in c.items()} for k, c in good.items()}
    assert sc.check_fma(unrolled) == []  # two work items' code: 24 per statement
    bad = dict(good)
    bad |= _k7("float", "aligned", "empty asm pass")
    bad |= _k7("float", "shifted", "salt per period")
    bad |= _k7("double", "aligned", "salt per statement", lds=lambda n: 6 * 3 * n)
    del bad["double n_ops=72 shifted"]
    assert sc.check_fma(bad) == ["float aligned", "float shifted", "double aligned",
                                 "double shifted"]


# K8's and K10's SASS counts (sass_counts, executed instructions) as the
# card's build gave them: K8 one LDS and one STS per copied row, the output
# tile's one LDS and STG, the slab's cp.async (LDGSTS) per span; K10 243 FP
# instructions (81 statements), its 27 operands' LDS and 36 q rows' STS, the
# output tile's LDS and the pad rows' STS
K8_RECORDED = {29: {"LDS": 30, "STS": 29, "STG": 1, "LDGSTS": 50, "LOP3": 10},
               89: {"LDS": 90, "STS": 89, "STG": 1, "LDGSTS": 50, "LOP3": 10}}
K10_RECORDED = {"mul": 81, "fma": 162, "LDS": 28, "STS": 37, "STG": 1, "LDGSTS": 1, "LOP3": 25}


def _k10(t, **change):
    from adaflo_tpu_torch.scripts import sass_counts as sc

    fma, mul, _ = sc.FMA_FP[t]
    c = dict(K10_RECORDED, **change)
    return {fma: c.pop("fma"), mul: c.pop("mul"), **c}


def test_sass_counts_hold_k8_and_k10_to_their_design(monkeypatch):
    """sass_counts keys K8's instances by type and rows and K10's by type,
    reads their registers from the ptxas lines, and skips the placeholders
    under the never-true predicate @!PT that nvcc puts before a cp.async.
    On the counts recorded on the card it passes both; it flags a K8 whose
    step reads or stores global memory per row (the earlier design: LDG and
    STG a row), one without the slab's cp.async, a K10 whose qy or qx planes
    merged (fewer FP instructions than 243 a work item), one whose operands
    come from shared memory per statement, and missing instances."""
    from adaflo_tpu_torch.scripts import sass_counts as sc

    k8 = "_ZN12_GLOBAL__N_117row_copies_kernelI{}Li{}EEEvPKT_PS1_iiNS_5StepsE"
    k10 = "_ZN12_GLOBAL__N_114sf_eval_kernelI{}EEvPKT_PS1_iiNS_5StepsENS_8SfCoeffsIS1_EEj"
    assert sc.copies_key(k8.format("f", 29)) == "float n_rows=29"
    assert sc.copies_key(k8.format("d", 89)) == "double n_rows=89"
    assert sc.sfeval_key(k10.format("d")) == "double" and sc.sfeval_key(k8.format("f", 29)) is None
    assert sc.copies_key(k10.format("f")) is None and sc.fma_key(k10.format("f")) is None
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{k10.format('f')}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k10.format('f')}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
    ])
    assert sc.sfeval_ptxas(log) == {"float": {"registers": 64, "stack": 0, "spill_stores": 0,
                                              "spill_loads": 0}}
    sass = "\n".join([
        f"\t\tFunction : {k10.format('f')}",
        "        /*0bd0*/              @!PT LDS RZ, [RZ] ;                /* 0x00000000fffff984 */",
        "        /*0c00*/                   LDGSTS.E [R7+0xc000], desc[UR8][R4.64] ;  /* 0x0c00 */",
        "        /*0ea0*/                   LDS R21, [R40+0xc000] ;        /* 0x00c0000028157984 */",
        "        /*0f10*/              @!P0 LDS R34, [R36+0xdec0] ;        /* 0x00dec00024227984 */",
        "        /*1d70*/                   FFMA R3, R30, c[0x0][0x2a4], R3 ;  /* 0x0000a9001e037a23 */",
    ])
    monkeypatch.setattr(sc, "_dump", lambda library: sass)
    got = sc.sfeval_counts(Path("lib.so"))["float"]
    assert (got["LDS"], got["LDGSTS"], got["FFMA"]) == (2, 1, 1)

    good = {f"{t} n_rows={n}": dict(c) for t in sc.FMA_FP for n, c in K8_RECORDED.items()}
    assert sc.check_copies(good) == []
    bad = dict(good)
    bad["float n_rows=29"] = {"LDG": 29, "STG": 29}  # the earlier design
    bad["float n_rows=89"] = {"LDG": 89, "STG": 89}
    bad["double n_rows=89"] = dict(K8_RECORDED[89], STG=90)  # a store inside the steps
    assert sc.check_copies(bad) == ["float", "double"]
    no_async = {k: dict(c, LDGSTS=0) for k, c in good.items()}
    assert sc.check_copies(no_async) == ["float", "double"]
    del good["double n_rows=29"]
    assert sc.check_copies(good) == ["double"]

    ok = {t: _k10(t) for t in sc.FMA_FP}
    assert sc.check_sfeval(ok) == []
    two_items = {t: _k10(t, mul=2 * 81, fma=2 * 162, LDS=2 * 27 + 1, STS=2 * 36 + 1)
                 for t in sc.FMA_FP}  # two work items' code
    assert sc.check_sfeval(two_items) == []
    merged_qy = _k10("float", mul=18 + 3 * 3 + 3 * 4, fma=2 * (18 + 9 + 12))
    shared_fed = _k10("double", LDS=3 * 81)
    assert sc.check_sfeval({"float": merged_qy, "double": shared_fed}) == ["float", "double"]
    assert sc.check_sfeval({"float": ok["float"]}) == ["double"]


def test_onchip_floors_count_the_resident_steps_shared_bytes():
    """K8's and K10's on-chip floors: the shared-memory bytes of their
    resident steps (K8 a load and a store per copied element, K10 9 work
    items of 27 loads and 36 stores a column) over 128 bytes a clock on
    each of 132 SMs."""
    from adaflo_tpu_torch.scripts import probe_bounds as pb

    assert pb.k8_smem_bytes(4096, 29, 89, "float32") == 2 * 89 * 4096 * 29 * 4
    assert pb.k10_smem_bytes(2048, 58, "float64") == 9 * 63 * 2048 * 58 * 8
    assert pb.onchip_floor_ms(128 * 132 * 1000, 1000.0) == pytest.approx(1e-3)
    assert pb.onchip_floor_ms(pb.k8_smem_bytes(4096, 29, 89), 1980.0) == pytest.approx(
        0.0025281, rel=1e-4)
