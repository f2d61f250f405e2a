"""K7-K10: the contraction-rate probes of the sum-factorized cell apply.

Counterpart of ``scripts/probe_sf.py``, which measures whether a
sum-factorized stencil form of the cell apply can win against the dense
cell matrices: the rate of the row-block three-term statements that every
sum-factorization stage is made of (vpu, K7 ``row_fma``; vpu_shift with a
lane-shifted operand), the cost of the 89-row shifted gather (copies, K8
``row_copies``), the rate of the dense evaluation dot (mxu, K9
``dense_dot``, in float32 on the CUDA cores, TF32 and bf16 on the tensor
cores; float64 on them with ``--dtype float64``) and a realistic three-stage
sum-factorized evaluation (sfeval, K10 ``sf_eval``, block min(block, 2048)
and 2 nblk steps). Each probe but sfeval runs at two work levels (24 and 96
statements, 29 and 89 rows, 96 and 384 rows of A); the slope between them
cancels the fixed cost of a step (its loads, the output, the launch), and
gives the marginal rate. Every configuration is held against its plain
version and printed with its time (time_rounds: 20 calls back to back
between one pair of CUDA events, and one waited call), its bound
(probe_bounds), the plain version's time and the library's where it
computes the same work: one step's work by one library call into one
output, repeated for the nblk steps as the kernel does (``per_step``: one
CUDA graph of the nblk calls on the card), for copies
``torch.index_select`` of the table's windows of x, for mxu
``torch.matmul``. vpu and sfeval have none. On the card copies and sfeval
also print their on-chip floor (probe_bounds.onchip_floor_ms): the
shared-memory bytes that their resident steps move, at the card's maximum
SM clock. Float32 is the default, as
in the JAX script; float64 is the port's working type.

Run: python -m adaflo_tpu_torch.scripts.probe_sf [--block 4096] [--nblk 29]
[--reps 20] [--dtype float32|float64] [--device cpu] [--seed 0]
"""

from __future__ import annotations

import argparse
import sys

import torch

from adaflo_tpu_torch.device import resolve_device
from adaflo_tpu_torch.ops import probe_kernels as pk
from adaflo_tpu_torch.scripts import allow_tf32, per_step, sync, time_ms, time_rounds
from adaflo_tpu_torch.scripts.probe_bounds import (
    k7_bound,
    k8_bound,
    k8_smem_bytes,
    k9_bound,
    k10_bound,
    k10_smem_bytes,
    onchip_floor_ms,
    sm_clock_mhz,
)

# tolerances, max-abs error over max-abs (chip_smoke.py holds phase 4 to them)
TOL = {"float64": 1e-12, "float32": 1e-5}
DOT_TOL = {"f64": 1e-12, "f32": 1e-5, "tf32": 2e-3, "bf16": 1e-5}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--block", type=int, default=4096, help="columns of a block (default 4096)")
    ap.add_argument("--nblk", type=int, default=29, help="grid steps (default 29)")
    ap.add_argument("--reps", type=int, default=20, help="timed calls (default 20)")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random inputs")
    return ap.parse_args(argv)


def _library_dot(A, x, precision, nblk):
    """torch.matmul of A with x into one output, once per grid step, in the
    precision's types (bf16 in and out)."""
    if precision == "bf16":
        A, x = A.to(torch.bfloat16), x.to(torch.bfloat16)
    out = x.new_empty((A.shape[0], x.shape[1]))

    def step():
        if precision == "tf32":
            with allow_tf32():
                return torch.matmul(A, x, out=out)
        return torch.matmul(A, x, out=out)

    return per_step(step, nblk, x.device)


def _library_copies(x, n_rows, nblk):
    """torch.index_select of the step's (row, offset) windows of x into one
    output, once per grid step."""
    block, ld = x.shape[1] - pk.SLAB_PAD, x.shape[1]
    windows = x.view(-1).as_strided((x.numel() - block + 1, block), (1, 1))
    starts = torch.tensor([r * ld + off for r, off in pk.copy_table(n_rows)], device=x.device)
    out = x.new_empty((n_rows, block))
    return per_step(lambda: torch.index_select(windows, 0, starts, out=out), nblk, x.device)


def probes(block, nblk, dtype, device, seed):
    """{probe: (work levels, unit, [config])}; a config is a dict of name,
    run, plain, library (or None), bound, tol."""
    gen = torch.Generator().manual_seed(seed)
    d = str(dtype).removeprefix("torch.")

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, dtype=torch.float64).to(device=device, dtype=dt)

    out = {}
    x7 = rnd(96, block + 128)
    for name, shifted in (("vpu", False), ("vpu_shift", True)):
        out[name] = ((24, 96), "op", [dict(
            name=f"{name}[n_ops={n}]", counter="row_fma",
            run=lambda n=n, s=shifted: pk.row_fma(x7, n, s, nblk),
            plain=lambda n=n, s=shifted: pk.row_fma_plain(x7, n, s, nblk), library=None,
            bound=k7_bound(block, nblk, n, d), tol=TOL[d]) for n in (24, 96)])
    x8 = rnd(32, block + pk.SLAB_PAD)
    out["copies"] = ((29, 89), "row", [dict(
        name=f"copies[n_rows={n}]", counter="row_copies",
        run=lambda n=n: pk.row_copies(x8, n, nblk),
        plain=lambda n=n: pk.row_copies_plain(x8, n, nblk),
        library=_library_copies(x8, n, nblk), bound=k8_bound(block, nblk, n, d), tol=0.0,
        smem_bytes=k8_smem_bytes(block, nblk, n, d)) for n in (29, 89)])
    dots = [("mxu_k96", 96, "f64" if d == "float64" else "f32")]
    if d == "float32":
        dots += [("mxu_k96tf", 96, "tf32"), ("mxu_k96bf", 96, "bf16")]
    dots += [("mxu_k32", 32, "f64" if d == "float64" else "f32")]
    for name, k, prec in dots:
        x9 = rnd(k, block)
        cfgs = []
        for m in (96, 384):
            A = rnd(m, k)
            cfgs.append(dict(
                name=f"{name}[m={m}]", counter=f"dense_dot[{prec}]",
                run=lambda A=A, x=x9, p=prec: pk.dense_dot(A, x, p, nblk),
                plain=lambda A=A, x=x9, p=prec: pk.dense_dot_plain(A, x, p, nblk),
                library=_library_dot(A, x9, prec, nblk),
                bound=k9_bound(block, nblk, m, k, prec), tol=DOT_TOL[prec]))
        out[name] = ((96, 384), "mrow", cfgs)
    b10, n10 = min(block, 2048), 2 * nblk
    x10 = rnd(32, b10 + pk.SLAB_PAD)
    out["sfeval"] = (None, "apply", [dict(
        name="sfeval", counter="sf_eval", run=lambda: pk.sf_eval(x10, n10),
        plain=lambda: pk.sf_eval_plain(x10, n10), library=None,
        bound=k10_bound(b10, n10, d), tol=TOL[d], smem_bytes=k10_smem_bytes(b10, n10, d))])
    return out


def _err(got, ref):
    got, ref = got.double(), ref.double()
    max_abs = float((got - ref).abs().max())
    return max_abs, max_abs / max(float(ref.abs().max()), 1e-300)


def run(block: int = 4096, nblk: int = 29, reps: int = 20, dtype=torch.float32, device=None,
        seed: int = 0, out=print, plain_reps: int = 2) -> dict:
    """Every probe: its configurations against their plain versions, timed in
    turns; returns {"configs": {name: record}, "slopes": {probe: record}}."""
    dev = resolve_device(device)
    d = str(dtype).removeprefix("torch.")
    out(f"K7-K10 contraction-rate probes: block={block} nblk={nblk} reps={reps} {d}, {dev}")
    configs, slopes = {}, {}
    clock = sm_clock_mhz() if dev.type == "cuda" else None
    for probe, (levels, unit, cfgs) in probes(block, nblk, dtype, dev, seed).items():
        for c in cfgs:
            got, ref = c["run"](), c["plain"]()
            sync(dev)
            max_abs, rel = _err(got, ref)
            del got, ref
            rec = dict(max_abs_err=max_abs, rel_err=rel, tol=c["tol"], counter=c["counter"],
                       plain_ms=time_ms(c["plain"], dev, plain_reps, warmup=0)["ms"],
                       library_ms=None, **c["bound"])
            if c["library"] is not None:
                rec["library_ms"] = time_ms(c["library"], dev, reps)["ms"]
            if clock is not None and "smem_bytes" in c:  # K8, K10: their on-chip floor
                rec["onchip_ms"] = onchip_floor_ms(c["smem_bytes"], clock)
            configs[c["name"]] = rec
        for name, t in time_rounds({c["name"]: c["run"] for c in cfgs}, dev, reps).items():
            configs[name].update(t)
        for c in cfgs:
            r = configs[c["name"]]
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            if "onchip_ms" in r:
                lib += f", on-chip floor {r['onchip_ms']:.4f} ms"
            out(f"{c['name']:20s} {r['ms']:8.4f} ms ({dev.type}), one waited call "
                f"{r['call_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib}, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['rate']} rate: "
                f"{r['bytes'] / 1e6:.2f} MB, {r['flops'] / 1e9:.3f} GFLOP), err {r['rel_err']:.2e}")
        if levels is None:
            out(f"{probe}: {configs[cfgs[0]['name']]['ms']:.4f} ms/apply")
            continue
        lo, hi = (configs[c["name"]] for c in cfgs)
        slope = (hi["ms"] - lo["ms"]) / (levels[1] - levels[0]) * 1e-3  # s per unit
        flops = (hi["flops"] - lo["flops"]) / (levels[1] - levels[0])
        if unit == "op":  # one statement: 3 multiply-adds per element of (24, block)
            macs = 3 * 24 * block * nblk
        elif unit == "mrow":  # one row of A: k multiply-adds per column
            macs = flops / 2
        else:
            macs = 0
        rec = dict(slope_us=slope * 1e6, lo_ms=lo["ms"], hi_ms=hi["ms"],
                   tmacs=macs / slope / 1e12 if slope > 0 and macs else None)
        slopes[probe] = rec
        rate = "" if rec["tmacs"] is None else f" -> {rec['tmacs']:.3f} TMAC/s marginal"
        extra = f", 89 rows = {slope * 89 * 1e3:.4f} ms marginal" if unit == "row" else ""
        out(f"{probe}: slope {rec['slope_us']:.3f} us/{unit}{rate}{extra}  "
            f"(t{levels[0]}={lo['ms']:.4f} t{levels[1]}={hi['ms']:.4f} ms)")
    return dict(configs=configs, slopes=slopes)


def main(argv=None) -> None:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    run(args.block, args.nblk, args.reps, getattr(torch, args.dtype), args.device, args.seed)


if __name__ == "__main__":
    main()
