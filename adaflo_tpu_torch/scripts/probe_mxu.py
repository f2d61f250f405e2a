"""K5: the matrix-unit rate of the cell apply's evaluation dot.

Counterpart of ``scripts/probe_mxu.py``: what the dot shape of the cell
apply, (384, 96) @ (96, B) blocks, sustains against the library's products.
Lines with ms and TFLOP/s: ``torch.matmul`` at n x n (default 4096) in
float32 (TF32 off), TF32 (on) and bf16; then per precision the library
call, ``torch.matmul`` of the stacked (384, 96) @ (96, cols) (default
110,592 columns), and K5, ``dense_dot_streamed``, the hand-written dot
(csrc/probe_kernels.cu) in f32 (CUDA cores), tf32, bf16 (bf16 in and out)
and f64 (tensor cores), against its plain version and its bound
(probe_bounds.k5_bound). TF32 is on only inside the TF32 library calls.
Times: 20 calls back to back between one pair of CUDA events, and one
waited call (time_ms); the kernel and its library call in 5 interleaved
rounds (time_rounds, medians), so that their ratio comes from one card in
one run.

Run: python -m adaflo_tpu_torch.scripts.probe_mxu [--n 4096] [--cols 110592]
[--reps 20] [--device cpu] [--seed 0]
"""

from __future__ import annotations

import argparse
import sys

import torch

from adaflo_tpu_torch.device import resolve_device
from adaflo_tpu_torch.ops import probe_kernels as pk
from adaflo_tpu_torch.scripts import allow_tf32, sync, time_ms, time_rounds
from adaflo_tpu_torch.scripts.probe_bounds import k5_bound

# tolerances of K5 against its plain version, max-abs error over max-abs:
# TF32 keeps a 10-bit mantissa over sums of 96 terms; the bf16 output is
# rounded to bf16 (two of its ulps)
TOL = {"f64": 1e-12, "f32": 1e-5, "tf32": 2e-3, "bf16": 8e-3}
TYPES = {"f32": torch.float32, "tf32": torch.float32, "bf16": torch.bfloat16,
         "f64": torch.float64}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096, help="size of the square product")
    ap.add_argument("--cols", type=int, default=110592, help="columns of X (default 110592)")
    ap.add_argument("--reps", type=int, default=20, help="timed calls (default 20)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random inputs")
    return ap.parse_args(argv)


def _matmul(a, b, precision):
    def call():
        if precision == "tf32":
            with allow_tf32():
                return torch.matmul(a, b)
        return torch.matmul(a, b)

    return call


def run(n: int = 4096, cols: int = 110592, reps: int = 20, device=None, seed: int = 0,
        out=print, plain_reps: int = 2) -> dict:
    """The library lines and K5 in every precision; returns {name: record},
    K5's records under "K5 <precision>"."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, dt):
        return torch.randn(shape, generator=gen, dtype=torch.float64).to(device=dev, dtype=dt)

    out(f"K5 matrix-unit probe: {n}^2 products, (384, 96) @ (96, {cols}), reps={reps}, {dev}")
    res = {}

    def line(name, ms, flops, extra=""):
        out(f"{name:46s} {ms:8.4f} ms  {flops / (ms * 1e-3) / 1e12:8.3f} TFLOP/s{extra}")

    for prec in ("f32", "tf32", "bf16"):
        a, b = rnd(n, n, dt=TYPES[prec]), rnd(n, n, dt=TYPES[prec])
        t = time_ms(_matmul(a, b, prec), dev, reps)
        res[f"matmul {n}^2 {prec}"] = t
        line(f"torch.matmul {n}^2 {prec}", t["ms"], 2 * n**3)
        del a, b
    flops = 2 * 384 * 96 * cols
    for prec in pk.PRECISIONS:
        A, X = rnd(384, 96, dt=TYPES[prec]), rnd(96, cols, dt=TYPES[prec])
        kern = lambda: pk.dense_dot_streamed(A, X, prec)
        plain = lambda: pk.dense_dot_streamed_plain(A, X, prec)
        got, ref = kern().double(), plain().double()
        sync(dev)
        max_abs = float((got - ref).abs().max())
        rel = max_abs / max(float(ref.abs().max()), 1e-300)
        del got, ref
        # the kernel and its library call in turns, so that their ratio is
        # taken on one card in one run
        t = time_rounds({"kernel": kern, "library": _matmul(A, X, prec)}, dev, reps)
        res[f"matmul stacked {prec}"] = t["library"]
        line(f"torch.matmul (384,96)@(96,{cols}) {prec}", t["library"]["ms"], flops)
        rec = dict(t["kernel"], max_abs_err=max_abs, rel_err=rel, tol=TOL[prec],
                   counter=f"dense_dot_streamed[{prec}]",
                   plain_ms=time_ms(plain, dev, plain_reps, warmup=0)["ms"],
                   library_ms=t["library"]["ms"], **k5_bound(cols, prec))
        res[f"K5 {prec}"] = rec
        line(f"dense_dot_streamed (K5) {prec}", rec["ms"], flops,
             f", one waited call {rec['call_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
             f"library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
             f"({rec['bound_by']}, {rec['rate']} rate), err {rec['rel_err']:.2e}")
    return res


def main(argv=None) -> None:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    run(args.n, args.cols, args.reps, args.device, args.seed)


if __name__ == "__main__":
    main()
