"""K12: the coupled cell apply with one phase dropped at a time.

Counterpart of ``scripts/probe_pr_phases.py`` (``_kernel_ablate``, ablated
copies of the resident apply): each variant is an instance of the cell
kernel (``csrc/coupled_matvec.cu``) with one phase masked out at compile
time (gather, eval_u, eval_ustar, qpoint, integrate, scatter), plus the full
apply and the gather with the output store only (dma_only). The difference
full - ablated attributes the apply's time to its phases. Each variant is
held against its plain version (``coupled_apply_ablated_plain``) and timed
with CUDA events (time_rounds): the applies issued back to back, and one
waited call, which adds the wrapper's host work and launch.

Run: python -m adaflo_tpu_torch.scripts.probe_pr_phases [--cells 48]
[--reps 20] [--dtype float64|float32] [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.scripts import (
    joint_err,
    parse_args,
    probe_case,
    sync,
    time_ms,
    time_rounds,
    variant_bound,
)


def run_variants(case, variants, reps: int, out=print, plain_reps: int = 3) -> dict:
    """Each variant of `variants` (names of coupled_matvec.VARIANTS) once
    against its plain version, then all timed in turns (time_rounds):
    {name: record}."""
    op, u, p, sc = case.op, case.u, case.p, case.sc
    cells, dev = op.cells, u.device
    runs = {name: (lambda name=name: cm.coupled_apply_ablated(u, p, u, cells, sc, name))
            for name in variants}
    results = {}
    for name in variants:
        plain = lambda: cm.coupled_apply_ablated_plain(u, p, u, cells, sc, name)
        got, ref = runs[name](), plain()
        sync(dev)
        max_abs, rel = joint_err(got, ref)
        del got, ref
        plain_ms = time_ms(plain, dev, plain_reps, warmup=1)["ms"]
        b = variant_bound(name, cells, u.shape[1], p.shape[0], u.dtype)
        results[name] = dict(plain_ms=plain_ms, max_abs_err=max_abs, rel_err=rel, **b)
    for name, t in time_rounds(runs, dev, reps).items():
        results[name].update(t)
    for name, r in results.items():
        out(
            f"{name:18s} {r['ms']:8.4f} ms/apply ({dev.type}), one waited call "
            f"{r['call_ms']:.4f} ms, plain {r['plain_ms']:8.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB, "
            f"{r['flops'] / 1e9:.3f} GFLOP), err {r['rel_err']:.2e}"
        )
    return results


def run(cells: int = 48, reps: int = 20, dtype=torch.float64, device=None,
        seed: int = 0, out=print) -> dict:
    case = probe_case(cells, dtype, device, seed)
    out(f"K12 phase ablations: {cells}^3 cells, {case.op.cells.n_cells} cells, "
        f"{3 * case.u.shape[1] + case.p.shape[0]} dofs, {str(dtype)[6:]}, {case.u.device}")
    results = run_variants(case, cm.K12_VARIANTS, reps, out)
    full = results["full"]["ms"]
    out("phase attribution (full - ablated):")
    for name, r in results.items():
        if name.startswith("minus_"):
            r["attribution_ms"] = full - r["ms"]
            out(f"  {name[6:]:10s} {full - r['ms']:8.4f} ms")
    return results


def main(argv=None) -> None:
    args = parse_args(__doc__.split("\n\n")[0], argv if argv is not None else sys.argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    run(args.cells, args.reps, getattr(torch, args.dtype), args.device, args.seed)


if __name__ == "__main__":
    main()
