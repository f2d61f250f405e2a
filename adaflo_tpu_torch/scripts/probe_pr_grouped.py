"""K11: the coupled apply with addresses from lattice coordinates.

Counterpart of ``scripts/probe_pr_grouped.py`` (``make_kernel_grouped``: the
resident apply with its 89 single-row copies replaced by 8 slab slices, one
per anchor-corner offset). On the card the gather's cost is the per-dof
int32 cell table and the uncoalesced reads; K11 (``coupled_apply_lattice``)
is the same apply as K1 (``coupled_apply``, constant coefficients, identity
rows) with a source that reads no table: each dof's address comes from the
cell's lattice coordinates, and consecutive threads read one local dof of
consecutive cells. It serves the uniform, non-periodic lattice. Both are
held against the plain version and timed with CUDA events.

Run: python -m adaflo_tpu_torch.scripts.probe_pr_grouped [--cells 48]
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


def run(cells: int = 48, reps: int = 20, dtype=torch.float64, device=None,
        seed: int = 0, out=print) -> dict:
    case = probe_case(cells, dtype, device, seed)
    op, u, p, sc = case.op, case.u, case.p, case.sc
    cl, dev = op.cells, u.device
    out(f"K11 table-free apply: {cells}^3 cells, {3 * u.shape[1] + p.shape[0]} dofs, "
        f"{str(dtype)[6:]}, {dev}")
    plain = lambda: cm.coupled_apply_plain(u, p, u, cl, sc)
    ref = plain()
    plain_ms = time_ms(plain, dev, 3, warmup=1)["ms"]
    runs = {
        "production": lambda: cm.coupled_apply(u, p, u, cl, sc),
        "lattice": lambda: cm.coupled_apply_lattice(u, p, u, cl, sc),
    }
    results = {}
    for name, fn in runs.items():
        got = fn()
        sync(dev)
        max_abs, rel = joint_err(got, ref)
        del got
        b = variant_bound("full" if name == "production" else name, cl, u.shape[1],
                          p.shape[0], dtype)
        results[name] = dict(plain_ms=plain_ms, max_abs_err=max_abs, rel_err=rel, **b)
    for name, t in time_rounds(runs, dev, reps).items():
        r = results[name]
        r.update(t)
        out(f"{name:12s} {r['ms']:8.4f} ms/apply ({dev.type}), one waited call "
            f"{r['call_ms']:.4f} ms, plain {plain_ms:8.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB), "
            f"err {r['rel_err']:.2e}")
    k1, k11 = cm.coupled_apply(u, p, u, cl, sc), cm.coupled_apply_lattice(u, p, u, cl, sc)
    out(f"lattice rel err vs production: {joint_err(k11, k1)[1]:.2e}")
    return results


def main(argv=None) -> None:
    args = parse_args(__doc__.split("\n\n")[0], argv if argv is not None else sys.argv[1:])
    run(args.cells, args.reps, getattr(torch, args.dtype), args.device, args.seed)


if __name__ == "__main__":
    main()
