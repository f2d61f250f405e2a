"""K6: the cell-block scatter alone, and K3 and K4 alone.

Counterpart of ``scripts/probe_pr.py``, which times the TPU's cell-block
kernel (k_t), its in-kernel-gather kernel (k_pi) and a prototype
ring-accumulator scatter (``scatter_ring_kernel``) on their own. Here:

  K3  coupled_apply_cells on a pre-gathered (E, 89) block and u* dof stream
  K4  coupled_apply_gather on the nodal vectors, (E, 89) block out
  K6  scatter_cells: the (E, 89) block added into the nodal velocity and
      pressure through the int32 cell tables with atomicAdd, beside one
      Tensor.index_add_ over the flattened table (the library call that
      computes the same function) and the port's lattice scatter
      (LatticeOps.scatter_add, the K3 route's), which are timed only

Each kernel is held against its plain version; times are CUDA events
(time_rounds), the calls issued back to back and one waited call, with the
bytes each must move.

Run: python -m adaflo_tpu_torch.scripts.probe_pr [--cells 48] [--reps 20]
[--dtype float64|float32] [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.scripts import (
    joint_err,
    parse_args,
    probe_case,
    scatter_bound,
    sync,
    time_ms,
    time_rounds,
)


def run(cells: int = 48, reps: int = 20, dtype=torch.float64, device=None,
        seed: int = 0, out=print) -> dict:
    case = probe_case(cells, dtype, device, seed)
    op, u, p, sc = case.op, case.u, case.p, case.sc
    cl, dev = op.cells, u.device
    E, nl, npl = cl.n_cells, cl.ev_u.n_local, cl.ev_p.n_local
    n_u, n_p = u.shape[1], p.shape[0]
    s_b = torch.finfo(dtype).bits // 8
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    x = torch.randn((E, 3 * nl + npl), generator=gen, dtype=dtype).to(dev)
    stream = torch.randn((E, 3 * nl), generator=gen, dtype=dtype).to(dev)
    y = torch.randn((E, 3 * nl + npl), generator=gen, dtype=dtype).to(dev)
    out(f"K6 scatter, K3 and K4 alone: {cells}^3 cells, {3 * n_u + n_p} dofs, "
        f"{str(dtype)[6:]}, {dev}")

    def report(name, nbytes, extra=""):
        t = ms[name]
        out(f"{name:13s} {t['ms']:8.4f} ms ({dev.type}), one waited call {t['call_ms']:.4f} ms, "
            f"{nbytes / (t['ms'] * 1e-3) / 1e9:7.1f} GB/s{extra}")

    out_u, out_p = torch.zeros_like(u), torch.zeros_like(p)
    cu, cp = cl.cell_u.long(), cl.cell_p.long()
    # the library call: one index_add_ over the flattened table into the
    # flat [u_0 | u_1 | u_2 | p] vector
    flat_idx = torch.cat([c * n_u + cu for c in range(3)] + [3 * n_u + cp], dim=1).reshape(-1)
    flat = torch.zeros(3 * n_u + n_p, dtype=dtype, device=dev)
    lat_u, lat_p = op.lat_u, op.lat_p

    def lattice():
        return [lat_u.scatter_add(y[:, c * nl : (c + 1) * nl]) for c in range(3)] + [
            lat_p.scatter_add(y[:, 3 * nl :])
        ]

    # each callable against its plain version (the library call and the
    # lattice scatter against K6's)
    ref6 = cm.scatter_cells_plain(y, cl, torch.zeros_like(u), torch.zeros_like(p))
    ref6_flat = torch.cat([ref6[0].reshape(-1), ref6[1]])
    # K6 and index_add_ add y into their outputs at every call
    runs = {
        "k_t": lambda: cm.coupled_apply_cells(x, stream, cl, sc),
        "k_pi": lambda: cm.coupled_apply_gather(u, p, u, cl, sc),
        "scatter_cells": lambda: cm.scatter_cells(y, cl, out_u, out_p),
        "index_add_": lambda: flat.index_add_(0, flat_idx, y.reshape(-1)),
        "lattice": lattice,
    }
    checks = {
        "k_t": ([runs["k_t"]()], [cm.coupled_apply_cells_plain(x, stream, cl, sc)]),
        "k_pi": ([runs["k_pi"]()], [cm.coupled_apply_gather_plain(u, p, u, cl, sc)]),
        "scatter_cells": (
            cm.scatter_cells(y, cl, torch.zeros_like(u), torch.zeros_like(p)), ref6
        ),
        "index_add_": ([torch.zeros_like(flat).index_add_(0, flat_idx, y.reshape(-1))],
                       [ref6_flat]),
        "lattice": ([torch.cat([t.reshape(-1) for t in lattice()])], [ref6_flat]),
    }
    sync(dev)
    errs = {name: joint_err(*pair) for name, pair in checks.items()}
    del checks
    ms = time_rounds(runs, dev, reps)
    plain_ms = time_ms(lambda: cm.scatter_cells_plain(y, cl, out_u, out_p), dev,
                       max(3, reps // 4), warmup=1)["ms"]
    b = scatter_bound(cl, n_u, n_p, dtype)
    results = {
        name: dict(**ms[name], max_abs_err=errs[name][0], rel_err=errs[name][1])
        for name in ("k_t", "k_pi")
    }
    results["scatter_cells"] = dict(
        **ms["scatter_cells"], plain_ms=plain_ms, library_ms=ms["index_add_"]["ms"],
        lattice_ms=ms["lattice"]["ms"], max_abs_err=errs["scatter_cells"][0],
        rel_err=errs["scatter_cells"][1], **b,
    )
    out("k_t: K3 coupled_apply_cells, (E,89) in/out; k_pi: K4 coupled_apply_gather, "
        "(E,89) out; scatter_cells: K6 (E,89) -> nodal, beside index_add_ over the "
        "flattened table and the lattice scatter (LatticeOps.scatter_add, the K3 route's)")
    report("k_t", (2 * x.numel() + stream.numel()) * s_b, f", err {errs['k_t'][1]:.2e}")
    report("k_pi", (7 * n_u + n_p) * s_b + E * (nl + npl) * 4 + x.numel() * s_b,
           f", err {errs['k_pi'][1]:.2e}")
    report("scatter_cells", b["bytes"],
           f", plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
           f"err {errs['scatter_cells'][1]:.2e}")
    report("index_add_", b["bytes"], f", err {errs['index_add_'][1]:.2e}")
    report("lattice", b["bytes"], f", err {errs['lattice'][1]:.2e}")
    return results


def main(argv=None) -> None:
    args = parse_args(__doc__.split("\n\n")[0], argv if argv is not None else sys.argv[1:])
    run(args.cells, args.reps, getattr(torch, args.dtype), args.device, args.seed)


if __name__ == "__main__":
    main()
