"""K13: whole-apply ablations of the coupled cell apply.

Counterpart of ``scripts/probe_pr_parts.py`` (``make_kernel``, stripped
copies of the resident apply). Each variant is an instance of the cell
kernel (``csrc/coupled_matvec.cu``) with a compile-time phase mask:

  datapath   gather, mask and scatter only: out = sum_c G_c^T G_c x
  noshift    the same with each cell reading its 89 values at contiguous
             addresses (cell e, local l -> e n_loc + l) in place of the table:
             the price of the uncoalesced gather
  mdot       datapath + the dense per-cell product M89 x (dense cell matrices
             against sum factorization)
  evdots     datapath + the evaluation of u and u* at the q points
  full       the production apply
  noscatter  full with a plain store of each cell's owned dofs in place of
             the atomic scatter (K12's minus_scatter)

and the full apply under the TPU probe's three schedules of the gather
against the compute (make_kernel_rowdma, make_kernel_pipe,
make_kernel_unroll2), each an instance of the cell kernel with a
compile-time schedule on a persistent grid (as many blocks as fit resident,
each looping over groups of cells), its gather of the next group in flight
while the current group computes:

  rowdma     one 4- or 8-byte cp.async per dof, at the cell table's address,
             into the other slot of a double-buffered staging area of the
             gathered dofs (constrained entries zero-filled); the first
             evaluation stage reads this group's slot in place
  pipe       1D bulk copies (TMA, cp.async.bulk) of the lattice x-runs the
             next group reads, 16-byte aligned, completing on an mbarrier;
             then assembled, masks applied, into the one work area
  unroll2    two groups per iteration, each in its own work area, one's
             cp.async gather in flight while the other computes

All three run the one-shot body's gather and compute stages.

Each variant is held against its plain version (a schedule's output is
full's, so it is held against full's) and timed with CUDA events.

Run: python -m adaflo_tpu_torch.scripts.probe_pr_parts [--cells 48]
[--reps 20] [--dtype float64|float32] [--device cpu]
[--variants datapath,noshift,...,rowdma,pipe,unroll2]
"""

from __future__ import annotations

import sys

import torch

from adaflo_tpu_torch.ops import coupled_matvec as cm
from adaflo_tpu_torch.scripts import parse_args, probe_case
from adaflo_tpu_torch.scripts.probe_pr_phases import run_variants


VARIANTS = tuple(cm.K13_VARIANTS) + tuple(cm.K13_SCHEDULES)


def run(cells: int = 48, reps: int = 20, dtype=torch.float64, device=None,
        seed: int = 0, variants=VARIANTS, out=print) -> dict:
    for name in variants:
        if name not in VARIANTS:
            raise ValueError(f"unknown K13 variant {name!r}: one of {list(VARIANTS)}")
    case = probe_case(cells, dtype, device, seed)
    out(f"K13 apply ablations and schedules: {cells}^3 cells, "
        f"{3 * case.u.shape[1] + case.p.shape[0]} dofs, {str(dtype)[6:]}, {case.u.device}")
    return run_variants(case, variants, reps, out)


def main(argv=None) -> None:
    def extra(ap):
        ap.add_argument("--variants", default=",".join(VARIANTS))

    args = parse_args(__doc__.split("\n\n")[0], argv if argv is not None else sys.argv[1:],
                      extra)
    torch.backends.cuda.matmul.allow_tf32 = False
    run(args.cells, args.reps, getattr(torch, args.dtype), args.device, args.seed,
        tuple(args.variants.split(",")))


if __name__ == "__main__":
    main()
