"""Computed bounds of the probe kernels still to be ported (K5, K7-K10).

Nothing runs on a device here: each bound is the least time an NVIDIA H100
SXM at its 700 W limit could take for the work of the JAX probe kernel at
the shapes in its script (its bytes once over the HBM rate against its
operations over the peak rate of the number type, both from
adaflo_tpu_torch.scripts.PEAK_FLOPS and HBM_BYTES_PER_S), for the slices
that port them. The probes:

  K5  scripts/probe_mxu.py:98   pall: (384, 96) @ (96, 110592) blocked dot
  K7  scripts/probe_sf.py:83    run_vpu: 72 three-term FMA row-block ops on
                                (24, 4096) blocks, 29 grid steps
  K8  scripts/probe_sf.py:142   run_copies: 89 shifted (1, 4096) row
                                copies per step, 29 steps
  K9  scripts/probe_sf.py:169   run_mxu: (384, 96) @ (96, 4096) per step,
                                29 steps
  K10 scripts/probe_sf.py:295   run_sfeval: the 3-stage sum-factorized
                                evaluation, block 2048, 58 steps

K7-K10 rerun one resident block at every grid step, so their bytes are the
block in and the block out once.

Run: python -m adaflo_tpu_torch.scripts.probe_bounds
"""

from __future__ import annotations

from adaflo_tpu_torch.scripts import roofline


def _bound(nbytes: float, flops: float, rate: str) -> dict:
    return dict(roofline(nbytes, flops, rate), rate=rate)


def bounds() -> dict:
    out = {}
    E = 110592
    for rate, s in (("float32", 4), ("tf32", 4), ("bf16", 2)):
        nbytes = (384 * 96 + 96 * E + 384 * E) * s
        out[f"K5 {rate}"] = _bound(nbytes, 2 * 384 * 96 * E, rate)
    block, nblk, rows, n_ops = 4096, 29, 24, 72
    # 0.31 a + 0.47 b + 0.22 c, added into the sum: 3 multiplies, 3 adds
    out["K7"] = _bound((96 * (block + 128) + rows * block) * 4,
                       n_ops * rows * block * 6 * nblk, "float32")
    out["K8"] = _bound((32 * (block + 2560) + 89 * block) * 4, 0, "float32")
    out["K9"] = _bound((384 * 96 + 96 * block + 384 * block) * 4,
                       2 * 384 * 96 * block * nblk, "float32")
    b2, n2 = 2048, 2 * nblk
    w1, w2 = b2 + 64, b2 + 8
    per_step = 5 * (18 * 3 * 4 * w1 + 27 * 3 * 2 * w2 + 27 * 4 * 3 * b2)
    out["K10"] = _bound((32 * (b2 + 2560) + 32 * b2) * 4, per_step * n2, "float32")
    return out


def main() -> None:
    for name, b in bounds().items():
        print(f"{name:8s} bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
              f"{b['bytes'] / 1e6:.2f} MB, {b['flops'] / 1e9:.3f} GFLOP at the "
              f"{b['rate']} rate), computed, not measured")


if __name__ == "__main__":
    main()
