"""Bounds of the contraction-rate and matrix-unit probes (K5, K7-K10).

Each bound is the least time an NVIDIA H100 SXM at its 700 W limit could take
for the work of the JAX probe kernel at a given configuration: its bytes
once over the HBM rate against its operations over the peak rate it runs at
(adaflo_tpu_torch.scripts.PEAK_FLOPS, HBM_BYTES_PER_S). The probe drivers
(probe_sf.py, probe_mxu.py) and chip_smoke.py compute the bound of every
configuration they time from these functions. The probes:

  K5  scripts/probe_mxu.py:93  (384, 96) @ (96, E) streamed dot
  K7  scripts/probe_sf.py:83   n_ops three-term row statements on
                               (24, block) row slices, nblk grid steps
  K8  scripts/probe_sf.py:142  n_rows shifted (1, block) row copies per step
  K9  scripts/probe_sf.py:169  (m, k) @ (k, block) per step, nblk steps
  K10 scripts/probe_sf.py:295  the three-stage sum-factorized evaluation

K7-K10 rerun one resident block at every grid step, so their bytes are the
block in and the block out once (K8: the parts of the slab its copies read);
their operations are every step's. K8 and K10 keep their tiles in shared
memory across the steps, and each step moves its operands and outputs
through it: beside the bound, their on-chip floor is those bytes over the
shared memory's 128 bytes a clock on each of 132 SMs at the card's maximum
SM clock (onchip_floor_ms).
Rates: K7 and K10 are elementwise row statements, which the tensor cores
cannot run, so their float64 rate is the CUDA cores' ("float64_simt"); the
dot's float64 runs on the tensor cores (DMMA, "float64"), its "f32" on the
CUDA cores, "tf32" and "bf16" on the tensor cores.

Run: python -m adaflo_tpu_torch.scripts.probe_bounds
"""

from __future__ import annotations

import subprocess

from adaflo_tpu_torch.ops.probe_kernels import copy_table
from adaflo_tpu_torch.scripts import roofline

DOT_RATE = {"f32": "float32", "tf32": "tf32", "bf16": "bf16", "f64": "float64"}
SIMT_RATE = {"float32": "float32", "float64": "float64_simt"}
SIZE = {"float32": 4, "float64": 8}
SMEM_BYTES_PER_CLOCK, SMS = 128, 132  # an H100 SM's shared memory a clock; its SMs


def _bound(nbytes: float, flops: float, rate: str) -> dict:
    return dict(roofline(nbytes, flops, rate), rate=rate)


def k7_bound(block: int, nblk: int, n_ops: int, dtype: str = "float32") -> dict:
    """K7: read the (96, block + 128) input, write the (24, block) sum; per
    output element and step 3 multiplies and 2 adds per statement and one
    add per statement after the first."""
    s = SIZE[dtype]
    nbytes = (96 * (block + 128) + 24 * block) * s
    return _bound(nbytes, (6 * n_ops - 1) * 24 * block * nblk, SIMT_RATE[dtype])


def k8_read_elements(block: int, n_rows: int) -> int:
    """Slab elements K8's copies read: on each source row, the union of the
    spans [off, off + block) of its entries in copy_table(n_rows)."""
    offsets: dict = {}
    for row, off in copy_table(n_rows):
        offsets.setdefault(row, []).append(off)
    total = 0
    for offs in offsets.values():
        end = 0  # end of the spans counted so far on this row
        for off in sorted(offs):
            total += max(0, off + block - max(off, end))
            end = max(end, off + block)
    return total


def k8_bound(block: int, nblk: int, n_rows: int, dtype: str = "float32") -> dict:
    """K8: read the slab elements the copies use (k8_read_elements), write
    the (n_rows, block) rows."""
    s = SIZE[dtype]
    return _bound((k8_read_elements(block, n_rows) + n_rows * block) * s, 0, SIMT_RATE[dtype])


def onchip_floor_ms(smem_bytes: float, clock_mhz: float) -> float:
    """The least time to move `smem_bytes` through the shared memory of an
    H100's SMS SMs at SMEM_BYTES_PER_CLOCK each (32 banks of 4 bytes) and
    the SM clock `clock_mhz` (sm_clock_mhz)."""
    return smem_bytes / (SMEM_BYTES_PER_CLOCK * SMS * clock_mhz * 1e6) * 1e3


def sm_clock_mhz() -> float:
    """The card's maximum SM clock in MHz, as nvidia-smi reports it
    (clocks.max.sm; the card's machine only)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def k8_smem_bytes(block: int, nblk: int, n_rows: int, dtype: str = "float32") -> int:
    """Shared-memory bytes of K8's resident steps: one load from the slab
    tile and one store into the output tile per copied element and step
    (csrc/probe_kernels.cu row_copies_kernel)."""
    return 2 * n_rows * block * nblk * SIZE[dtype]


def k10_smem_bytes(block: int, nblk: int, dtype: str = "float32") -> int:
    """Shared-memory bytes of K10's resident steps: per column and step, 9
    work items (c, qz) each loading 27 slab values and storing 36 q rows
    (csrc/probe_kernels.cu sf_eval_kernel)."""
    return 9 * (27 + 36) * block * nblk * SIZE[dtype]


def k9_bound(block: int, nblk: int, m: int, k: int, precision: str = "f32") -> dict:
    """K9: read A (m, k) and x (k, block), float32 (float64 for "f64"; bf16
    rounds them in the kernel), write the (m, block) product; 2 m k
    operations per column and step."""
    s = 8 if precision == "f64" else 4
    nbytes = (m * k + k * block + m * block) * s
    return _bound(nbytes, 2 * m * k * block * nblk, DOT_RATE[precision])


def k5_bound(cols: int, precision: str = "f32") -> dict:
    """K5: read A (384, 96) and X (96, cols), write the (384, cols) product,
    all in the precision's type (bf16 for "bf16")."""
    s = {"f32": 4, "tf32": 4, "bf16": 2, "f64": 8}[precision]
    m, k = 384, 96
    return _bound((m * k + k * cols + m * cols) * s, 2 * m * k * cols, DOT_RATE[precision])


def k10_elements_per_step(block: int) -> int:
    """Elements the JAX kernel's statements write per grid step: stage z 18
    statements of (4, block + 64), stage y 81 of (2, block + 8), stage x 324
    of (1, block)."""
    return 18 * 4 * (block + 64) + 81 * 2 * (block + 8) + 324 * block


def k10_bound(block: int, nblk: int, dtype: str = "float32") -> dict:
    """K10: read the (32, block + 2560) slab, write the (384, block) q rows;
    5 operations (3 multiplies, 2 adds) per written element."""
    s = SIZE[dtype]
    nbytes = (32 * (block + 2560) + 384 * block) * s
    return _bound(nbytes, 5 * k10_elements_per_step(block) * nblk, SIMT_RATE[dtype])


def bounds() -> dict:
    """The bounds at the scripts' defaults: block 4096, 29 steps (K10: block
    2048, 58 steps), K7 at 72 statements, K8 at 89 rows, K9 (384, 96),
    K5 E = 110592."""
    out = {f"K5 {p}": k5_bound(110592, p) for p in DOT_RATE}
    for dtype in ("float32", "float64"):
        out[f"K7 {dtype}"] = k7_bound(4096, 29, 72, dtype)
        out[f"K8 {dtype}"] = k8_bound(4096, 29, 89, dtype)
        out[f"K10 {dtype}"] = k10_bound(2048, 58, dtype)
    out |= {f"K9 {p}": k9_bound(4096, 29, 384, 96, p) for p in DOT_RATE}
    return out


def main() -> None:
    for name, b in bounds().items():
        print(f"{name:12s} bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
              f"{b['bytes'] / 1e6:.2f} MB, {b['flops'] / 1e9:.3f} GFLOP at the "
              f"{b['rate']} rate), computed, not measured")


if __name__ == "__main__":
    main()
