"""K6's design choices measured side by side on the card.

K6 (``scatter_cells``, ``scatter_tiles_kernel`` in csrc/coupled_matvec.cu)
sums a tile of cells in shared memory in eight parity passes, reads the old
value of each node of one tile alone at the start (cp.async) and adds the
nodes where tiles meet with global atomics. This script builds the source
as it stands ("tiled") and text variants of it, each the same kernel with
one choice undone, and times each at the probes' box:

  shared_atomics  the adds into the tile by shared-memory atomics, no
                  barrier between the passes;
  all_atomic      every node of the tile added by a global atomic (no plain
                  read-add-write, nothing read at the start);
  tile_8x4x2      a tile of 8 x 4 x 2 cells (twice the tiles, more faces);
  no_loads        (ablation, wrong result) the passes without the block's
                  loads: what the passes cost without device memory;
  no_passes       (ablation, wrong result) the start and the write-out
                  alone.

Each variant's library is built by its own nvcc run (all started together)
and timed in two rounds, the second in reverse order (time_scatter: a CUDA
graph of 20 calls, the device time, and 20 calls back to back, float64 and
float32, with its error against scatter_cells_plain and its resident blocks
per SM).

``--checkout DIR`` instead times K6 of the package in another checkout of
the repository (a parent commit unpacked with ``git archive``) in a process
of its own, in the same way, so that two commits can be compared in turn
(parent, change, change, parent) in one session on one card.

Run: python -m adaflo_tpu_torch.scripts.scatter_variants [--cells 48]
[--checkout DIR]   (needs a CUDA device)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "adaflo_tpu_torch" / "csrc" / "coupled_matvec.cu"
VARIANTS = {
    "tiled": [],
    "shared_atomics": [
        ("if (sv[q] >= 0) acc[sv[q]] += v[q];", "if (sv[q] >= 0) atomicAdd(acc + sv[q], v[q]);"),
        ("    if ((s + 1) % per_pass == 0) __syncthreads();\n", ""),
        ("  // each node of the tile into the nodal output once",
         "  __syncthreads();\n  // each node of the tile into the nodal output once"),
    ],
    "all_atomic": [
        ("dst[i] = inside ? (shared ? -(node + 1) : node + 1) : 0;",
         "dst[i] = inside ? -(node + 1) : 0;"),
        ("const bool plain = inside && !shared;", "const bool plain = false;"),
    ],
    "tile_8x4x2": [("constexpr int kScatterTX = 8, kScatterTY = 4, kScatterTZ = 4;",
                    "constexpr int kScatterTX = 8, kScatterTY = 4, kScatterTZ = 2;")],
    "no_loads": [("      v[q] = block[e * 89 + k];", "      v[q] = T(k);")],
    "no_passes": [("  for (int s = 0; s < 8 * per_pass; ++s) {",
                   "  for (int s = 0; s < 0 * per_pass; ++s) {")],
}
ABLATIONS = ("no_loads", "no_passes")


def variant_source(name: str) -> str:
    """The K6 source with the substitutions of VARIANTS[name]; each must
    apply exactly once."""
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is not in the source once")
        text = text.replace(old, new)
    return text


def time_scatter(cm, cells: int, device) -> dict:
    """K6 of the loaded library `cm` (ops/coupled_matvec) at the probes'
    box of cells^3 cells (scripts.probe_case, a random (E, 89) block added
    into random nonzero nodal vectors), float64 and float32: graph_ms (one
    CUDA graph of 20 calls, scripts.per_step, median of 5 waited replays,
    per call), ms (20 calls back to back, scripts.time_ms), its error
    against scatter_cells_plain and its resident blocks per SM. Uses only
    what the probes' helpers had before K6's tiles, so that it runs in an
    older checkout too."""
    from adaflo_tpu_torch.scripts import joint_err, per_step, probe_case, time_ms

    out = {}
    for dtype in (torch.float64, torch.float32):
        case = probe_case(cells, dtype, device, 0)
        cl, u, p, dev = case.op.cells, case.u, case.p, case.u.device
        gen = torch.Generator().manual_seed(1)
        block = torch.randn((cl.n_cells, 89), generator=gen, dtype=dtype).to(dev)
        got = cm.scatter_cells(block, cl, u.clone(), p.clone())
        ref = cm.scatter_cells_plain(block, cl, u.clone(), p.clone())
        fn = lambda: cm.scatter_cells(block, cl, u, p)
        graph = time_ms(per_step(fn, 20, dev), dev, 5, warmup=1)["call_ms"] / 20
        plan = (cm.scatter_plan(dtype, (cells,) * 3)["blocks_per_sm"]
                if dev.type == "cuda" and hasattr(cm, "scatter_plan") else None)
        out[str(dtype)[6:]] = dict(graph_ms=graph, ms=time_ms(fn, dev, 20)["ms"],
                                   rel_err=joint_err(got, ref)[1], blocks_per_sm=plan)
        del case, cl, u, p, block, got, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run_variants(cells: int, out=print) -> dict:
    """Build every variant (one nvcc each, together) and time each in two
    rounds, the second in reverse order. {variant: {dtype: [record, ...]}}."""
    from adaflo_tpu_torch.ops import coupled_matvec as cm
    from adaflo_tpu_torch.ops.build import BUILD_DIR, build_library

    work = BUILD_DIR / "scatter_variants"
    work.mkdir(parents=True, exist_ok=True)
    (work / "hopper.cuh").write_text((SOURCE.parent / "hopper.cuh").read_text())
    for name in VARIANTS:
        (work / f"k6_{name}.cu").write_text(variant_source(name))
    infos = {name: {} for name in VARIANTS}
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        futures = {name: ex.submit(build_library, work / f"k6_{name}.cu", f"k6_{name}",
                                   infos[name]) for name in VARIANTS}
        libs = {name: f.result() for name, f in futures.items()}
    device = torch.device("cuda", 0)
    res = {}
    for order in (list(VARIANTS), list(reversed(VARIANTS))):
        for name in order:
            cm._lib = cm.bind(ctypes.CDLL(str(libs[name])))
            for dname, r in time_scatter(cm, cells, device).items():
                res.setdefault(name, {}).setdefault(dname, []).append(r)
                out(f"K6 {name} {cells}^3 {dname}: graph {r['graph_ms']:.4f} ms, back to back "
                    f"{r['ms']:.4f} ms, rel err {r['rel_err']:.2e}"
                    f"{' (ablation)' if name in ABLATIONS else ''}, {r['blocks_per_sm']} blocks/SM")
    cm._lib = None
    return res


def time_checkout(root: Path, cells: int) -> dict:
    """K6 of the package in the checkout `root`, timed in a process of its
    own (time_scatter); the package there builds its own library."""
    code = (
        "import importlib.util, json, sys, torch\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from adaflo_tpu_torch.ops import coupled_matvec as cm\n"
        "assert cm.__file__.startswith(sys.path[0]), cm.__file__\n"
        f"spec = importlib.util.spec_from_file_location('k6_timer', {__file__!r})\n"
        "sv = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(sv)\n"
        f"print('K6TIME ' + json.dumps(sv.time_scatter(cm, {cells}, torch.device('cuda', 0))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True, cwd=str(root))
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("K6TIME "))
    return json.loads(line[len("K6TIME "):])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=48, help="cells per axis (default 48)")
    ap.add_argument("--checkout", type=Path, default=None,
                    help="time K6 of the package in this checkout instead of the variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("scatter_variants times kernels on a CUDA device")
    if args.checkout is not None:
        res = time_checkout(args.checkout.resolve(), args.cells)
        print(f"K6 of {args.checkout} at {args.cells}^3: " + json.dumps(res), flush=True)
        return
    res = run_variants(args.cells)
    print("K6 variants: " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
