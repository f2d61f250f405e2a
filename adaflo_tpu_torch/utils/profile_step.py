"""Profile one time step of the port's Beltrami driver on the CUDA device.

Runs the first four time steps of a prm file, the fourth under
torch.profiler (steps 1-2 of beltrami_3d build the preconditioner; steps
3-4 are the Newton and Krylov iterations alone), then prints: the card's
name and power limit (nvidia-smi); each step's wall time and iteration
counts; for the profiled step, the device's busy share of its wall time and
its device operations; the kernels with the most device time; and each
layer's host and device time, from the ranges of utils/timer.profiler_range
(a range includes the ranges nested in it). Summing the profile of a step
of beltrami_3d (about 500k events) takes minutes of host time after the
step.

Usage: python -m adaflo_tpu_torch.utils.profile_step [prm]
"""

from __future__ import annotations

import argparse
import io
import subprocess
import sys
import time

STEPS = 4  # the last of them is profiled
TOP = 15  # kernels listed by device time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paramfile", nargs="?", default="tests/prms/beltrami_3d.prm")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adaflo_tpu_torch.drivers.beltrami import BeltramiProblem
    from adaflo_tpu_torch.parameters import FlowParameters

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    par = FlowParameters.from_file(args.paramfile)
    problem = BeltramiProblem(par, out=io.StringIO())
    problem.setup()
    problem.output_results()
    for k in range(1, STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if k < STEPS:
            nl, lin = problem.step()
            torch.cuda.synchronize()
            print(f"step {k}: {time.perf_counter() - t0:.3f} s, Newton {nl}, "
                  f"Krylov {lin}", flush=True)
            continue
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            nl, lin = problem.step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = prof.key_averages()
    print(f"profile: summed in {time.perf_counter() - t0:.1f} s", flush=True)

    device = [
        e for e in events
        if e.device_type == DeviceType.CUDA and not e.key.startswith("layer ")
    ]
    busy_us = sum(e.self_device_time_total for e in device)
    print(
        f"profile: step {STEPS} {wall:.3f} s under the profiler, Newton {nl}, "
        f"Krylov {lin}, device busy {busy_us / 1e6:.4f} s "
        f"({100 * busy_us / 1e6 / wall:.3f} % of the step), "
        f"{sum(e.count for e in device)} device operations", flush=True,
    )
    for e in sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:TOP]:
        print(f"profile: {e.self_device_time_total / 1e3:10.3f} ms device, "
              f"{e.count:7d} launches  {e.key[:100]}", flush=True)
    layers = [
        e for e in events
        if e.key.startswith("layer ") and e.device_type == DeviceType.CPU
    ]
    for e in sorted(layers, key=lambda e: e.cpu_time_total, reverse=True):
        print(f"profile: {e.cpu_time_total / 1e3:10.3f} ms host, {e.count:6d} calls, "
              f"{e.device_time_total / 1e3:10.3f} ms device  {e.key}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
