"""Wall-time tracking and statistics reporting.

Counterpart of deal.II TimerOutput as used by the reference (timer sections
around every solver phase, navier_stokes.cc:567 etc.) plus the per-component
statistics block printed under `output memory` / verbosity 3
(navier_stokes.cc:1081-1154). Single-process: min = avg = max.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from contextlib import contextmanager

import torch


def profiler_range(fn):
    """Run the method `fn` inside a torch.profiler range named
    "layer <Class.method>", so that a profile of a time step
    (utils/profile_step.py) shows each layer's host and device time. When no
    profiler runs, the range is one call into the profiler's record hook."""
    name = f"layer {fn.__qualname__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapper


class TimerOutput:
    def __init__(self) -> None:
        self.sections: dict[str, list] = defaultdict(lambda: [0, 0.0])
        self._t0 = time.perf_counter()

    @contextmanager
    def section(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            rec = self.sections[name]
            rec[0] += 1
            rec[1] += time.perf_counter() - t

    def enter(self, name: str):
        return self.section(name)

    def summary(self, out=None) -> str:
        total = time.perf_counter() - self._t0
        lines = [
            "+---------------------------------------------+------------+------------+",
            f"| Total wallclock time elapsed since start    | {total:9.3g}s |            |",
            "|                                             |            |            |",
            "| Section                         | no. calls |  wall time | % of total |",
            "+---------------------------------+-----------+------------+------------+",
        ]
        for name in sorted(self.sections):
            calls, t = self.sections[name]
            pct = 100.0 * t / total if total > 0 else 0.0
            lines.append(
                f"| {name:<31s} | {calls:9d} | {t:9.3g}s | {pct:9.3g}% |"
            )
        lines.append(
            "+---------------------------------+-----------+------------+------------+"
        )
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text


class Statistics:
    """Per-component call/time counters printed as the reference's
    '-- Statistics --' block every 10 steps under output_memory
    (navier_stokes.cc:1081-1154); stripped from golden comparisons."""

    def __init__(self) -> None:
        self.counters: dict[str, list] = defaultdict(lambda: [0, 0.0])

    def add(self, name: str, seconds: float, calls: int = 1) -> None:
        rec = self.counters[name]
        rec[0] += calls
        rec[1] += seconds

    def print_block(self, out=None) -> None:
        import sys

        out = out or sys.stdout
        print(
            "-- Statistics --                    min      avg      max avg/call",
            file=out,
        )
        try:
            import resource

            mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
            print(
                f"-- Statistics -- memory [MB] : {mb:8.4g} {mb:8.4g} {mb:8.4g}",
                file=out,
            )
        except Exception:
            pass
        for name, (calls, t) in self.counters.items():
            avg = t / calls if calls else 0.0
            print(
                f"-- Statistics -- {name:<12s}: {t:8.3g} {t:8.3g} {t:8.3g} "
                f"{avg:8.3g}",
                file=out,
            )
        for rec in self.counters.values():
            rec[0] = 0
            rec[1] = 0.0


def print_wall_times(parameters, problem, out=None) -> None:
    """End-of-run wall-time summary, printed when `output wall times` is
    set — the reference's TimerOutput::summary destructor output
    (navier_stokes.cc:133-136, two_phase_base.cc:80-84). The timer lives on
    the NS solver; two-phase problems reach it through .solver."""
    if not getattr(parameters, "output_wall_times", False):
        return
    ns = getattr(problem, "navier_stokes", None)
    if ns is None:
        solver = getattr(problem, "solver", None)
        if solver is not None:
            ns = getattr(solver, "navier_stokes", solver)
    timer = getattr(ns, "timer", None)
    if timer is not None:
        import sys

        timer.summary(out or getattr(problem, "out", None) or sys.stdout)
