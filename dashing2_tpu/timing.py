"""Phase timing / progress observability.

Reference parity: wall-clock spans printed to stderr around index build,
refinement, and emission (src/index_build.cpp:70-163, src/refine.cpp:18-80,
src/emitnn.cpp:13-51), the comparisons/sec counter (COUNT_COMPARE_CALLS,
src/d2.h:19 + cmp_core.cpp:327-329,806-808), and -v verbosity gating
(src/enums.h:106-111). Here: a `phase` context manager and a global
comparison counter, both gated on the options' verbosity.
"""

from __future__ import annotations

import contextlib
import sys
import time


class CompareCounter:
    """Global pair-comparison tally (COUNT_COMPARE_CALLS equivalent)."""

    def __init__(self) -> None:
        self.count = 0
        self.t0 = time.perf_counter()

    def add(self, n: int) -> None:
        self.count += int(n)

    def report(self, file=sys.stderr) -> None:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        print(f"#dashing2-tpu: {self.count} comparisons in {dt:.3f}s "
              f"({self.count / dt:.3e} pairs/s)", file=file)


compare_counter = CompareCounter()


@contextlib.contextmanager
def phase(name: str, verbosity: int = 0, min_level: int = 1):
    """Time a pipeline phase; prints to stderr when verbosity >= min_level
    (repeated -v raises it, options.h:364). Always records into the
    span accumulator (below) so harnesses can read the breakdown."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        add_span(name, dt)
        if verbosity >= min_level:
            print(f"#dashing2-tpu [{name}] {dt:.3f}s", file=sys.stderr)


# ----------------------------------------------------------------------
# span accumulator: named wall-clock totals across a run, so bench
# harnesses (bench_e2e northstar) can publish a per-phase breakdown.
# Always on — the spans wrap per-batch/per-block
# work, thousands of perf_counter() pairs at most.
# ----------------------------------------------------------------------

_spans: dict = {}
_spans_lock = None


def add_span(name: str, dt: float) -> None:
    global _spans_lock
    if _spans_lock is None:
        import threading
        _spans_lock = threading.Lock()
    with _spans_lock:
        _spans[name] = _spans.get(name, 0.0) + dt


def spans() -> dict:
    """Accumulated {name: seconds} since the last reset."""
    return dict(_spans)


def reset_spans() -> None:
    _spans.clear()


@contextlib.contextmanager
def span(name: str):
    """Accumulate wall-clock into the named span (no printing)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_span(name, time.perf_counter() - t0)
