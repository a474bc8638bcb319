"""Timing instrumentation: the port's own copy of ``tpuvec/utils/timing.py``.

Off by default and free when off. ``enable()`` + ``timer("phase")``
context managers add up host wall-clock time and calls per phase. Device
work is asynchronous, so a phase that must hold its device time waits for
the card inside its timer, and the hot paths do that only while timing is
enabled (``index/build.py:insert_batch``).

``trace(path)`` records a device trace with ``torch.profiler`` (the JAX
package uses ``jax.profiler``) and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

__all__ = ["enable", "disable", "enabled", "reset", "timer", "add", "stats", "print_stats", "trace"]

_enabled = False
_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


@contextlib.contextmanager
def timer(name: str):
    """Scope timer (no-op when disabled)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _totals[name] += dt
            _counts[name] += 1


def add(name: str, seconds: float, count: int = 1) -> None:
    if not _enabled:
        return
    with _lock:
        _totals[name] += seconds
        _counts[name] += count


def stats() -> dict[str, tuple[float, int]]:
    with _lock:
        return {k: (_totals[k], _counts[k]) for k in sorted(_totals)}


def print_stats() -> None:
    """Breakdown printout: total, calls and mean per phase."""
    s = stats()
    if not s:
        print("tpuvec timing: no samples (enable() first)")
        return
    width = max(len(k) for k in s)
    print(f"{'phase':<{width}}  {'total_ms':>10}  {'calls':>8}  {'avg_us':>10}")
    for k, (tot, n) in s.items():
        print(f"{k:<{width}}  {tot * 1e3:>10.2f}  {n:>8}  {tot / max(n, 1) * 1e6:>10.1f}")


@contextlib.contextmanager
def trace(path: str = "tpuvec_trace.json"):
    """Host and device profile of the block by ``torch.profiler``, written
    to ``path`` as a Chrome trace (chrome://tracing, Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
