"""The port's tracing: spans, counters and requests on one clock.

Off by default and free when off: ``span`` then returns one shared no-op
context and ``count`` returns at once, so no range, event, context lookup
or allocation is made and no device op or host sync is added.

``enable()`` turns it on. Then:

* ``span(name)`` (also ``timer``) records the block's name, start and
  end, its parent (the innermost span open in the same thread or
  context) and its request id. ``stats()`` adds up host seconds and calls
  per name. While a ``torch.profiler`` records, the span is also a
  ``record_function`` range of the same name, so the profiler's trace
  (``trace()``, or any other) shows it on the device trace's clock; the
  range is left out otherwise, where it would cost ~10 us for nothing.
* ``span(name, device=...)`` also times the block's device work: with a
  CUDA tensor (or ``True`` while CUDA is initialised) a pair of CUDA
  events on the current stream, with no wait; ``stats()`` resolves them
  after one wait into ``<name>.device``. On the CPU, where the work is
  synchronous, the block's host time stands in.
* ``count(name, n)`` adds n to a counter; ``stats()`` gives it as
  (total, times counted).
* ``request(rid)`` opens a request that spans inside inherit; a root span
  opened outside any request mints a fresh id of its own.

Device work is asynchronous: a host span holds the time to issue the
block's work, plus whatever waits for the card inside it
(``index/build.py:insert_batch`` waits after each stage while timing is
on).

Spans are kept in a bounded ring. ``records()`` returns them with their
self time (duration less their children's); ``dump(path)`` writes them as
a Chrome trace (``ph: "X"``) whose ``ts`` + ``baseTimeNanoseconds`` read
the wall clock, as a ``torch.profiler`` trace's do: the two line up in
Perfetto. ``trace(path)`` records a ``torch.profiler`` trace of a block.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque

import torch

__all__ = [
    "enable", "disable", "enabled", "reset", "span", "timer", "count", "request", "stats",
    "records", "dump", "print_stats", "trace",
]

# spans kept for records() / dump(); the oldest go first
RING = 1 << 16
# unresolved device spans past which those the card has finished are resolved
_PENDING_MAX = 4096
# torch.profiler's Chrome-trace base: the start of the current interval of
# this many seconds (libkineto's ChromeTraceBaseTime)
_TRIMONTH_S = 7889238

_enabled = False
_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_calls: dict[str, int] = defaultdict(int)
_counters: dict[str, int] = defaultdict(int)
_counted: dict[str, int] = defaultdict(int)
_pending: list = []  # (name, start event, end event) of CUDA device spans
_ring: deque = deque(maxlen=RING)
_ids = itertools.count(1)
_rids = itertools.count(1)
_wall_offset_ns = 0  # time.time_ns() - time.perf_counter_ns(), taken at enable()
# thread ident -> native id (the profiler's tid): get_native_id() is a
# system call (~7 us on the host of an H100 server), so each thread asks once
_native_ids: dict[int, int] = {}
_open: contextvars.ContextVar = contextvars.ContextVar("tpuvec_span", default=None)
_request: contextvars.ContextVar = contextvars.ContextVar("tpuvec_request", default=None)
_NOOP = contextlib.nullcontext()


def enable() -> None:
    """Turn tracing on and anchor its clock to the wall clock."""
    global _enabled, _wall_offset_ns
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    _wall_offset_ns = wall - (a + b) // 2
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _totals.clear()
        _calls.clear()
        _counters.clear()
        _counted.clear()
        _pending.clear()
        _ring.clear()


class _Span:
    __slots__ = ("name", "device", "sid", "parent", "rid", "tid", "tokens", "range", "events", "t0")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        parent = _open.get()
        self.sid = next(_ids)
        self.parent = parent.sid if parent is not None else 0
        rid = _request.get()
        rtoken = None
        if rid is None:
            rid = next(_rids)
            rtoken = _request.set(rid)
        self.rid = rid
        self.tokens = (_open.set(self), rtoken)
        self.tid = threading.get_ident()
        if self.tid not in _native_ids:
            _native_ids[self.tid] = threading.get_native_id()
        # the profiler's range opens first and closes last, so it holds the
        # span, and the range's own cost stays out of the span's time
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.events = None
        if self.device is not False and _on_cuda(self.device):
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        otoken, rtoken = self.tokens
        _open.reset(otoken)
        if rtoken is not None:
            _request.reset(rtoken)
        dt = (t1 - self.t0) / 1e9
        with _lock:
            _totals[self.name] += dt
            _calls[self.name] += 1
            if self.device is not False:
                if self.events is None:
                    _totals[self.name + ".device"] += dt
                    _calls[self.name + ".device"] += 1
                else:
                    _pending.append((self.name + ".device", *self.events))
                    if len(_pending) > _PENDING_MAX:
                        _resolve(wait=False)
            _ring.append((self.sid, self.parent, self.rid, self.name, self.t0, t1, self.tid))
        return False


def _on_cuda(device) -> bool:
    if isinstance(device, torch.Tensor):
        return device.is_cuda
    return torch.cuda.is_initialized()


def span(name: str, *, device=False):
    """A span around a block (a shared no-op when tracing is off).

    ``device``: False, or where the block's work runs, to time it on the
    device too (``<name>.device`` in ``stats()``): a tensor it works on,
    or True for the current CUDA device while CUDA is initialised. Off
    CUDA the host time stands in."""
    if not _enabled:
        return _NOOP
    return _Span(name, device)


timer = span


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (nothing when tracing is off)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] += n
        _counted[name] += 1


@contextlib.contextmanager
def _request_block(rid):
    token = _request.set(rid)
    try:
        yield rid
    finally:
        _request.reset(token)


def request(rid: int | None = None):
    """A request that the spans opened inside it inherit; yields its id.
    Without ``rid`` it joins the request already open, or mints a new id.
    A shared no-op (yielding None) when tracing is off."""
    if not _enabled:
        return _NOOP
    if rid is None:
        rid = _request.get()
        if rid is None:
            rid = next(_rids)
    return _request_block(rid)


def _resolve(wait: bool) -> None:
    """Fold the pending device spans into the totals: all of them, each
    waited for in turn (in effect one wait, for the newest), or
    (``wait=False``) those the card has finished. Called with ``_lock``
    held."""
    keep = []
    for name, start, end in _pending:
        if wait:
            end.synchronize()
        elif not end.query():
            keep.append((name, start, end))
            continue
        _totals[name] += start.elapsed_time(end) / 1e3
        _calls[name] += 1
    _pending[:] = keep


def stats() -> dict[str, tuple[float, int]]:
    """Every span as (host seconds, calls), each device span's
    ``<name>.device`` as (device seconds, calls), and every counter as
    (total, times counted), by name."""
    with _lock:
        _resolve(wait=True)
        out = {k: (_totals[k], _calls[k]) for k in _totals}
        out.update((k, (_counters[k], _counted[k])) for k in _counters)
    return dict(sorted(out.items()))


def records() -> list[dict]:
    """The spans in the ring, in the order they ended: name, id, parent (0
    for a root), request, thread, start and end on the wall clock (ns),
    and self time (ns): the duration less its children's in the ring."""
    with _lock:
        ring = list(_ring)
    child_ns: dict[int, int] = defaultdict(int)
    for _, parent, _, _, t0, t1, _ in ring:
        if parent:
            child_ns[parent] += t1 - t0
    return [{"name": name, "id": sid, "parent": parent, "request": rid, "thread": _native_ids[tid],
             "start_ns": t0 + _wall_offset_ns, "end_ns": t1 + _wall_offset_ns,
             "self_ns": t1 - t0 - child_ns[sid]}
            for sid, parent, rid, name, t0, t1, tid in ring]


def dump(path: str) -> None:
    """Write the ring's spans to ``path`` as a Chrome trace: one ``ph: "X"``
    event each, with id, parent, request and self time in ``args``, on
    torch.profiler's clock (``ts`` in us from ``baseTimeNanoseconds``)."""
    spans = records()
    base = int(time.time()) // _TRIMONTH_S * _TRIMONTH_S * 1_000_000_000
    pid = os.getpid()
    events = [{"ph": "X", "cat": "tpuvec", "name": r["name"], "pid": pid, "tid": r["thread"],
               "ts": (r["start_ns"] - base) / 1e3, "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
               "args": {"id": r["id"], "parent": r["parent"], "request": r["request"],
                        "self_us": r["self_ns"] / 1e3}}
              for r in spans]
    with open(path, "w") as f:
        json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base, "traceEvents": events}, f)


def print_stats() -> None:
    """Breakdown printout: per span its total ms, calls and mean us; per
    counter its total, times counted and mean."""
    s = stats()
    if not s:
        print("tpuvec timing: no samples (enable() first)")
        return
    width = max(len(k) for k in s)
    print(f"{'span / counter':<{width}}  {'total_ms':>10}  {'calls':>8}  {'avg_us':>10}")
    for k, (tot, n) in s.items():
        if k in _counters:
            print(f"{k:<{width}}  {tot:>10}  {n:>8}  {tot / max(n, 1):>10.2f}")
        else:
            print(f"{k:<{width}}  {tot * 1e3:>10.2f}  {n:>8}  {tot / max(n, 1) * 1e6:>10.1f}")


@contextlib.contextmanager
def trace(path: str = "tpuvec_trace.json"):
    """Host and device profile of the block by ``torch.profiler``, written
    to ``path`` as a Chrome trace (chrome://tracing, Perfetto); spans
    opened inside it are ranges of that trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
