"""The benchmark's harness: it finds a cell's pieces by name, runs set-up,
one closed-loop window and the comparison, and assembles the result line.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration (``BENCHMARK.json`` names
  the file);
* ``traffic/<traffic>.json``: the traffic mix, a data file whose
  ``driver`` names the general generator that reads it;
* ``drivers/<driver>.py``: a generator, with ``setup``, ``request``,
  ``serve``, ``units`` and ``judge``, the ``SPANS`` a traced run wraps,
  and the ``MIX_KEYS`` it reads (a mix with any other key is refused);
* ``metrics/<metric>.py``: one metric's reader, ``read(run)``, which
  returns a number or None where it finds nothing to read.

A run measures with tracing off (``--trace 0``: the end-to-end metrics),
or with synchronised spans around the program's layers and
``torch.profiler`` over a stretch of the window (``--trace 1``: the
per-layer metrics). Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable

import numpy as np
import torch

from portbench.reference import checks as checks_mod
from portbench.reference import peaks

__all__ = ["HERE", "ROOT", "load_bench", "cell_parts", "run_cell", "forbidden_modules", "Env", "Run"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuvec")
# the share of the window after which a traced run profiles, and the calls
# it profiles there
PROFILE_AFTER = 0.5
PROFILE_CALLS = 4
# the longest host idle gaps and device ops a traced run's breakdown lists
BREAKDOWN_TOP = 10


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def cell_parts(bench: dict, name: str, root: Path = ROOT, here: Path = HERE):
    """(cell, configuration, traffic mix, driver module) of cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = _load_module(here / "drivers" / f"{mix['driver']}.py", f"portbench_driver_{mix['driver']}")
    unread = sorted(set(mix) - driver.MIX_KEYS)
    if unread:
        raise ValueError(f"traffic {cell['traffic']!r}: driver {mix['driver']!r} reads no key {unread}")
    return cell, config, mix, driver


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with ``workloads`` only there."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(metric: str, here: Path = HERE) -> ModuleType:
    return _load_module(here / "metrics" / f"{metric}.py", f"portbench_metric_{metric.replace('.', '_')}")


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Synchronised spans on the host clock around calls into the program,
    each also a ``record_function`` range for the profiler. ``wrap``
    replaces a module attribute by a timed wrapper (``restore`` puts the
    originals back); with ``capture`` it also keeps the arguments and
    outputs of the first call and each call's device time (CUDA events).
    While ``syncing`` is off (the profiled calls), spans are profiler
    ranges alone: no wait for the card, no time kept, so that the profile
    sees the device as an untraced run keeps it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.syncing = True
        self.names: set[str] = set()
        self.seconds: dict[str, list[float]] = {}
        self.device_s: dict[str, list[float]] = {}
        self.captured: dict[str, tuple] = {}
        self._originals: list[tuple[ModuleType, str, Any]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        self.names.add(name)
        if not self.syncing:
            with torch.profiler.record_function(name):
                yield
            return
        _sync(self.device)
        t = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            _sync(self.device)
        self.seconds.setdefault(name, []).append(time.perf_counter() - t)

    def wrap(self, module: ModuleType, attr: str, name: str, *, capture: bool = False) -> None:
        fn = getattr(module, attr)
        cuda = self.device.type == "cuda"

        def wrapper(*args, **kwargs):
            timed = capture and cuda and self.syncing
            with self.span(name):
                if timed:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                out = fn(*args, **kwargs)
                if timed:
                    end.record()
                    end.synchronize()
                    self.device_s.setdefault(name, []).append(start.elapsed_time(end) / 1e3)
            if timed and name not in self.captured:
                self.captured[name] = (args, kwargs, out)
            return out

        self._originals.append((module, attr, fn))
        setattr(module, attr, wrapper)

    def restore(self) -> None:
        for module, attr, fn in reversed(self._originals):
            setattr(module, attr, fn)
        self._originals.clear()


class NoSpans:
    """Tracing off: spans cost nothing."""

    @contextlib.contextmanager
    def span(self, name: str):
        yield


@dataclass
class Env:
    """What a driver's set-up is given."""

    config: dict
    mix: dict
    seed: int
    device: torch.device
    spans: Any


@dataclass
class Window:
    """The closed loop's record: one entry a call."""

    latencies_s: list[float] = field(default_factory=list)
    units: list[int] = field(default_factory=list)
    answers: list[Any] = field(default_factory=list)
    window_s: float = 0.0
    unit: str = ""


@dataclass
class Run:
    """What a metric's reader reads."""

    cell: dict
    config: dict
    mix: dict
    setup_s: float
    window: Window
    judged: dict
    spans: Any = None
    timers: dict = field(default_factory=dict)
    trace: dict | None = None


def _device_summary(prof, wall_s: float, span_names: set[str]) -> dict:
    """busy_s (the union of the device's op spans), window_s, the costliest
    device ops and the longest idle gaps by the harness span the host was
    in, from a finished ``torch.profiler`` run. The harness's own ranges,
    which the profiler also draws on the device's timeline, are no device
    ops."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CUDA and e.name not in span_names
                 and not getattr(e, "is_user_annotation", False))
    summary = {"window_s": wall_s, "busy_s": 0.0, "device_ops": [], "idle_gaps": []}
    if not dev:
        return summary
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU and e.name in span_names)
    busy, end, by_name, gaps = 0.0, dev[0][0], {}, {}
    for a, b, name in dev:
        if a > end:
            where = _host_at(host, end, a)
            gaps[where] = gaps.get(where, 0.0) + (a - end)
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
    summary["busy_s"] = busy / 1e6
    summary["device_ops"] = [[name, us / 1e6] for name, us in top]
    summary["idle_gaps"] = [[name, us / 1e6] for name, us in
                            sorted(gaps.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]]
    summary["device_span_s"] = (end - dev[0][0]) / 1e6
    return summary


def _host_at(host: list, a: float, b: float) -> str:
    """The innermost harness span that holds the middle of [a, b]."""
    mid, best = (a + b) / 2, ("outside spans", -1.0)
    for s, e, name in host:
        if s > mid:
            break
        if e >= mid and s > best[1]:
            best = (name, s)
    return best[0]


def closed_loop(request: Callable, serve: Callable, units: Callable, seconds: float,
                window: Window, spans: Any, profile: dict | None) -> None:
    """One client in a closed loop: call j's request is made, then served
    (timed on the host clock until its answer is on the host), until the
    window's ``seconds`` have passed; the window ends with the last call.
    ``profile`` (traced runs) profiles PROFILE_CALLS calls from
    PROFILE_AFTER of the window on, past the window's end if need be."""
    prof, profiled, t_prof = None, 0, 0.0
    start = time.perf_counter()
    deadline = start + seconds
    j = 0
    while True:
        if profile is not None and prof is None and profiled == 0 and \
                time.perf_counter() >= start + PROFILE_AFTER * seconds:
            _sync(spans.device)
            spans.syncing = False
            prof = _profiler(spans.device)
            prof.__enter__()
            t_prof = time.perf_counter()
        with spans.span("make_request"):
            req = request(j)
        t0 = time.perf_counter()
        with spans.span("call"):
            ans = serve(req)
        t1 = time.perf_counter()
        window.latencies_s.append(t1 - t0)
        window.units.append(units(ans))
        window.answers.append(ans)
        j += 1
        if prof is not None:
            profiled += 1
            if profiled == PROFILE_CALLS:
                _sync(spans.device)
                wall = time.perf_counter() - t_prof
                prof.__exit__(None, None, None)
                spans.syncing = True
                profile.update(_device_summary(prof, wall, spans.names))
                profile["calls"] = window.latencies_s[-profiled:]
                prof = None
        if t1 >= deadline and prof is None:
            break
    window.window_s = time.perf_counter() - start


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", root: Path = ROOT, here: Path = HERE,
             config_overrides: dict | None = None, mix_overrides: dict | None = None,
             ) -> tuple[dict, list[str]]:
    """One run of cell ``name``: (the result line's object, the check lines).
    The overrides (tests, at a tiny size) replace keys of the configuration
    and of the traffic mix."""
    bench = load_bench(root)
    cell, config, mix, driver = cell_parts(bench, name, root, here)
    config = {**config, **(config_overrides or {})}
    mix = {**mix, **(mix_overrides or {})}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    spans = Spans(dev) if trace else NoSpans()
    env = Env(config=config, mix=mix, seed=seed, device=dev, spans=spans)
    state = driver.setup(env)
    timers, profile = {}, None
    if trace:
        from tpuvec_torch.utils import timing

        for module_name, attr, span_name, capture in driver.SPANS:
            spans.wrap(importlib.import_module(module_name), attr, span_name, capture=capture)
        profile = {}
        with _profiler(dev):  # the profiler's first start is slow: not in the window
            torch.ones(1, device=dev).add_(1)
        timing.reset()
        timing.enable()  # the program's own timers (index/build.py's insert.*)
    window = Window(unit=driver.UNIT)
    host_probe = [_host_probe_ms(), peaks.telemetry() if dev.type == "cuda" else ""]
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    try:
        closed_loop(lambda j: driver.request(state, j), lambda r: driver.serve(state, r),
                    driver.units, seconds, window, spans, profile)
    finally:
        if trace:
            spans.restore()
    if trace:
        timing.disable()
        timers = timing.stats()
        timing.reset()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    judged = driver.judge(state, window)
    del state
    run = Run(cell=cell, config=config, mix=mix, setup_s=setup_s, window=window, judged=judged,
              spans=spans if trace else None, timers=timers, trace=profile)
    metrics = {}
    for m in metrics_for(bench, name, trace):
        value = reader(m["name"], here).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": checks_mod.correct(judged["checks"]),
        "attempted": int(judged["attempted"]),
        "failed": int(judged["failed"]),
        "metrics": metrics,
        "device": _device(dev, peak, profile),
    }
    if trace and "device_ops" in profile:
        result["breakdown"] = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                    "holds": "<=" if c["at_most"] else ">="}
                        for c in judged["checks"]}
    lat = sorted(window.latencies_s)
    ends = np.cumsum(window.latencies_s)
    buckets = np.histogram(ends, bins=max(1, int(seconds // 5)), weights=window.units)[0]
    notes = [f"run {name} seed {seed}: setup_s {setup_s:.3f}, window_s {window.window_s:.3f}, "
             f"calls {len(lat)}, {window.unit} {sum(window.units)}, call ms min / median / max "
             f"{lat[0] * 1e3:.2f} / {lat[len(lat) // 2] * 1e3:.2f} / {lat[-1] * 1e3:.2f}; "
             f"{window.unit} in each 5 s of the window {buckets.tolist()}; host probe ms "
             f"before / after the window {host_probe[0]:.2f} / {_host_probe_ms():.2f}; card (MHz, C, W, "
             f"reasons) before / after [{host_probe[1]}] / "
             f"[{peaks.telemetry() if dev.type == 'cuda' else ''}]"]
    if profile and "calls" in profile:
        notes.append(f"profiled {len(profile['calls'])} calls in {profile['window_s']:.4f} s "
                     f"(call ms {', '.join(f'{c * 1e3:.2f}' for c in profile['calls'])}), device busy "
                     f"{profile['busy_s']:.4f} s over a device span of {profile.get('device_span_s', 0):.4f} s")
    return result, notes + judged.get("notes", []) + checks_mod.lines(judged["checks"])


def _host_probe_ms() -> float:
    """A fixed piece of pure-Python work, timed: how fast the host runs the
    client's own code just now (a note, not a metric)."""
    t = time.perf_counter()
    sum(i * i for i in range(200_000))
    return (time.perf_counter() - t) * 1e3


def _device(dev: torch.device, peak: int, profile: dict | None) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
               "memory_peak_bytes": int(peak), "power_limit_w": peaks.power_limit_w()}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if profile is not None:
        out["busy_s"] = profile.get("busy_s", 0.0)
        out["window_s"] = profile.get("window_s", 0.0)
    return out
