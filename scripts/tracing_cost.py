"""What the port's tracing (``tpuvec_torch/utils/timing.py``) costs when on,
and whether its spans line up with torch.profiler's trace, on one of the
benchmark's search cells.

Set-up is the cell's own (``portbench/drivers/``: corpus and graph from
the seed, one warm-up call). Then blocks of calls of the cell's serve loop
run with tracing off and on in turns (off, on, on, off, ...; by default
one call a block, so the host's drift falls on both alike), each call
timed on the host until its answer is there. Last, one call runs under
the harness's profiler, as a traced run's profiled calls do, and its
spans are dumped: each span's start is held against its range in the
profiler's exported trace, and the device ops of the harness's breakdown
that bear a span's name are listed (none are expected).

    python3 scripts/tracing_cost.py --workload int8cos-1m-1024.rerank-b4096 \
        --seed 1400000001 [--blocks 400 --calls 1] [--out cost.json]

``--tiny --device cpu`` runs it at the CPU tests' sizes.

Prints one JSON line: the card, each mode's per-call median and quartiles
in ms, the on/off ratio of the medians, the program's spans and counters
over the traced blocks, and the clock check.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=400, help="blocks of calls, half off and half on")
    ap.add_argument("--calls", type=int, default=1, help="calls a block")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the CPU tests' tiny sizes (portbench/tests/tiny.py), for a rehearsal")
    ap.add_argument("--out", help="also write the line to this file")
    args = ap.parse_args()

    import torch

    from portbench import harness
    from portbench.reference import peaks
    from tpuvec_torch.utils import timing

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("tracing_cost: no CUDA card", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_num_threads(4)  # as portbench/run.py
    _, config, mix, driver = harness.cell_parts(harness.load_bench(), args.workload)
    if args.tiny:
        from portbench.tests import tiny

        config, mix = {**config, **tiny.CONFIG}, {**mix, **tiny.mix(args.workload)}
    env = harness.Env(config=config, mix=mix, seed=args.seed, device=dev, spans=harness.NoSpans())
    t = time.perf_counter()
    state = driver.setup(env)
    setup_s = time.perf_counter() - t

    ms = {"off": [], "on": []}
    j = 0
    timing.reset()
    for block in range(args.blocks):
        mode = "on" if block % 4 in (1, 2) else "off"
        if mode == "on":
            timing.enable()
        for _ in range(args.calls):
            req = driver.request(state, j)
            t0 = time.perf_counter()
            driver.serve(state, req)
            ms[mode].append((time.perf_counter() - t0) * 1e3)
            j += 1
        timing.disable()
    program = timing.stats()
    timing.reset()

    clock = _clock_check(driver, state, j, dev, timing)
    out = {
        "workload": args.workload, "seed": args.seed, "setup_s": setup_s,
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "power_limit_w": peaks.power_limit_w() if dev.type == "cuda" else None,
        "torch": torch.__version__,
        "calls_a_mode": {m: len(v) for m, v in ms.items()},
        "median_ms": {m: statistics.median(v) for m, v in ms.items()},
        "quartiles_ms": {m: statistics.quantiles(v, n=4) for m, v in ms.items()},
        "on_over_off": statistics.median(ms["on"]) / statistics.median(ms["off"]),
        "program": program,
        "clock": clock,
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


def _clock_check(driver, state, j: int, dev, timing) -> dict:
    """One call under the harness's profiler, its trace exported: the
    widest gap (us) between a dumped span's start and its range's in the
    profiler's trace, the spans found there, and the device ops of the
    harness's breakdown (``harness._device_summary``) that bear a span's
    name (none wanted)."""
    from portbench import harness

    with tempfile.TemporaryDirectory() as tmp:
        prof_path, span_path = f"{tmp}/prof.json", f"{tmp}/spans.json"
        timing.reset()
        timing.enable()
        req = driver.request(state, j)
        with harness._profiler(dev) as prof:
            driver.serve(state, req)
        timing.disable()
        prof.export_chrome_trace(prof_path)
        timing.dump(span_path)
        trace = json.loads(Path(prof_path).read_text())
        spans = json.loads(Path(span_path).read_text())
    timing.reset()
    summary = harness._device_summary(prof, 1.0, set())

    def starts(t, cat):
        base, got = t["baseTimeNanoseconds"] / 1e3, {}
        for e in t["traceEvents"]:
            if e.get("ph") == "X" and e.get("cat") == cat:
                got.setdefault(e["name"], []).append(e["ts"] + base)
        return {k: sorted(v) for k, v in got.items()}

    mine = starts(spans, "tpuvec")
    host = starts(trace, "user_annotation")
    on_device = starts(trace, "gpu_user_annotation")
    gaps = [abs(a - b) for name, ts in mine.items() for a, b in zip(ts, host.get(name, []))]
    return {
        "spans": {k: len(v) for k, v in mine.items()},
        "in_profiler": {k: len(host.get(k, [])) for k in mine},
        "on_device_timeline": {k: len(v) for k, v in on_device.items() if k in mine},
        "widest_start_gap_us": max(gaps) if gaps else None,
        "span_named_device_ops": [n for n, _ in summary["device_ops"] if n in mine],
        "device_ops": [n for n, _ in summary["device_ops"]],
    }


if __name__ == "__main__":
    sys.exit(main())
