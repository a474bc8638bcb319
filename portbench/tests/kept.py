"""Cells kept out of BENCHMARK.json for now (PERF.md, Open questions), with
the metrics that only they report. Their traffic mixes, driver and metric
readers stay in portbench/, so a later PR puts a cell back with these
entries. The tests run them, beside the benchmark's own cells, at tiny
sizes from a copy of the benchmark that holds them."""

import json
import shutil
from pathlib import Path

from portbench import harness

INGEST = "f32cos-1m-768.ingest-b1024"
FILTER = "f32cos-1m-768.filter10-b4096"

WORKLOADS = [
    {"name": INGEST, "config": "f32cos-1m-768", "traffic": "ingest-b1024", "chips": 1,
     "why": "1 client inserts 1024 rows a call into an empty 1M-capacity graph (write, candidates, upper, "
            "connect); the build rate, bypassing the query path"},
    {"name": FILTER, "config": "f32cos-1m-768", "traffic": "filter10-b4096", "chips": 1,
     "why": "1M graph, 1 client, batches of 4096 fresh queries each under one label of 10 (label = id % 10), "
            "k=10 ef=256: the masked loop form"},
]
# metrics that only the kept cells report
END_TO_END = [
    {"name": "insert_rate", "unit": "vec/s", "better": "higher", "bound": 0.25, "source": "host_clock",
     "workloads": [INGEST]},
]
PER_LAYER = [
    {"name": "build_upper_us_row", "unit": "us/row", "better": "lower", "source": "program_span",
     "layer": "index.build", "moves": "insert_rate", "workloads": [INGEST]},
    {"name": "build_connect_us_row", "unit": "us/row", "better": "lower", "source": "program_span",
     "layer": "index.build", "moves": "insert_rate", "workloads": [INGEST]},
    {"name": "idle_share.ingest", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "insert_rate", "workloads": [INGEST]},
]
# the benchmark's own metrics that a kept cell reports too
ALSO = {FILTER: ["qps", "query_p95_ms", "recall_at_10", "descent_ms", "loop_roofline", "idle_share.query"]}
CELLS = [w["name"] for w in WORKLOADS]


def bench() -> dict:
    """BENCHMARK.json with the kept cells and their metrics put back."""
    out = harness.load_bench()
    out["workloads"] += WORKLOADS
    out["end_to_end"] += END_TO_END
    out["per_layer"] += PER_LAYER
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:  # a metric without the key is reported in every cell
            m["workloads"] += [c for c, names in ALSO.items() if m["name"] in names]
    return out


def copy(root: Path, b: dict) -> tuple[Path, Path]:
    """A copy of the benchmark under ``root`` with ``b`` as its
    BENCHMARK.json: (root, the copy's portbench/)."""
    (root / "portbench").mkdir()
    for part in ("configs", "traffic", "drivers", "metrics", "reference"):
        shutil.copytree(harness.HERE / part, root / "portbench" / part)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root, root / "portbench"
