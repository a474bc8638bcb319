"""Tiny sizes of each cell for the CPU tests: the configuration's and the
traffic mix's keys that a test run replaces."""

CONFIG = {"rows": 3000, "hnsw": {"m": 8, "max_m0": 16, "ef_construction": 48}, "build_max_batch": 256}
SEARCH = {"batch": 128, "sample_queries": 256}
INGEST = {"rows_per_call": 256, "graph_cap": 2048, "max_batch": 256, "judge_queries": 256,
          "judge_nodes": 256}


def mix(cell: str) -> dict:
    return INGEST if ".ingest-" in cell else SEARCH
