"""descent_ms: ms per call of the port's greedy descent
(``index/search.py:descend_to_level1``), a synchronised span that the
harness wraps around it in a traced run."""


def read(run):
    spans = run.spans.seconds.get("descent") if run.spans else None
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
