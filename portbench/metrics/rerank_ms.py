"""rerank_ms: ms per call of the port's ``ops/rerank.py:rerank_topk``, a
synchronised span that the harness wraps around it in a traced run."""


def read(run):
    spans = run.spans.seconds.get("rerank") if run.spans else None
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
