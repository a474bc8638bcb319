"""rerank_gather_ms: device ms a call of the port's ``rerank_topk`` spends
gathering the candidates' rows (``ops/rerank.py``): the program's device
span ``rerank.gather.device`` (CUDA events; on the CPU the host time) over
the calls of its span ``rerank.topk`` (``utils/timing.py``, on in traced
runs)."""


def read(run):
    gather = run.timers.get("rerank.gather.device")
    calls = run.timers.get("rerank.topk", (0.0, 0))[1]
    if not gather or not calls:
        return None
    return gather[0] / calls * 1e3
