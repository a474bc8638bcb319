"""descent_steps: greedy steps a call of the port's descent
(``index/search.py:descend_to_level1``), each with one host wait: the
program's counter ``descent.steps`` over the calls of its span
``search.descent`` (``utils/timing.py``, on in traced runs)."""


def read(run):
    calls = run.timers.get("search.descent", (0.0, 0))[1]
    if not calls:
        return None
    return run.timers.get("descent.steps", (0, 0))[0] / calls
