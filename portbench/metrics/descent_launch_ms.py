"""descent_launch_ms: the host's own work in a call of the port's descent,
in ms: the program's span ``search.descent`` less its host waits, the
spans ``search.descent.sync`` (``utils/timing.py``, on in traced runs).
While the host issues a step's launches, the card mostly waits."""


def read(run):
    total, calls = run.timers.get("search.descent", (0.0, 0))
    if not calls:
        return None
    waits = run.timers.get("search.descent.sync", (0.0, 0))[0]
    return (total - waits) / calls * 1e3
