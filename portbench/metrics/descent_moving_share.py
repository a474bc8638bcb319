"""descent_moving_share: the share of the queries stepped in the port's
descent that moved, in %: the program's counters ``descent.moved`` over
``descent.query_steps`` (``utils/timing.py``, on in traced runs). Low,
most of a batch is still while a few stragglers keep it stepping."""


def read(run):
    stepped = run.timers.get("descent.query_steps", (0, 0))[0]
    if not stepped:
        return None
    return 100.0 * run.timers.get("descent.moved", (0, 0))[0] / stepped
