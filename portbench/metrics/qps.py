"""qps: all queries answered in the window over the window's seconds
(host clock; the window ends when the last call's answer is on the host)."""


def read(run):
    if run.window.unit != "queries" or run.window.window_s <= 0:
        return None
    return sum(run.window.units) / run.window.window_s
