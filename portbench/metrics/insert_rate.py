"""insert_rate: all rows inserted and acknowledged in the window over the
window's seconds (host clock)."""


def read(run):
    if run.window.unit != "rows" or run.window.window_s <= 0:
        return None
    return sum(run.window.units) / run.window.window_s
