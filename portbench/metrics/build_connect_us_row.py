"""build_connect_us_row: the port's own ``insert.connect`` timer
(``utils/timing.py``) over the rows the traced window inserted, in
microseconds a row."""


def read(run):
    spent = run.timers.get("insert.connect")
    rows = sum(run.window.units)
    if not spent or run.window.unit != "rows" or not rows:
        return None
    return spent[0] / rows * 1e6
