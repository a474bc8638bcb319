"""build_upper_us_row: the port's own ``insert.upper`` timer
(``utils/timing.py``; the stage waits for the card while timing is on)
over the rows the traced window inserted, in microseconds a row."""


def read(run):
    spent = run.timers.get("insert.upper")
    rows = sum(run.window.units)
    if not spent or run.window.unit != "rows" or not rows:
        return None
    return spent[0] / rows * 1e6
