"""idle_share.query: the share of a profiled stretch of a query window in
which no operation ran on the card: 1 minus the union of the device's op
spans over the stretch's wall time, from torch.profiler."""


def read(run):
    t = run.trace
    if run.window.unit != "queries" or not t or not t.get("busy_s") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
