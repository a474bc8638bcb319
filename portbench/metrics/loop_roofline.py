"""loop_roofline: the level-0 loop kernel's least time over its device
time, for the first launch of a traced window. The least time is the
larger of its bytes over the HBM rate and its operations over the compute
rate, counted by replaying the launch with the frozen plain loop
(``reference/plain_loop.py``); the device time is CUDA events around the
launch."""

from portbench.reference import plain_loop


def read(run):
    if not run.spans or "loop" not in run.spans.captured or not run.spans.device_s.get("loop"):
        return None
    args, kwargs, out = run.spans.captured["loop"]
    fresh, adj = plain_loop.loop_rows(args, kwargs)
    if fresh.numel() == 0:
        return None
    bound = plain_loop.loop_bound(args, kwargs, out, fresh, adj)
    return 100.0 * bound["bound_s"] / run.spans.device_s["loop"][0]
