"""setup_s: host seconds from the benchmark process's start to its first
timed call: imports, the card's start, the kernel library (built on a
checkout's first run), data, the graph build and the warm-up call."""


def read(run):
    return run.setup_s
