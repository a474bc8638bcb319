"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds tpuvec_torch. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last the numbers compared beside their limits under ``checks``); the last
lines of standard error are those numbers again. Without a CUDA card,
with fewer cards than the cell asks for, without the port in the checkout,
or when JAX or the JAX package was loaded, it prints no result and exits
with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's kernel library builds under the checkout's build/
    # (tpuvec_torch/kernels.py); CUDA's own cache stays in the checkout too
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
    sys.path.insert(0, str(ROOT))
    try:
        import tpuvec_torch
    except ImportError as exc:
        return _fail(f"the port is not in this checkout ({exc})", 3)
    if not Path(tpuvec_torch.__file__).resolve().is_relative_to(ROOT):
        return _fail(f"tpuvec_torch comes from {tpuvec_torch.__file__}, outside {ROOT}", 3)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        return _fail("no CUDA card: this benchmark measures the port on the card only", 2)
    cell = harness.cell_parts(harness.load_bench(ROOT), args.workload)[0]
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{args.workload} needs {cell['chips']} cards, "
                     f"{torch.cuda.device_count()} present", 2)
    torch.set_num_threads(4)
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        return _fail(f"JAX or the JAX package was loaded: {', '.join(loaded)}", 4)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
