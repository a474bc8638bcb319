"""The control of a cell's comparison: the reference put in the program's
place and computed in TF32, the precision below the configurations'
float32 with TF32 off. Its answers go through the same comparison as a
run's and have to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 5]

Search cells: the exact top-k of the sampled calls' queries in TF32 takes
the place of the program's answers (no graph is built). The ingest cell:
the program grows its graph for ``--seconds`` at the cell's own load, and
the reference's TF32 edge distances take the place of the stored ones.
Prints one JSON line a seed, then one summary line; exits 1 where the
control came out correct on any seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def control(name: str, seed: int, seconds: float, *, device: str = "cuda",
            config_overrides: dict | None = None, mix_overrides: dict | None = None,
            root: Path | None = None, here: Path | None = None) -> dict:
    """The control's numbers for one seed of cell ``name`` (of the
    benchmark at ``root``, with its pieces under ``here``; by default this
    checkout's)."""
    import torch

    from portbench import harness
    from portbench.reference import checks

    root, here = root or harness.ROOT, here or harness.HERE
    bench = harness.load_bench(root)
    cell, config, mix, driver = harness.cell_parts(bench, name, root, here)
    config = {**config, **(config_overrides or {})}
    mix = {**mix, **(mix_overrides or {})}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    env = harness.Env(config=config, mix=mix, seed=seed, device=dev, spans=harness.NoSpans())
    window = harness.Window(unit=driver.UNIT)
    if driver.UNIT == "queries":
        state = driver.setup(env, build=False)
        calls = math.ceil(mix["sample_queries"] / mix["batch"])
        window.answers = driver.control_answers(state, calls)
        window.units = [mix["batch"]] * calls
        judged = driver.judge(state, window)
    else:
        state = driver.setup(env)
        harness.closed_loop(lambda j: driver.request(state, j), lambda r: driver.serve(state, r),
                            driver.units, seconds, window, env.spans, None)
        judged = driver.judge(state, window, control=True)
    return {"workload": name, "seed": seed, "correct": checks.correct(judged["checks"]),
            "checks": {c["name"]: [c["value"], c["limit"]] for c in judged["checks"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    outs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        outs.append(control(args.workload, seed, args.seconds))
        print(json.dumps(outs[-1]), flush=True)
    failed_as_it_should = all(not o["correct"] for o in outs)
    print(json.dumps({"workload": args.workload, "seeds": len(outs),
                      "control_not_correct_on_every_seed": failed_as_it_should,
                      "seconds": time.perf_counter() - T_START}))
    return 0 if failed_as_it_should else 1


if __name__ == "__main__":
    sys.exit(main())
