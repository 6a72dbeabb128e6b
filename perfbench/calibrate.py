"""Readings for the limits that decide ``correct``: one process, one cell,
many seeds.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5

For each seed, a run of the cell as ``run.py`` makes it (weights, traffic,
ramp, a window of ``--seconds``) and then, on the same sample of served
requests, the widest gap of the program's tokens and the widest gap of the
fp8 control's own first choices below the float32 reference's best.  One
JSON line a seed.  The benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    run.setup_env()
    run.setup_paths()
    import torch

    from perfbench.harness import spec

    if not torch.cuda.is_available():
        run.log("no card")
        return 3
    bench = spec.Benchmark(run.ROOT)
    cell = bench.cell(args.workload)
    config, traffic = bench.config(cell), bench.traffic(cell)
    system, gen = bench.system(config), bench.generator(traffic)
    run.log(f"card: {run.card_note()}")
    for seed in (int(s) for s in args.seeds.split(",")):
        out = system.run(config, traffic, gen, seed=seed,
                         seconds=args.seconds, trace=False, device="cuda",
                         t_start=time.perf_counter(), log=run.log,
                         control=True)
        e2e = spec.read_metrics(bench, cell["name"], False, out.window)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "correct": out.correct, **out.readings,
                          "tokens": out.checks["tokens_compared"]["value"],
                          "e2e": {k: v["value"] for k, v in e2e.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
