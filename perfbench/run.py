"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  Untraced, the result's ``metrics`` are
the cell's end-to-end metrics; traced (``--trace 1``, the window under
``torch.profiler``), its per-layer metrics, with ``busy_s``, ``window_s``
and a ``breakdown`` of device time and idle time.  The last line of
standard output is the result, one JSON object; the numbers that decide
``correct`` are the last lines of standard error and the result's last
key.  Exits non-zero, printing no result, without a card (or with fewer
than the cell asks for), and if ``jax``, ``jaxlib``, ``flax`` or ``repro``
is loaded once the window has closed.  Build and kernel caches stay in
``build/`` inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TOP = 10


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def setup_paths() -> None:
    """The checkout (for ``perfbench``) and its ``src`` (for the port) on
    the path, in place of this script's own folder."""
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != here]
    for p in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(p))


def setup_env() -> None:
    """Every cache the program or PyTorch may write, at fixed paths inside
    the checkout; no library may pull in JAX."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``repro_torch`` is not ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_note() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def breakdown(summary) -> dict:
    ops = sorted(summary.device_s_by_kernel.items(), key=lambda kv: -kv[1])
    idle = sorted(summary.idle_by_host.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:120], v] for k, v in ops[:TOP]],
            "idle_gaps": [[f"host:{k}", v] for k, v in idle[:TOP]]}


def result_line(out, metrics: dict, kind: str, count: int) -> dict:
    """The result: the driver's keys, ``breakdown`` when traced, and the
    numbers that decide ``correct`` last."""
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    summary = out.window.trace
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = out.window.seconds
        result["breakdown"] = breakdown(summary)
    result["checks"] = out.checks
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    setup_env()
    setup_paths()
    import torch

    from perfbench.harness import spec

    bench = spec.Benchmark(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        log("no card: torch.cuda.is_available() is False")
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        log(f"the cell asks for {cell['chips']} cards, "
            f"{torch.cuda.device_count()} found")
        return 3
    log(f"card: {card_note()}")
    config, traffic = bench.config(cell), bench.traffic(cell)
    out = bench.system(config).run(
        config, traffic, bench.generator(traffic), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device="cuda",
        t_start=T_START, log=log)
    metrics = spec.read_metrics(bench, cell["name"], bool(args.trace),
                                out.window)
    for note in out.window.notes.items():
        log("%s: %s" % note)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 4
    result = result_line(out, metrics, torch.cuda.get_device_name(0),
                         cell["chips"])
    for name, check in out.checks.items():
        log(f"check {name}: " + " ".join(f"{k}={v}"
                                         for k, v in check.items()))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
