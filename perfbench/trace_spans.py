"""One traced run of a cell, as ``run.py --trace 1`` makes it, that also
reduces the profiler's events against the program's own spans.

    python3 perfbench/trace_spans.py --workload <cell> --seed <n> \\
        --seconds <s> [--spans on|off]

It prints what ``run.py`` prints, and before the result line one JSON
line ``{"program_trace": ...}`` (``harness/program.py``
``on_device_trace``): device idle seconds by the innermost program span,
device seconds and launches by span, beside the harness's own ``moe`` span
and idle split of the same events.  ``--spans off`` keeps the program
from recording, so turns of ``on`` and ``off`` measure the recorder's
cost.  Run from the root of a checkout.
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
    ap.add_argument("--spans", choices=("on", "off"), default="on")
    args, rest = ap.parse_known_args(argv)
    run.setup_env()
    run.setup_paths()
    from perfbench.harness import program
    from perfbench.harness import trace as trace_lib

    if args.spans == "off":
        from repro_torch.perf import spans

        spans.follow_profiler = lambda: None
    summarize = trace_lib.summarize

    def both(events, out):
        events = list(events)
        summarize(events, out)
        got = program.on_device_trace(events)
        got.update(harness_moe_device_s=out.span_device_s.get("moe"),
                   harness_idle_by_host=out.idle_by_host,
                   busy_s=out.busy_s, spans_on=args.spans == "on")
        print(json.dumps({"program_trace": got}), flush=True)
        return out

    trace_lib.summarize = both
    run.T_START = T_START
    return run.main(rest + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
