"""The program's ranges on the card: in a traced window of each cell, as
``run.py --trace 1`` profiles it, every ``repro_torch.*`` range lies on
the host's timeline, none on the device's, so ``harness/trace.py`` counts
none of them as device work."""
import time

import pytest

from perfbench.harness import spec
from perfbench.harness import trace as trace_lib

BENCH = spec.Benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(BENCH.cells))
def test_program_ranges_stay_on_the_host(card, cell, monkeypatch):
    seen, outs = [], []
    summarize = trace_lib.summarize

    def keep(events, out):
        events = list(events)
        seen.extend((e.name(), e.device_type().name) for e in events
                    if e.name().startswith("repro_torch."))
        outs.append(out)
        return summarize(events, out)

    monkeypatch.setattr(trace_lib, "summarize", keep)
    w = BENCH.cell(cell)
    config, traffic = BENCH.config(w), BENCH.traffic(w)
    BENCH.system(config).run(
        config, traffic, BENCH.generator(traffic), seed=2 ** 31 + 4343,
        seconds=2.0, trace=True, device=str(card),
        t_start=time.perf_counter(), log=print)
    names = {name for name, _ in seen}
    want = {"repro_torch.engine.step", "repro_torch.engine.dispatch",
            "repro_torch.engine.render", "repro_torch.model.attention"}
    if config.get("num_local_experts"):
        want.add("repro_torch.model.moe")
    assert want <= names, sorted(names)
    assert [e for e in seen if e[1] != "CPU"] == []
    assert not any(k.startswith("repro_torch.")
                   for k in outs[0].device_s_by_kernel)
