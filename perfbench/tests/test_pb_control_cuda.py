"""The control on the card: the reference computed in fp8 in the program's
place fails the cell's limit, while the program passes it, on the same
served requests (the cell's configuration and traffic, a short window)."""
import time

import pytest

from perfbench.harness import spec

BENCH = spec.Benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(BENCH.cells))
def test_fp8_control_fails_the_limit(card, cell):
    w = BENCH.cell(cell)
    config, traffic = BENCH.config(w), BENCH.traffic(w)
    out = BENCH.system(config).run(
        config, traffic, BENCH.generator(traffic), seed=2 ** 31 + 4242,
        seconds=3.0, trace=False, device=str(card),
        t_start=time.perf_counter(), log=print, control=True)
    limits = config["correct"]["logit_gap_limits"]
    assert out.correct, out.checks
    assert any(out.readings[f"control.{k}"] > v for k, v in limits.items())
