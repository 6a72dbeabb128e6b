"""``BENCHMARK.json`` against the contract's shape, and the result line."""
import json
import re

import pytest

from perfbench import run
from perfbench.harness import spec, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.Benchmark()


def test_benchmark_file_shape():
    d = BENCH.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["paths"] == ["perfbench"]
    assert 1 <= d["run_seconds"] <= 51
    names = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    names += [w["name"] for w in d["workloads"]]
    names += [c["name"] for c in d["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH.package / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", sorted(BENCH.cells))
def test_every_cell_reports_what_the_contract_asks(cell):
    e2e = {m["name"] for m in BENCH.metrics(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = BENCH.metrics(cell, True)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
    w = BENCH.cell(cell)
    assert w["chips"] == 1
    config = BENCH.config(w)
    assert config["source"] == BENCH.configs[w["config"]]["source"]
    assert config["reduced"] == BENCH.configs[w["config"]]["reduced"]
    for key in config["reduced"]:
        assert not key.endswith(("_dim", "_rank", "_size"))


class _Out:
    def __init__(self, summary):
        self.correct, self.attempted, self.failed = True, 12, 0
        self.memory_peak_bytes = 123
        self.checks = {"max_logit_gap": {"value": 0.1, "limit": 0.5}}
        self.window = type("W", (), {"trace": summary, "seconds": 2.5})()


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(traced):
    summary = None
    if traced:
        summary = trace.TraceSummary(
            busy_s=2.0, launches=5,
            device_s_by_kernel={f"k{i}": i * 1e-3 for i in range(15)},
            idle_by_host={"render": 0.1, "commit": 0.2})
    line = run.result_line(_Out(summary), {"tok_s": {"value": 1.5,
                                                     "unit": "tokens/s"}},
                           "NVIDIA H100 80GB HBM3", 1)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert ("busy_s" in dev) == traced and ("breakdown" in line) == traced
    if traced:
        assert dev["window_s"] == 2.5
        b = line["breakdown"]
        assert len(b["device_ops"]) == 10 and b["device_ops"][0][0] == "k14"
        assert b["idle_gaps"][0] == ["host:commit", 0.2]
    json.loads(json.dumps(line))
