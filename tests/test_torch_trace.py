"""The port's trace replay (``repro_torch.perf``) against the reference's
``repro.perf``: traces, the length model, the perf table behind ``auto``,
the virtual-time replayer, the SLO scorer and the regression gate, on the
same inputs.  Everything here is exact: no tolerance."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from repro.perf import gate as jgate
from repro.perf import replay as jreplay
from repro.perf import table as jtable
from repro.perf import trace as jtrace
from repro.serving.request import RequestState as JState
from repro_torch.perf import gate as tgate
from repro_torch.perf import replay as treplay
from repro_torch.perf import table as ttable
from repro_torch.perf import trace as ttrace
from repro_torch.serving.request import RequestState as TState

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "BENCH_009.json"


@pytest.mark.parametrize("scenario", ttrace.SCENARIOS)
@pytest.mark.parametrize("seed", [0, 101, 404])
def test_generate_gives_the_reference_traces(scenario, seed):
    kw = dict(seed=seed, n_requests=12, vocab_size=256, prompt_hi=16,
              gen_cap=14)
    got = ttrace.generate(scenario, **kw).as_dict()
    assert got == jtrace.generate(scenario, **kw).as_dict()


def test_trace_json_round_trip_and_to_requests_agree(tmp_path):
    tr = ttrace.generate("mixed", seed=7, n_requests=9, vocab_size=64)
    path = str(tmp_path / "t.json")
    tr.save(path)
    back = jtrace.Trace.load(path)                 # the reference reads it
    assert back.as_dict() == tr.as_dict()
    assert ttrace.Trace.load(path) == tr
    for a, b in zip(tr.to_requests(base=10.0), back.to_requests(base=10.0)):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert (a.req_id, a.arrival, a.deadline, a.priority,
                a.max_new_tokens) == (b.req_id, b.arrival, b.deadline,
                                      b.priority, b.max_new_tokens)
    bad = tr.as_dict()
    bad["trace_schema_version"] = 99
    with pytest.raises(ValueError, match="trace schema"):
        ttrace.Trace.from_dict(bad)


@pytest.mark.parametrize("scenario", ttrace.SCENARIOS)
def test_length_model_fit_and_predict_agree(scenario):
    kw = dict(seed=3, n_requests=12, prompt_hi=16, gen_cap=14)
    mt = ttrace.LengthModel.fit(ttrace.generate(scenario, **kw))
    mj = jtrace.LengthModel.fit(jtrace.generate(scenario, **kw))
    assert (mt.buckets, mt.default) == (mj.buckets, mj.default)
    for n in range(1, 70):
        assert mt.predict(n) == mj.predict(n)


def test_perf_table_winner_and_objective_agree_on_bench_009():
    tt, tj = ttable.PerfTable.load(str(BENCH)), jtable.PerfTable.load(
        str(BENCH))
    assert len(tt.rows) == len(tj.rows) == 32
    for rt, rj in zip(tt.rows, tj.rows):
        assert rt == rj
        assert ttable.PerfTable.objective(rt) == jtable.PerfTable.objective(rj)
    assert tt.scenarios() == tj.scenarios() == sorted(ttrace.SCENARIOS)
    for scenario in tt.scenarios():
        assert tt.winner(scenario) == tj.winner(scenario)
        assert tt.best_objective(scenario) == tj.best_objective(scenario)
        rows = tt.comparable_rows(scenario)
        assert rows == tj.comparable_rows(scenario) and len(rows) == 4
    # the context and the default table path resolve the same winners
    for scenario in tt.scenarios():
        with ttable.perf_context(scenario=scenario), \
                jtable.perf_context(scenario=scenario):
            for axis in ttable.AXES:
                assert ttable.resolve_winner(axis) == \
                    jtable.resolve_winner(axis)
    assert ttable.default_table_path() == jtable.default_table_path()


class _ScriptedEngine:
    """A stand-in engine with the replayer's surface: at most ``width``
    requests run at once, each emits one token a step (two every third
    step) until ``max_new_tokens``."""

    def __init__(self, state, width=2):
        self.state, self.width = state, width
        self.queue, self.running, self.n = [], [], 0

    def submit(self, req):
        self.queue.append(req)

    @property
    def busy(self):
        return bool(self.queue or self.running)

    def step(self):
        self.n += 1
        while self.queue and len(self.running) < self.width:
            self.running.append(self.queue.pop(0))
        for req in list(self.running):
            for _ in range(2 if self.n % 3 == 0 else 1):
                if len(req.output) < req.max_new_tokens:
                    req.output.append(self.n % 7)
            if len(req.output) >= req.max_new_tokens:
                req.state = self.state.FINISHED
                self.running.remove(req)

    def metrics(self):
        return {"prefix_hits": self.n // 5, "preemptions": self.n // 11}


@pytest.mark.parametrize("scenario", ttrace.SCENARIOS)
def test_replay_agrees_on_a_scripted_engine(scenario):
    kw = dict(seed=5, n_requests=10, prompt_hi=16, gen_cap=14)
    rt = treplay.replay(_ScriptedEngine(TState),
                        ttrace.generate(scenario, **kw))
    rj = jreplay.replay(_ScriptedEngine(JState),
                        jtrace.generate(scenario, **kw))
    assert rt.counters() == rj.counters()
    assert rt.outputs == rj.outputs
    assert (rt.steps, rt.idle_fastforwards) == (rj.steps,
                                                rj.idle_fastforwards)
    assert {k: vars(v) for k, v in rt.timings.items()} == \
        {k: vars(v) for k, v in rj.timings.items()}
    slo = dict(ttft_s=0.5, tpot_s=0.1)
    assert treplay.score(rt, treplay.Slo(**slo)).as_dict() == \
        jreplay.score(rj, jreplay.Slo(**slo)).as_dict()


def test_score_agrees_on_hand_built_timings():
    def result(mod, trace_mod):
        trace = trace_mod.Trace(name="t", scenario="mixed", seed=0,
                                vocab_size=8, step_period=0.1, requests=[])
        t = mod.RequestTiming
        timings = {0: t(0, 0, 0, first_token_step=2, finish_step=6,
                        output_tokens=5),
                   1: t(1, 0, 0, first_token_step=4, finish_step=4,
                        output_tokens=1),
                   2: t(2, 3, 3)}
        return mod.ReplayResult(trace=trace, outputs={}, timings=timings,
                                steps=7, idle_fastforwards=1,
                                metrics={"prefix_hits": 3, "preemptions": 2})

    rt, rj = result(treplay, ttrace), result(jreplay, jtrace)
    assert rt.counters() == rj.counters()
    for ttft, tpot in ((0.4, 0.1), (0.3, 0.1), (0.3, 0.05)):
        assert (treplay.score(rt, treplay.Slo(ttft, tpot)).as_dict()
                == jreplay.score(rj, jreplay.Slo(ttft, tpot)).as_dict())
    empty = [mod.ReplayResult(trace=r.trace, outputs={}, timings={}, steps=0,
                              idle_fastforwards=0)
             for mod, r in ((treplay, rt), (jreplay, rj))]
    assert not treplay.score(empty[0], treplay.Slo(10.0, 10.0)).ok
    assert not jreplay.score(empty[1], jreplay.Slo(10.0, 10.0)).ok


def _edit(path, fn):
    """Rewrite ``path`` (benchmark JSON) with ``fn`` applied to each row's
    parsed derived dict."""
    results = json.loads(path.read_text())
    for r in results[0]["rows"]:
        d = ttable.parse_derived(r["derived"])
        fn(r["name"], d)
        r["derived"] = ";".join(f"{k}={v}" for k, v in d.items())
    path.write_text(json.dumps(results))


def _regress(name, d):
    if name == "trace_mixed_fcfs":
        d["steps"] = str(round(int(d["steps"]) * 1.25))


def _drift(name, d):
    if name == "trace_bursty_prio":
        d["out_tokens"] = str(int(d["out_tokens"]) + 1)


@pytest.mark.parametrize("case", ["clean", "regression", "drift", "schema"])
def test_gate_agrees_with_the_reference(tmp_path, case, capsys):
    cur = tmp_path / "cur.json"
    shutil.copy(BENCH, cur)
    if case == "regression":
        _edit(cur, _regress)
    elif case == "drift":
        _edit(cur, _drift)
    elif case == "schema":
        results = json.loads(cur.read_text())
        results[0]["schema_version"] = 99
        cur.write_text(json.dumps(results))
    argv = ["--baseline", str(BENCH), "--current", str(cur)]
    codes = (tgate.main(argv), jgate.main(argv))
    assert codes[0] == codes[1] == {"clean": 0, "regression": 1, "drift": 1,
                                    "schema": 2}[case]
    capsys.readouterr()
    if case == "schema":
        return
    rows = [mod.collect_rows(json.loads(p.read_text()), str(p))
            for mod in (tgate, jgate) for p in (BENCH, cur)]
    regs_t, cmp_t = tgate.compare(rows[0], rows[1], 0.2)
    regs_j, cmp_j = jgate.compare(rows[2], rows[3], 0.2)
    assert cmp_t == cmp_j and len(cmp_t) == 32
    assert [str(r) for r in regs_t] == [str(r) for r in regs_j]
    assert len(regs_t) == (0 if case == "clean" else 1)
    assert tgate.GATE_COLUMNS == tuple(
        tgate.Column(c.name, c.direction, c.min_abs)
        for c in jgate.GATE_COLUMNS)
