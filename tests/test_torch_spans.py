"""The port's span recorder (``repro_torch.perf.spans``): its bookkeeping by
hand on an injected clock, nothing kept or entered while it is off, a
tiny float32 engine that serves the same greedy streams and counters with
it on as off and records each engine span once per step, and the spans on
a CPU ``torch.profiler`` timeline, nested as the log says."""
import contextlib
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.config import ServeConfig, get_config
from repro_torch.models.api import build_model
from repro_torch.perf import spans
from repro_torch.serving import engine as tengine

ENGINE_SPANS = ("engine.propose", "engine.schedule", "engine.render",
                "engine.pool_sync", "engine.dispatch", "engine.wait",
                "engine.commit")


class Clock:
    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


@pytest.fixture(autouse=True)
def closed():
    """Each test starts and ends with no recording open."""
    if spans.active() is not None:
        spans.stop()
    yield
    if spans.active() is not None:
        spans.stop()


def test_nesting_self_time_and_steps_by_hand():
    clock = Clock()
    clock.now = 5
    with spans.recording(clock) as log:
        assert log.t_start == 5 and spans.next_step() == 0
        clock.now = 10
        with spans.span("a"):
            clock.now = 20
            with spans.span("b"):
                clock.now = 50
            clock.now = 60
            with spans.span("b"):
                clock.now = 65
            clock.now = 100
        assert spans.next_step() == 1
        clock.now = 110
        with spans.span("c", step=0):
            clock.now = 111
            with spans.span("d"):
                clock.now = 130
        spans.add_ns("x", 7)
        spans.add_ns("x", 3)
        spans.count("n", 4)
        spans.count("n")
        spans.mark(3, "submit")
        clock.now = 140
        spans.mark(3, "submit")             # the first stamp stays
        spans.mark(3, "admit")
        spans.mark(4, "first_lanes", after="admit")     # never admitted
        spans.mark(3, "first_lanes", after="admit")
        spans.gauge("g", 2)
        spans.gauge("g", 9)
        clock.now = 150
    assert log.t_stop == 150 and spans.active() is None
    got = [(r.name, r.step, r.start, r.end, r.parent) for r in log.records]
    assert got == [("a", 0, 10, 100, -1), ("b", 0, 20, 50, 0),
                   ("b", 0, 60, 65, 0), ("c", 0, 110, 130, -1),
                   ("d", 0, 111, 130, 3)]
    assert log.stats == {"a": [1, 90, 55], "b": [2, 35, 35],
                         "c": [1, 20, 1], "d": [1, 19, 19]}
    assert log.ns == {"x": 10} and log.counts == {"n": 5}
    assert log.marks == {3: {"submit": 130, "admit": 140,
                             "first_lanes": 140}}
    assert log.deltas() == {"g": 7} and log.steps == 2


def test_off_keeps_nothing_and_enters_no_profiler_range(monkeypatch):
    import torch._C._profiler as prof

    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("a profiler range was entered")

    monkeypatch.setattr(prof, "_RecordFunctionFast", Refused)
    assert spans.active() is None
    ctx = spans.span("engine.step", step=spans.next_step())
    with ctx:
        spans.add_ns("kv.evict", 5)
        spans.count("kv.cached_free_at_evict", 3)
        spans.mark(0, "submit")
        spans.gauge("prefix_hits", 1)
    assert ctx is spans.span("other")       # one shared no-op context
    assert spans.next_step() is None and spans.current_step() is None
    assert spans.active() is None
    with spans.recording() as log:          # on, with no profiler running
        with spans.span("a"):
            pass
    assert [r.name for r in log.records] == ["a"]


def test_follows_the_profiler_flag(monkeypatch):
    import torch.autograd.profiler as autograd_profiler

    spans.follow_profiler()                 # no profiler: stays off
    assert spans.active() is None
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    spans.follow_profiler()
    followed = spans.active()
    assert followed is spans.profiled_log() is not None
    with pytest.raises(RuntimeError):       # its profiler still runs
        spans.start()
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", False)
    fresh = spans.start()                   # the stale one is closed first
    assert followed.t_stop is not None and spans.active() is fresh
    spans.follow_profiler()                 # an explicit one stays open
    assert spans.stop() is fresh and spans.profiled_log() is followed


@pytest.fixture(scope="module")
def served():
    """``run(arch, spans_on, **serve)``: the engine after every request
    finished, and the log when spans were on."""
    built = {}

    def run(arch, on, **kw):
        if arch not in built:
            cfg = get_config(arch).reduced(dtype="float32")
            model = build_model(cfg, device="cpu")
            built[arch] = cfg, model, model.init(0)
        cfg, model, params = built[arch]
        serve = ServeConfig(model=cfg.name, kv_block_size=4, max_batch=3,
                            spec_k=3, **kw)
        eng = tengine.ServingEngine(model, params, cfg, serve, num_blocks=14,
                                    device="cpu")
        rng = np.random.default_rng(3)
        with spans.recording() if on else contextlib.nullcontext() as log:
            for i in range(6):
                motif = rng.integers(0, cfg.vocab_size, (3,), dtype=np.int32)
                prompt = np.concatenate([np.tile(motif, 3), [i]])
                eng.submit(tengine.Request(req_id=i, max_new_tokens=6,
                                           prompt=prompt.astype(np.int32)))
            eng.run_until_done()
        return eng, log

    return run


def _plain(m):
    """``metrics()`` without what the clock sets."""
    out = {k: v for k, v in m.items() if not k.endswith("_s")}
    out["phase_s"] = sorted(m["phase_s"])
    return out


CASES = [("smollm-360m", dict(overlap=False)),
         ("smollm-360m", dict(overlap=True)),
         ("smollm-360m", dict(spec="ngram")),
         ("granite-moe-1b-a400m", dict(overlap=False))]


@pytest.mark.parametrize("arch,kw", CASES,
                         ids=[f"{a}-{k}" for a, k in CASES])
def test_engine_serves_the_same_and_records_each_span_once_a_step(
        served, arch, kw):
    off, _ = served(arch, False, **kw)
    on, log = served(arch, True, **kw)
    streams = {r.req_id: list(r.output) for r in on.finished}
    assert streams == {r.req_id: list(r.output) for r in off.finished}
    assert _plain(on.metrics()) == _plain(off.metrics())
    m = on.metrics()
    if kw.get("spec"):
        assert m["spec"]["drafted_steps"] > 0
    L = on.cfg.num_layers
    by_step = {}
    for r in log.records:
        by_step.setdefault(r.step, Counter())[r.name] += 1
    assert sorted(by_step) == list(range(log.steps))
    dispatched = 0
    for step, names in by_step.items():
        assert names["engine.step"] == 1, step
        assert all(names[n] <= 1 for n in ENGINE_SPANS), (step, names)
        if names["engine.dispatch"]:
            dispatched += 1
            assert all(names[n] == 1 for n in ENGINE_SPANS), (step, names)
            assert names["model.attention"] == L
            assert names["model.moe"] == (L if on.cfg.moe else 0)
    assert dispatched == m["steps"]
    for r in log.records:       # a resolve runs in its own step or the next
        if r.name in ("engine.wait", "engine.commit"):
            parent = log.records[r.parent]
            assert parent.name == "engine.step"
            assert parent.step in (r.step, r.step + 1)
            assert kw.get("overlap") or parent.step == r.step
    deltas = log.deltas()
    assert deltas["alloc.cache_evictions"] == on.alloc.cache_evictions > 0
    assert deltas["prefix_misses"] == on.alloc.prefix_misses
    assert log.counts["kv.cached_free_at_evict"] >= on.alloc.cache_evictions
    assert log.ns["kv.evict"] > 0
    assert sorted(log.marks) == list(range(6))
    for events in log.marks.values():
        assert events["submit"] <= events["admit"] <= events["first_lanes"]
    for name, (n, total, self_ns) in log.stats.items():
        assert 0 <= self_ns <= total, name


def test_spans_on_the_profiler_timeline(served):
    """Under a CPU ``torch.profiler`` the engine opens a recording itself
    (``follow_profiler``); each span is one ``repro_torch.<name>`` event,
    inside its parent's event, and the first span after the profiler
    stopped closes the recording."""
    from torch.profiler import ProfilerActivity, profile

    eng, _ = served("smollm-360m", False, overlap=True)
    for i in range(3):
        eng.submit(tengine.Request(req_id=10 + i,
                                   prompt=np.arange(5 + i, dtype=np.int32),
                                   max_new_tokens=4))
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        for _ in range(4):
            eng.step()
    finally:
        prof.stop()
    log = spans.profiled_log()
    assert log is not None and spans.active() is log and log.steps == 4
    with spans.span("after"):       # the profiler has stopped: closes it
        pass
    assert spans.active() is None and log.t_stop is not None
    eng.run_until_done()
    assert spans.profiled_log() is log and spans.active() is None
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(spans.PREFIX):
            assert e.device_type().name == "CPU"
            events.setdefault(e.name()[len(spans.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    records = [r for r in log.records if r.end and r.start]
    assert Counter(r.name for r in records) == Counter(
        {k: len(v) for k, v in events.items()})
    matched = {}
    for name, evs in events.items():
        mine = sorted((r for r in records if r.name == name),
                      key=lambda r: r.start)
        for r, ev in zip(mine, sorted(evs)):
            matched[id(r)] = ev
    for r in records:
        if r.parent >= 0:
            s, e = matched[id(r)]
            ps, pe = matched[id(log.records[r.parent])]
            assert ps <= s and e <= pe, r
    assert torch.autograd.profiler._is_profiler_enabled is False
