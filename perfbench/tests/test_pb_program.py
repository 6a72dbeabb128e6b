"""The program's spans in the benchmark: the device-trace reduction by the
innermost program span, checked by hand on synthetic events and unchanged
by program ranges on the device timeline; the trace's existing fields
unchanged by the program's host ranges, and program ranges the trace
counts as device kernels flagged in the notes; the per-step breakdown and
the two readers of the program's span log checked by hand, each None
where the program keeps no log."""
import sys
from types import SimpleNamespace

import pytest

from perfbench.harness import program, spec
from perfbench.harness import trace as trace_lib
from perfbench.systems import serve
from repro_torch.perf import spans

BENCH = spec.Benchmark()
READERS = ("evict_ms_per_step", "queue_p95_ms")


class Ev:
    """A kineto event: name, device, start, duration, thread, ids."""

    def __init__(self, name, start, dur, *, device="CPU", cid=0, lcid=0):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._c, self._l = device, cid, lcid

    def name(self):
        return self._n

    def device_type(self):
        return SimpleNamespace(name=self._dev)

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def start_thread_id(self):
        return 1

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def _kernel(start, dur, cid, lcid=0):
    return Ev("gemm", start, dur, device="CUDA", cid=cid, lcid=lcid)


BASE = [
    Ev("perfbench.render", 8, 34), Ev("perfbench.forward", 42, 46),
    Ev("cudaLaunchKernel", 45, 1, cid=1), Ev("cudaLaunchKernel", 55, 1, cid=2),
    Ev("cudaLaunchKernel", 105, 1, cid=3),
    _kernel(60, 10, 1), _kernel(80, 15, 2), _kernel(120, 10, 3, lcid=2),
    Ev("Memcpy HtoD", 0, 5, device="CUDA"),
]
PROGRAM = [
    Ev("repro_torch.engine.step", 0, 100), Ev("repro_torch.engine.render", 10, 30),
    Ev("repro_torch.engine.dispatch", 40, 50),
    Ev("repro_torch.model.attention", 50, 10),
]
# the same ranges mirrored onto the device timeline, as kineto mirrors a
# user-scope range (the program's are function-scope: none is expected)
DEVICE_SIDE = [
    Ev("repro_torch.engine.dispatch", 40, 50, device="CUDA"),
    Ev("repro_torch.model.attention", 62, 20, device="CUDA"),
]


def test_idle_device_time_and_launches_by_innermost_span_by_hand():
    got = program.on_device_trace(BASE + PROGRAM + [
        Ev("repro_torch.model.attention", 60, 20, device="CUDA")])
    # gaps: 5-60 (middle 32, in render), 70-80 (75, in dispatch: the
    # attention span closed at 60), 95-120 (107, in no span)
    assert got["idle_by_span"] == pytest.approx(
        {"engine.render": 55e-9, "engine.dispatch": 10e-9, "none": 25e-9})
    assert got["idle_outside_share"] == pytest.approx(25 / 90)
    assert got["launches_by_span"] == {"engine.step": 2,
                                       "engine.dispatch": 2,
                                       "model.attention": 1}
    assert got["device_s_by_span"] == pytest.approx(
        {"engine.step": 25e-9, "engine.dispatch": 25e-9,
         "model.attention": 15e-9})
    # the third kernel's linked id is the second launch's
    assert got["device_s_by_span_either_id"] == pytest.approx(
        {"engine.step": 35e-9, "engine.dispatch": 35e-9,
         "model.attention": 25e-9})
    assert got["spans"] == 4 and got["device_annotations"] == 1


def test_existing_trace_fields_unchanged_by_the_programs_host_ranges():
    plain = trace_lib.summarize(BASE, trace_lib.TraceSummary())
    both = trace_lib.summarize(BASE + PROGRAM, trace_lib.TraceSummary())
    for f in ("busy_s", "device_s_by_kernel", "launches", "span_device_s",
              "idle_by_host"):
        assert getattr(both, f) == getattr(plain, f), f
    # the program's ranges count among the host events, nowhere else
    assert both.kinds == dict(plain.kinds, host=plain.kinds.get("host", 0)
                              + len(PROGRAM))


def test_program_ranges_on_the_device_leave_the_programs_reduction_as_is():
    plain = program.on_device_trace(BASE + PROGRAM)
    mirrored = program.on_device_trace(BASE + PROGRAM + DEVICE_SIDE)
    assert plain.pop("device_annotations") == 0
    assert mirrored.pop("device_annotations") == len(DEVICE_SIDE)
    assert mirrored == plain


def test_program_ranges_the_trace_counts_as_kernels_are_flagged(monkeypatch):
    flag = "program ranges on the device, counted as kernels"
    reader = BENCH.reader({"name": "evict_ms_per_step"})
    w = _window(monkeypatch, _log())
    trace_lib.summarize(BASE + PROGRAM, w.trace)
    assert program.device_ranges(w) == {}
    reader.read(w)
    assert "program spans" in w.notes and flag not in w.notes
    w = _window(monkeypatch, _log())
    trace_lib.summarize(BASE + PROGRAM + DEVICE_SIDE, w.trace)
    want = {"repro_torch.engine.dispatch": 50e-9,
            "repro_torch.model.attention": 20e-9}
    assert program.device_ranges(w) == pytest.approx(want)
    reader.read(w)
    assert w.notes[flag] == pytest.approx(want)


T0 = 100.0


class Clock:
    now = int(T0 * 1e9) + 1

    def __call__(self):
        return self.now


def _window(monkeypatch, log):
    monkeypatch.setattr(spans, "profiled_log", lambda: log)
    records = [serve.Record(req=SimpleNamespace(req_id=i), client=0,
                            sent=T0) for i in range(4)]
    steps = [serve.Step(end=T0 + k, lanes=[], sampled=1) for k in (1, 2, 3)]
    return serve.Window(t0=T0, t1=T0 + 3.0, setup_s=1.0, dims=None,
                        block_size=16, records=records, steps=steps,
                        phase_s={"propose": 0.0, "schedule_render": 0.004,
                                 "commit": 0.001},
                        trace=trace_lib.TraceSummary())


def _log():
    clock = Clock()
    with spans.recording(clock) as log:
        for k in range(3):
            with spans.span("engine.step", step=spans.next_step()):
                with spans.span("engine.render"):
                    clock.now += 1_000_000
                with spans.span("engine.dispatch"):
                    clock.now += 1_500_000
                spans.add_ns("kv.evict", 2_000_000)
        at = int(T0 * 1e9)
        log.marks = {
            0: {"submit": at + 100_000_000, "admit": at + 150_000_000,
                "first_lanes": at + 300_000_000},       # 200 ms
            1: {"admit": at + 400_000_000,  # submitted before the recording
                "first_lanes": at + 500_000_000},
            2: {"submit": at + 200_000_000, "admit": at + 300_000_000,
                "first_lanes": at + 3_500_000_000},     # after the window
            3: {"submit": at + 1_000_000_000, "admit": at + 1_010_000_000,
                "first_lanes": at + 1_050_000_000},     # 50 ms
        }
    return log


def test_readers_by_hand(monkeypatch):
    w = _window(monkeypatch, _log())
    got = {name: BENCH.reader({"name": name}).read(w) for name in READERS}
    assert got == pytest.approx({"evict_ms_per_step": 2.0,
                                 "queue_p95_ms": 200.0})
    assert w.notes["program counters"]["kv.evict_ms"] == pytest.approx(6.0)
    queue = w.notes["program queue ms"]
    assert queue["requests"] == 2 and queue["max"] == pytest.approx(200.0)
    assert queue["admit_to_first_lanes_p95"] == pytest.approx(150.0)
    phases = w.notes["program host phases vs phase_s ms"]
    assert phases["spans"] == pytest.approx(3.0)
    assert phases["phase_s"] == pytest.approx(5.0)
    assert w.notes["program spans"]["engine.render"]["ms_per_step"] == (
        pytest.approx(1.0))
    assert w.notes["program ms a step, over steps"]["engine.dispatch"] == (
        pytest.approx({"p50": 1.5, "p95": 1.5, "max": 1.5}))


def test_per_step_breakdown_by_hand(monkeypatch):
    clock = Clock()
    with spans.recording(clock) as log:
        for k in range(4):
            with spans.span("engine.step", step=spans.next_step()):
                if k:           # the previous step's resolve, overlapped
                    with spans.span("engine.wait", step=k - 1):
                        clock.now += 1_000_000 * k
                with spans.span("engine.render"):
                    clock.now += 2_000_000
            if k == 2:          # the last step ends after the window
                clock.now += 4_000_000_000
    got = program.per_step_ms(_window(monkeypatch, log), log)
    # steps 0-2 ended in the window; each wait counts for the step it
    # resolves (step 2's ran inside step 3): 1, 2 and 3 ms
    want = {"engine.step": {"p50": 3.0, "p95": 4.0, "max": 4.0},
            "engine.wait": {"p50": 2.0, "p95": 3.0, "max": 3.0},
            "engine.render": {"p50": 2.0, "p95": 2.0, "max": 2.0}}
    assert got.keys() == want.keys()
    for name, ms in want.items():
        assert got[name] == pytest.approx(ms), name


def test_readers_find_nothing_without_the_programs_log(monkeypatch):
    w = _window(monkeypatch, None)
    assert all(BENCH.reader({"name": n}).read(w) is None for n in READERS)
    stale = _log()
    stale.t_start = int((T0 - 10) * 1e9)        # a recording of another run
    w = _window(monkeypatch, stale)
    assert all(BENCH.reader({"name": n}).read(w) is None for n in READERS)
    import repro_torch.perf

    monkeypatch.delattr(repro_torch.perf, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.perf.spans", None)
    w = _window(monkeypatch, _log())            # a program with no spans
    assert all(BENCH.reader({"name": n}).read(w) is None for n in READERS)
    assert not w.notes


@pytest.mark.parametrize("name", READERS)
def test_new_readers_are_listed_for_the_cells_they_read(name):
    entry = {m["name"]: m for m in BENCH.data["per_layer"]}[name]
    assert entry["source"] == "program_span"
    for cell in entry["workloads"]:
        assert entry in BENCH.metrics(cell, True)
