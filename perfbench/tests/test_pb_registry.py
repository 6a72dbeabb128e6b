"""A configuration, a traffic mix or a metric is found by its name: adding
its file (and its entry in BENCHMARK.json) is enough.  So are the counts
and the model a configuration's file names: the readers and a served run
take them, and a path that names no file fails with that path."""
import json
import re
import shutil

import pytest

from perfbench.harness import spec

from .conftest import DATA


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.PACKAGE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_files_are_listed_and_resolved(tmp_path):
    root = _copy(tmp_path)
    pb = root / "perfbench"
    before = (spec.list_configs(pb), spec.list_traffic(pb),
              spec.list_metrics(pb))
    (pb / "configs" / "newmodel.json").write_text(
        (pb / "configs" / "smollm.json").read_text())
    mix = json.loads((pb / "traffic" / "classify.json").read_text())
    mix["clients"] = 7
    (pb / "traffic" / "new.mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "steps.count.py").write_text(
        "def read(w):\n    return len(w.steps)\n")
    assert spec.list_configs(pb) == sorted(before[0] + ["newmodel"])
    assert spec.list_traffic(pb) == sorted(before[1] + ["new.mix"])
    assert spec.list_metrics(pb) == sorted(before[2] + ["steps.count"])

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "newmodel", "source": "x",
                             "file": "perfbench/configs/newmodel.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "newmodel.new", "config": "newmodel",
                               "traffic": "new.mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps.count", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving loop", "moves": "tok_s",
                               "workloads": ["newmodel.new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    b = spec.Benchmark(root)
    cell = b.cell("newmodel.new")
    assert b.config(cell)["arch"] == "smollm-360m"
    assert b.traffic(cell)["clients"] == 7
    assert b.generator(b.traffic(cell)).make is not None
    assert b.system(b.config(cell)).run is not None
    names = [m["name"] for m in b.metrics("newmodel.new", True)]
    assert "steps.count" in names
    assert "steps.count" not in [m["name"] for m in
                                 b.metrics("smollm.classify", True)]
    window = type("W", (), {"steps": [1, 2, 3], "phase_s": {},
                            "trace": None})()
    got = spec.read_metrics(b, "newmodel.new", True, window)
    assert got["steps.count"] == {"value": 3.0, "unit": "steps"}


# fixed numbers, powers of two, so sums of them are exact
FIXED_COUNTS = '''
def step_flops(d, lanes, sampled_rows):
    return 2.0 ** 40


def b1_step_bound_s(d, lanes, block_size):
    return 2.0 ** -9, "bytes"


def moe_step_bound_s(d, tokens):
    return 2.0 ** -8, "flops"
'''

TINY_MODEL = '''
from perfbench.harness import model as base

CALLS = []
dims, num_params, moe_module = base.dims, base.num_params, base.moe_module


def draw(d, seed, device):
    CALLS.append("draw")
    return base.draw(d, seed, device)


def build(config, d, device):
    CALLS.append("build")
    return base.build(config, d, device)
'''


def _own_config(tmp_path, **modules):
    """A checkout with a configuration (the tiny MoE model) that names the
    given modules, and its cell; the modules' files as given."""
    root = _copy(tmp_path)
    pb = root / "perfbench"
    config = spec.load_json(DATA / "tiny_moe.json")
    for key, (path, text) in modules.items():
        config[key] = path
        if text is not None:
            (pb / path).parent.mkdir(exist_ok=True)
            (pb / path).write_text(text)
    (pb / "configs" / "tinyown.json").write_text(json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinyown", "source": "x",
                             "file": "perfbench/configs/tinyown.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tinyown.tiny", "config": "tinyown",
                               "traffic": "classify", "chips": 1,
                               "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b = spec.Benchmark(root)
    return b, b.config(b.cell("tinyown.tiny"))


class _Ticks:
    """A clock that moves 10 ms at each reading: the window is then a fixed
    number of steps, whatever else the machine runs."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 0.01
        return self.now


def _serve(config, monkeypatch):
    from perfbench.systems import serve

    monkeypatch.setattr(serve, "clock", _Ticks())
    mix = spec.load_json(DATA / "tiny_mix.json")
    gen = spec.load_module(spec.PACKAGE / "traffic" / "closed_loop.py",
                           "traffic")
    return serve.run(config, mix, gen, seed=2 ** 33 + 7, seconds=1.5,
                     trace=False, device="cpu", t_start=0.0,
                     log=lambda m: None)


def test_a_config_brings_its_own_counts_and_model(tmp_path,
                                                  monkeypatch):
    from perfbench.harness import trace

    b, config = _own_config(
        tmp_path, counts=("counts/fixed.py", FIXED_COUNTS),
        model=("models/tiny.py", TINY_MODEL))
    pb = b.package
    assert config["counts"] == str(pb / "counts" / "fixed.py")
    counts = spec.counts_module(config)
    models = spec.model_module(config)
    assert counts.__file__ == str(pb / "counts" / "fixed.py")
    assert models.__file__ == str(pb / "models" / "tiny.py")

    out = _serve(config, monkeypatch)
    assert out.correct and out.failed == 0, out.checks
    # the program's weights, its model, the reference's second draw
    assert models.CALLS == ["draw", "build", "draw"]
    w = out.window
    assert w.counts is counts and w.steps
    w.trace = trace.TraceSummary(
        busy_s=1.0, device_s_by_kernel={"ragged_attention_kernel": 0.25},
        span_device_s={"moe": 0.5})
    got = {m: b.reader({"name": m}).read(w)
           for m in ("mfu", "b1_roofline", "moe_roofline")}
    n = len(w.steps)
    assert got == {"mfu": 100.0 * n * 2.0 ** 40 / (w.seconds * 989e12),
                   "b1_roofline": 100.0 * n * 2.0 ** -9 / 0.25,
                   "moe_roofline": 100.0 * n * 2.0 ** -8 / 0.5}


@pytest.mark.parametrize("key", ["counts", "model"])
def test_a_missing_counts_or_model_file_fails_with_its_path(tmp_path, key,
                                                           monkeypatch):
    b, config = _own_config(tmp_path, **{key: (f"{key}/nowhere.py", None)})
    path = str(b.package / key / "nowhere.py")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        _serve(config, monkeypatch)
