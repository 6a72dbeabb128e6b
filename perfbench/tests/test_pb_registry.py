"""A configuration, a traffic mix or a metric is found by its name: adding
its file (and its entry in BENCHMARK.json) is enough."""
import json
import shutil

from perfbench.harness import spec


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
