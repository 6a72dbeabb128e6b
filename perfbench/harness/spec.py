"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; a configuration names its
``system`` and its ``reference``, and may name its ``model`` module and its
``counts`` module (each a path under ``perfbench/``; without the key,
``harness/model.py`` and ``counts/transformer.py``); a mix names its
generator (``kind``); a metric is the reader ``metrics/<name>.py``.
Adding a file of one of these kinds, and its entry in ``BENCHMARK.json``,
is all a new cell, configuration, mix or metric needs.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parents[1]     # perfbench/
ROOT = PACKAGE.parent                             # the checkout
MODULE_KEYS = ("reference", "model", "counts")    # paths under perfbench/


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, kind: str) -> ModuleType:
    """The module at ``path`` (a name may hold dots, so import by path),
    kept in ``sys.modules`` under a key of its kind and its path."""
    tag = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:12]
    key = f"perfbench_{kind}_{tag}"
    if key in sys.modules:
        return sys.modules[key]
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def _names(folder: Path, suffix: str) -> List[str]:
    return sorted(p.name[:-len(suffix)] for p in folder.glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def list_configs(package: Path = PACKAGE) -> List[str]:
    return _names(package / "configs", ".json")


def list_traffic(package: Path = PACKAGE) -> List[str]:
    return _names(package / "traffic", ".json")


def list_metrics(package: Path = PACKAGE) -> List[str]:
    return _names(package / "metrics", ".py")


class Benchmark:
    """``BENCHMARK.json`` of a checkout, and the files of its cells."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.package = self.root / "perfbench"
        self.data = load_json(self.root / "BENCHMARK.json")
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> dict:
        try:
            return self.cells[name]
        except KeyError:
            raise KeyError(f"unknown workload {name!r}; known: "
                           f"{sorted(self.cells)}") from None

    def config(self, cell: dict) -> dict:
        """The configuration file, with the modules it names resolved
        under this checkout's ``perfbench/``."""
        entry = self.configs[cell["config"]]
        config = load_json(self.root / entry["file"])
        for key in MODULE_KEYS:
            if key in config:
                config[key] = str(self.package / config[key])
        return config

    def traffic(self, cell: dict) -> dict:
        return load_json(self.package / "traffic" / f"{cell['traffic']}.json")

    def generator(self, traffic: dict) -> ModuleType:
        return load_module(self.package / "traffic" / f"{traffic['kind']}.py",
                           "traffic")

    def system(self, config: dict) -> ModuleType:
        return load_module(self.package / "systems" / f"{config['system']}.py",
                           "system")

    def metrics(self, cell_name: str, trace: bool) -> List[dict]:
        """The cell's metrics: its end-to-end ones untraced, its per-layer
        ones traced (a metric with ``workloads`` only in those cells)."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell_name in m.get("workloads", [cell_name])]

    def reader(self, metric: dict) -> ModuleType:
        return load_module(self.package / "metrics" / f"{metric['name']}.py",
                           "metric")


def model_module(config: dict) -> ModuleType:
    """The module that gives a configuration's model: ``dims(config)``,
    ``draw(d, seed, device)``, ``num_params(d)``, ``build(config, d,
    device)`` and ``moe_module()``; ``harness/model.py`` unless the file
    names another under ``model``."""
    if "model" not in config:
        from perfbench.harness import model
        return model
    return load_module(PACKAGE / config["model"], "model")


def counts_module(config: dict) -> ModuleType:
    """The module of a configuration's counts (``counts/transformer.py``
    says what it exposes); that one unless the file names another under
    ``counts``."""
    if "counts" not in config:
        from perfbench.counts import transformer
        return transformer
    return load_module(PACKAGE / config["counts"], "counts")


def read_metrics(bench: Benchmark, cell_name: str, trace: bool,
                 window) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of the cell's metrics; a reader that
    finds nothing to read returns None and its metric is left out."""
    out: Dict[str, dict] = {}
    for m in bench.metrics(cell_name, trace):
        value: Optional[float] = bench.reader(m).read(window)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
