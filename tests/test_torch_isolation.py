"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package; the serving modules
import where ``jax`` cannot be imported; entry points default to the card
and raise without one; ``chip_smoke.py`` fails without a card and alone."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import repro_torch.serving.engine, repro_torch.launch.serve
import repro_torch.models.bridge, repro_torch.kernels.build
import repro_torch.bench.recsys_e2e, repro_torch.bench.embedding_tables
import repro_torch.kernels.batched_embedding
import repro_torch.bench.paged_attention_bench
import repro_torch.kernels.paged_attention
import repro_torch.roofline.analysis, repro_torch.bench.run
import repro_torch.bench.stream, repro_torch.bench.gather_scatter
import repro_torch.bench.gather_scatter_turns, repro_torch.bench.turns
import repro_torch.bench.stream_turns, repro_torch.kernels.stream.cases
import repro_torch.bench.gemm_roofline, repro_torch.kernels.launch
import repro_torch.kernels.stream.ops, repro_torch.kernels.stream.ref
import repro_torch.kernels.gather_scatter.ops
import repro_torch.kernels.gather_scatter.ref
import repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.flash_attention.ref
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print("ok")
"""


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _BLOCKER], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.config import ServeConfig, get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-360m").reduced(dtype="float32")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model, params, cfg, ServeConfig(model=cfg.name),
                      num_blocks=8)


def test_dlrm_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.bench import embedding_tables, recsys_e2e
    from repro_torch.models.api import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("rm1", "rm2"):
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(arch)
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(arch, use_batched=False)
    with pytest.raises(RuntimeError, match="cuda"):
        recsys_e2e.main(["--rows", "64"])
    with pytest.raises(RuntimeError, match="cuda"):
        embedding_tables.main([])
    assert build_model("rm2", device="cpu").device.type == "cpu"


def test_paper_path_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.bench import paged_attention_bench
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        paged_attention_bench.main(["--quick"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "smollm-360m", "--reduced", "--attn-impl",
                    "chunked"])


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""        # no card, even where there is one
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_alone(tmp_path, alone):
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    r = _run_smoke(cwd)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
