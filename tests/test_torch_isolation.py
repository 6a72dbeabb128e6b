"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX, the JAX package or the reference's
``benchmarks``; the serving modules
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
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")]
    assert bad == []


_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
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
import repro_torch.perf, repro_torch.perf.gate, repro_torch.perf.replay
import repro_torch.perf.table, repro_torch.perf.trace
import repro_torch.serving.spec, repro_torch.serving.spec.draft_model
import repro_torch.serving.spec.ngram, repro_torch.serving.spec.proposer
import repro_torch.serving.spec.verify, repro_torch.bench.trace_replay
import repro_torch.serving.disagg, repro_torch.serving.disagg.frontend
import repro_torch.bench.disagg, repro_torch.examples.serve_llm
import repro_torch.configs.llama31_8b, repro_torch.configs.llama31_70b
import repro_torch.configs.qwen2_1_5b, repro_torch.configs.qwen3_32b
import repro_torch.configs.internlm2_20b
import repro_torch.perf.autotune, repro_torch.analysis.sanitize
import repro_torch.layers.moe, repro_torch.configs.granite_moe_1b_a400m
import repro_torch.configs.qwen3_moe_235b_a22b
import repro_torch.tree, repro_torch.optim, repro_torch.optim.optimizer
import repro_torch.optim.schedules, repro_torch.optim.adafactor
import repro_torch.training, repro_torch.training.losses
import repro_torch.training.remat, repro_torch.training.train_step
import repro_torch.training.trainer, repro_torch.checkpoint
import repro_torch.checkpoint.manager, repro_torch.distributed
import repro_torch.distributed.elastic, repro_torch.launch.train
import repro_torch.examples.quickstart, repro_torch.examples.train_dlrm
import repro_torch.examples.fault_tolerant_train, repro_torch.data.pipeline
import repro_torch.models.api, repro_torch.models.stacking
import repro_torch.models.rwkv6, repro_torch.models.zamba2
import repro_torch.models.whisper, repro_torch.layers.rwkv
import repro_torch.layers.ssm, repro_torch.serving.steps
import repro_torch.configs.rwkv6_1_6b, repro_torch.configs.zamba2_2_7b
import repro_torch.configs.whisper_tiny, repro_torch.configs.internvl2_26b
import repro_torch.bench.llm_e2e, repro_torch.bench.saturation
import repro_torch.bench.energy, repro_torch.launch.dryrun
import repro_torch.roofline.model_flops, repro_torch.configs
import repro_torch.distributed.collectives, repro_torch.distributed.sharding
import repro_torch.launch.mesh, repro_torch.bench.collectives
import repro_torch.bench.sharded, repro_torch.bench.sharded_train
import repro_torch.distributed.act_sharding
import repro_torch.distributed.pipeline, repro_torch.distributed.compression
import repro_torch.models.mesh_lm, repro_torch.bench.sharded_steps
assert not any(m.split(".")[0] in ("jax", "repro", "benchmarks")
               for m in sys.modules)
print("ok")
"""


_MESH_BLOCKER = _BLOCKER.split("import repro_torch.serving.engine")[0] + """
import repro_torch.distributed.collectives, repro_torch.distributed.sharding
import repro_torch.launch.mesh, repro_torch.bench.collectives
import repro_torch.bench.sharded
assert not any(m.split(".")[0] in ("jax", "repro", "benchmarks")
               for m in sys.modules)
print("ok")
"""


def test_mesh_modules_import_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _MESH_BLOCKER],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    files = [PORT / "launch" / "mesh.py", PORT / "bench" / "collectives.py",
             PORT / "bench" / "sharded.py",
             *sorted((PORT / "distributed").glob("*.py"))]
    assert all(f.exists() for f in files)
    assert [(f.name, n) for f in files for n in _imports(f)
            if n.split(".")[0] in ("jax", "jaxlib", "repro",
                                   "benchmarks")] == []


_TRAIN_MESH_BLOCKER = _BLOCKER.split("import repro_torch.serving.engine")[0] + """
import repro_torch.distributed.act_sharding, repro_torch.distributed.pipeline
import repro_torch.distributed.compression, repro_torch.bench.sharded_train
import repro_torch.training.train_step, repro_torch.launch.train
import repro_torch.layers.moe, repro_torch.models.dlrm
import repro_torch.core.embedding_api, repro_torch.optim.optimizer
assert not any(m.split(".")[0] in ("jax", "repro", "benchmarks")
               for m in sys.modules)
print("ok")
"""


def test_training_mesh_modules_import_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _TRAIN_MESH_BLOCKER],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    files = [PORT / "bench" / "sharded_train.py",
             PORT / "training" / "train_step.py",
             *[PORT / "distributed" / f"{n}.py"
               for n in ("act_sharding", "pipeline", "compression")]]
    assert all(f.exists() for f in files)
    assert [(f.name, n) for f in files for n in _imports(f)
            if n.split(".")[0] in ("jax", "jaxlib", "repro",
                                   "benchmarks")] == []


_SERVE_MESH_BLOCKER = (_BLOCKER.split("import repro_torch.serving.engine")[0]
                       + """
import repro_torch.models.mesh_lm, repro_torch.bench.sharded_steps
import repro_torch.serving.steps, repro_torch.launch.dryrun
import repro_torch.launch.mesh, repro_torch.roofline.analysis
import repro_torch.distributed.collectives, repro_torch.distributed.sharding
import repro_torch.models.transformer, repro_torch.models.rwkv6
import repro_torch.models.zamba2, repro_torch.models.whisper
import repro_torch.layers.attention, repro_torch.layers.mlp
import repro_torch.layers.rwkv, repro_torch.layers.ssm
import repro_torch.bench.sharded_train
assert not any(m.split(".")[0] in ("jax", "repro", "benchmarks")
               for m in sys.modules)
print("ok")
""")


def test_serving_mesh_and_dry_run_modules_import_with_jax_blocked():
    # the sharded serving steps, the families on a mesh and the dry run's
    # production meshes: every module new or changed for them
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _SERVE_MESH_BLOCKER],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    files = [PORT / "models" / "mesh_lm.py",
             PORT / "bench" / "sharded_steps.py",
             PORT / "serving" / "steps.py", PORT / "launch" / "dryrun.py",
             PORT / "launch" / "mesh.py",
             PORT / "roofline" / "analysis.py",
             *[PORT / "models" / f"{n}.py"
               for n in ("transformer", "rwkv6", "zamba2", "whisper")],
             *[PORT / "layers" / f"{n}.py"
               for n in ("attention", "mlp", "rwkv", "ssm")],
             *[PORT / "distributed" / f"{n}.py"
               for n in ("collectives", "sharding")],
             PORT / "bench" / "sharded_train.py"]
    assert all(f.exists() for f in files)
    assert [(f.name, n) for f in files for n in _imports(f)
            if n.split(".")[0] in ("jax", "jaxlib", "repro",
                                   "benchmarks")] == []


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


def test_replay_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.bench import trace_replay
    from repro_torch.launch import serve
    from repro_torch.serving.spec import DraftModelProposer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trace_replay.main(["--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "smollm-360m", "--reduced", "--spec", "ngram",
                    "--overlap", "on"])
    # the draft model is built on the engine's device, never elsewhere
    engine = type("E", (), {"cfg": serve.get_config("smollm-360m").reduced(
        dtype="float32"), "device": "cuda"})()
    with pytest.raises(RuntimeError, match="cuda"):
        DraftModelProposer().bind(engine)


def test_paper_path_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.bench import paged_attention_bench
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        paged_attention_bench.main(["--quick"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "smollm-360m", "--reduced", "--attn-impl",
                    "chunked"])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b",
                                  "whisper-tiny", "internvl2-26b"])
def test_family_entry_points_default_to_the_card(monkeypatch, arch):
    from repro_torch.config import get_config
    from repro_torch.examples import quickstart
    from repro_torch.launch import train
    from repro_torch.models.api import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(arch).reduced(dtype="float32")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main(["--arch", arch])
    if arch != "whisper-tiny":      # the launcher's batches are tokens only
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", arch, "--reduced", "--steps", "1"])
    assert build_model(cfg, device="cpu").device.type == "cpu"


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


def test_disagg_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.bench import disagg
    from repro_torch.config import ServeConfig, get_config
    from repro_torch.examples import serve_llm
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.serving.disagg import DisaggEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        disagg.main(["--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_llm.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "llama31-8b", "--reduced", "--roles",
                    "prefill,decode", "--host-blocks", "4"])
    cfg = get_config("llama31-8b").reduced(dtype="float32")
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        DisaggEngine(model, model.init(0), cfg,
                     ServeConfig(model=cfg.name, roles="prefill,decode"),
                     num_blocks=8)
