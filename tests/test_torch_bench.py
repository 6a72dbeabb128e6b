"""The port's DLRM bench modules on the CPU at tiny sweeps: the rows they
print, the launches they report, and the operations ``forward_cost``
counts against PyTorch's own count of the forward's matrix products;
how the attention-turns script cuts a ragged call to some sequences; and
how the shared turns runner takes each tree's package."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.bench import embedding_tables, recsys_e2e
from repro_torch.config import get_config
from repro_torch.data.pipeline import SyntheticRecSysDataset
from repro_torch.models.api import build_model


def test_recsys_e2e_rows():
    rows = recsys_e2e.run("cpu", rows=64, archs=("rm2",), batches=(4, 8))
    assert [r["name"] for r in rows] == [
        "recsys_rm2_single_B4", "recsys_rm2_batched_B4",
        "recsys_rm2_single_B8", "recsys_rm2_batched_B8"]
    for r in rows:
        assert r["finite"] and r["shape"] == (r["batch"],) and r["ms"] > 0
        assert r["calls"] == recsys_e2e.WARMUP + recsys_e2e.REPS + 1
        assert "device=cpu" in r["derived"] and "flops=" in r["derived"]
        assert ("speedup_vs_single=" in r["derived"]) == r["use_batched"]


@pytest.mark.parametrize("arch", ["rm1", "rm2"])
def test_forward_cost_counts_the_matrix_products(arch):
    cfg = dataclasses.replace(get_config(arch), num_embeddings=64)
    B = 4
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticRecSysDataset(cfg, B).batch_at(0).items()}
    with FlopCounterMode(display=False) as counter:
        model.forward(params, batch)
    ops, nbytes = recsys_e2e.forward_cost(cfg, B)
    T, L, D = cfg.num_tables, cfg.gathers_per_table, cfg.embedding_dim
    d = cfg.bottom_mlp[-1] + T * D
    assert ops - B * T * L * D - cfg.cross_layers * 3 * B * d == \
        counter.get_total_flops()
    weights = sum(w.numel() for layer in [*params["bottom"],
                                          *params["cross"], *params["top"]]
                  for w in layer.values())
    assert nbytes == 4 * (weights + B * T * L * D + B * T * L
                          + B * cfg.dense_features + B)


def test_embedding_tables_rows():
    rows = embedding_tables.run("cpu", dims=(16,), tables=(3,),
                                batches=(2,))
    assert [r["name"] for r in rows] == ["embed_single_T3_B2_D16",
                                         "embed_batched_T3_B2_D16"]
    assert rows[0]["derived"].startswith("launches=3;")
    # the plain version on the CPU launches no kernel
    assert rows[1]["derived"].startswith("launches=0;speedup_vs_single=")


@pytest.mark.parametrize("keep", [lambda n: n >= 2, lambda n: n == 1],
                         ids=["prefill", "decode"])
def test_attention_turns_selects_sequences_exactly(keep):
    """``attention_turns.select_sequences`` (the mixed step cut to its
    prefill or its decode lanes) leaves each kept lane's result as the
    whole call gives it, on the plain version."""
    import numpy as np

    from repro_torch.bench import attention_turns
    from repro_torch.core import attention_api as api
    from repro_torch.kernels.paged_attention.cases import (
        ARG_ORDER, SMALL, SMALL_CASES, ragged_case)

    c = ragged_case(np.random.default_rng(0),
                    **dict(SMALL, **SMALL_CASES["long_owner"]))
    args = [torch.from_numpy(c[k]) for k in ARG_ORDER]
    sub = attention_turns.select_sequences(args, keep)
    cu_q = c["cu_q_lens"]
    lanes = [t for j in range(len(c["seq_slot"]))
             if keep(cu_q[j + 1] - cu_q[j]) for t in range(cu_q[j],
                                                           cu_q[j + 1])]
    assert sub[0].shape[0] == len(lanes) > 0
    assert torch.equal(api.paged_attention_ragged(*sub),
                       api.paged_attention_ragged(*args)[lanes])


def test_turns_run_a_script_on_each_trees_package(tmp_path):
    """``bench.turns.in_tree`` runs a script with ``repro_torch`` taken
    from the tree it names alone, and returns the script's last line as
    JSON; a script that fails raises with its output."""
    from repro_torch.bench import turns

    script = tmp_path / "probe.py"
    script.write_text(
        "import json, sys\nimport repro_torch\nprint('noise')\n"
        "print(json.dumps({'who': repro_torch.WHO, 'args': sys.argv[1:]}))"
        "\n")
    for who in ("old", "new"):
        pkg = tmp_path / who / "src" / "repro_torch"
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text(f"WHO = {who!r}\n")
        assert turns.in_tree(str(script), tmp_path / who, ["--x", "1"]) == \
            {"who": who, "args": ["--x", "1"]}
    script.write_text("raise SystemExit('broken')\n")
    with pytest.raises(RuntimeError, match="broken"):
        turns.in_tree(str(script), tmp_path / "old", [])
