"""The dry run on the reference's production meshes, counted for one rank
(``repro_torch.launch.mesh.make_production_mesh``, abstract, and the
counting collectives of ``repro_torch.distributed.collectives``), on the
CPU's meta device.

* the meshes' shapes and axis names are the reference's (read from its
  source: calling it would ask JAX for 256 devices);
* over an abstract mesh each collective returns its result's shape and
  tallies its operand bytes by the reference's kinds; a real tensor
  raises, and so does asking the mesh for a process group;
* one decode step of a one-layer llama (reduced, float32) on a (2, 2)
  abstract mesh tallies exactly the bytes counted by hand below, kind by
  kind;
* the reference integration test's four cells
  (``tests/test_dryrun_integration.py``), at full width on its substitute
  meshes (4, 2) and (2, 2, 2) and its cut shapes, monkeypatched as it
  does: ``ok`` records with ``collective_bytes > 0``, ``chips`` 8, and
  the rank's counts globalised by ``chips``.
"""
import ast
from pathlib import Path

import pytest
import torch

import repro_torch.launch.dryrun as dr
from repro_torch.config import ShapeCell, get_config
from repro_torch.distributed import collectives
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.api import build_model
from repro_torch.serving import steps

ROOT = Path(__file__).resolve().parents[1]


def _reference_meshes():
    """(multi_pod shape, axes), (single shape, axes) from the reference's
    ``make_production_mesh``."""
    tree = ast.parse((ROOT / "src/repro/launch/mesh.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "make_production_mesh")
    found = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.IfExp):
            found[node.targets[0].id] = (ast.literal_eval(node.value.body),
                                         ast.literal_eval(node.value.orelse))
    return found


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_are_the_references(multi_pod):
    ref = _reference_meshes()
    pick = 0 if multi_pod else 1
    m = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    assert m.abstract and m.device.type == "meta"
    assert m.axis_names == ref["axes"][pick]
    assert tuple(m.shape[a] for a in m.axis_names) == ref["shape"][pick]
    assert m.devices == (512 if multi_pod else 256)
    assert all(m.axis_index(a) == 0 for a in m.axis_names)
    with pytest.raises(RuntimeError, match="abstract"):
        m.group("model")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_counting_collectives_shapes_and_bytes():
    m = mesh_lib.abstract_mesh((4, 2), ("data", "model"))
    with collectives.counting() as tally:
        g = collectives.all_gather(_meta(3, 5), m, "data", dim=0)
        g2 = collectives.all_gather(_meta(3, 5, dtype=torch.bfloat16), m,
                                    "model", dim=-1)
        rs = collectives.reduce_scatter(_meta(8, 3), m, "data")
        ar = collectives.all_reduce(_meta(6), m, "model")
        f32 = collectives.all_reduce_f32(_meta(6, dtype=torch.bfloat16), m,
                                         "model")
        a2a = collectives.all_to_all(_meta(4, 7), m, "data")
        sh = collectives.shift(_meta(2, 2), m, "data")
    assert tuple(g.shape) == (12, 5) and tuple(g2.shape) == (3, 10)
    assert g2.dtype == torch.bfloat16
    assert tuple(rs.shape) == (2, 3) and tuple(ar.shape) == (6,)
    assert f32.dtype == torch.bfloat16 and tuple(a2a.shape) == (4, 7)
    assert tuple(sh.shape) == (2, 2)
    assert tally == {"all-gather": 15 * 4 + 15 * 2, "all-reduce": 24 + 24,
                     "reduce-scatter": 24 * 4, "all-to-all": 28 * 4,
                     "collective-permute": 16,
                     "total": 90 + 48 + 96 + 112 + 16}


def test_counting_collectives_refuse_real_tensors():
    m = mesh_lib.make_production_mesh()
    x = torch.zeros(4, 4)
    for call in (lambda: collectives.all_reduce(x, m, "model"),
                 lambda: collectives.all_gather(x, m, "data"),
                 lambda: collectives.reduce_scatter(x, m, "model"),
                 lambda: collectives.all_to_all(x, m, "model"),
                 lambda: collectives.all_reduce_f32(x, m, "model"),
                 lambda: collectives.shift(x, m, "data")):
        with pytest.raises(RuntimeError, match="abstract mesh"):
            call()
    one = mesh_lib.abstract_mesh((1, 4), ("data", "model"))
    with collectives.counting() as tally:       # an axis of one rank
        assert collectives.all_gather(_meta(2), one, "data").shape == (2,)
    assert tally["total"] == 0
    with pytest.raises(RuntimeError, match="abstract mesh"):
        collectives.all_gather(x, one, "data")


def test_gather_shards_keeps_each_leaf_dtype():
    # a float32 router beside bfloat16 experts: one gather a dtype
    m = mesh_lib.abstract_mesh((4, 2), ("data", "model"))
    with collectives.counting() as tally:
        a, b = collectives.gather_shards(
            [_meta(2, 3), _meta(2, 5, dtype=torch.bfloat16)], [0, 0], m,
            "data")
    assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
    assert tuple(a.shape) == (8, 3) and tuple(b.shape) == (8, 5)
    assert tally["all-gather"] == 6 * 4 + 10 * 2


def test_one_layer_decode_step_counts_the_analytic_bytes():
    cfg = get_config("llama31-8b").reduced(dtype="float32", num_layers=1)
    a = cfg.attention
    D, F, V, H, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, a.num_heads, \
        a.head_dim
    kv = a.num_kv_heads * hd
    B, S, f = 8, 32, 4                       # float32
    m = mesh_lib.abstract_mesh((2, 2), ("data", "model"))
    assert H % 2 == 0 and a.num_kv_heads % 2 and V % 2 == 0 and F % 2 == 0
    model = build_model(cfg, device="meta")
    rules = model.sharding_rules(m)
    whole = model.init_abstract()
    tokens = _meta(B, dtype=torch.int32)
    step = steps.jit_serve_step(model, m, rules, whole,
                                steps.abstract_cache(model, B, S), tokens)
    with collectives.counting() as tally:
        nxt, _ = step(model.shard_params(whole, m),
                      model.init_decode_cache(B, S, mesh=m), tokens)
    assert tuple(nxt.shape) == (B,)
    b = B // 2                               # the rank's requests
    # FSDP: the layer's matrices, each this rank's block (data, and model
    # where split): wq, wo by both; wk, wv (one kv head) by data only;
    # w_gate, w_up, w_down by both
    fsdp = (D * H * hd // 4 * 2 + D * kv // 2 * 2 + D * F // 4 * 3) * f
    gather_q = b * H * hd // 2 * f           # project_qkv: the query heads
    logits = b * V // 2 * f                  # the vocabulary-parallel head
    next_tokens = b * 4                      # int32, over data
    embed = b * D * f                        # exact SUM of the lookups
    stats = b * a.num_kv_heads * (H // a.num_kv_heads) * f   # the MAX
    combine = stats * (hd + 1)               # numerators and denominators
    row = b * D * f                          # wo and w_down, float32 SUMs
    assert tally == {"all-gather": fsdp + gather_q + logits + next_tokens,
                     "all-reduce": embed + stats + combine + 2 * row,
                     "reduce-scatter": 0.0, "all-to-all": 0.0,
                     "collective-permute": 0.0,
                     "total": fsdp + gather_q + logits + next_tokens + embed
                     + stats + combine + 2 * row}


@pytest.fixture
def substitute(monkeypatch):
    """The reference integration test's meshes and cut shapes."""
    def make_small(*, multi_pod=False):
        if multi_pod:
            return mesh_lib.abstract_mesh((2, 2, 2), ("pod", "data",
                                                      "model"))
        return mesh_lib.abstract_mesh((4, 2), ("data", "model"))

    monkeypatch.setattr(dr, "make_production_mesh", make_small)
    monkeypatch.setattr(dr, "SHAPES", dict(
        dr.SHAPES, train_4k=ShapeCell("train_4k", 256, 8, "train"),
        decode_32k=ShapeCell("decode_32k", 1024, 8, "decode"),
        prefill_32k=ShapeCell("prefill_32k", 1024, 4, "prefill")))


@pytest.mark.parametrize("arch,shape,multi", [
    ("smollm-360m", "train_4k", False),
    ("smollm-360m", "train_4k", True),
    ("granite-moe-1b-a400m", "decode_32k", True),
    ("rwkv6-1.6b", "prefill_32k", False),
])
def test_reference_cells_count_on_substitute_meshes(substitute, arch, shape,
                                                    multi):
    rec = dr.run_cell(arch, shape, multi_pod=multi,
                      mesh=None if multi else "16x16", verbose=False)
    assert rec["status"] == "ok", rec
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    rl = rec["roofline"]
    assert rl["chips"] == 8
    assert rl["hlo_flops"] == rec["full"]["flops"] * 8 > 0
    assert rl["hlo_bytes"] == rec["full"]["bytes"] * 8 > 0
    assert rl["collective_bytes"] == rec["full"]["collectives"]["total"] * 8
    assert rl["collective_bytes"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    kinds = set(rec["full"]["collectives"]) - {"total"}
    assert kinds and kinds <= set(collectives.KINDS)


def test_multi_pod_refuses_a_mesh_beside_it():
    # 2x16x16 is reached one way only: multi_pod, with no mesh named
    with pytest.raises(ValueError, match="multi_pod"):
        dr.run_cell("smollm-360m", "train_4k", multi_pod=True,
                    mesh="16x16", verbose=False)
    with pytest.raises(ValueError, match="2x16x16"):
        dr.run_cell("smollm-360m", "train_4k", mesh="2x16x16",
                    verbose=False)
    with pytest.raises(SystemExit):
        dr.main(["--arch", "smollm-360m", "--shape", "train_4k",
                 "--multi-pod", "--mesh", "1"])
