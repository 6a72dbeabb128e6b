"""The port's mesh pieces against the JAX package's, on the CPU.

* ``distributed.sharding.ShardingRules``: the spec of every parameter of
  every registered config equals the reference's ``params_tree`` at model
  axes 2 and 4 (a ``jax.sharding.AbstractMesh`` of the same shape: the
  rules read only axis names and sizes), and the cutter takes each rank's
  block;
* ``BlockAllocator(num_shards=S)``: the interleaved free order, ``shard_of``
  and ``build_sharded_block_lists`` integer-equal the reference's, prefix-
  shared tables that overflow ``M`` included;
* ``launch.mesh``: the serving mesh's shape and its refusals;
* ``bench.collectives`` (Fig 10): the rows' names and derived strings equal
  the reference's, and every primitive's result is exact on 2 gloo ranks
  (one spawn).
"""
import io
import contextlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from benchmarks import collectives as jcoll
from repro.config import get_config as jget_config
from repro.core.paged_kv import BlockAllocator as JAllocator
from repro.distributed.sharding import ShardingRules as JRules
from repro.models.api import build_model as jbuild_model
from repro_torch.bench import collectives as tcoll
from repro_torch.config import get_config, list_configs
from repro_torch.core.paged_kv import BlockAllocator
from repro_torch.distributed.sharding import ShardingRules, shard_leaf
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.api import build_model


def _port_mesh(model, rank=0):
    return mesh_lib.Mesh(axis_names=("data", "model"),
                         shape={"data": 1, "model": model},
                         coords={"data": 0, "model": rank},
                         device=torch.device("cpu"))


def _flat_port(tree, path=()):
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, list) or (
                 isinstance(tree, tuple) and tree and not all(
                     e is None or isinstance(e, str) for e in tree))
             else None)
    if items is None:
        return {"/".join(path): tuple(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_port(v, path + (str(k),)))
    return out


def _flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in leaves}


def _head_dim(cfg):
    a = getattr(cfg, "attention", None)
    return a.head_dim if a is not None else None


def _port_abstract(name):
    model = build_model(name if name in ("rm1", "rm2") else get_config(name),
                        device="meta")
    return model.init_abstract()


def _jax_abstract(name):
    cfg = jget_config(name)
    model = jbuild_model(cfg)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", list_configs())
def test_param_specs_equal_the_reference(name):
    cfg = get_config(name)
    tree_t, tree_j = _port_abstract(name), _jax_abstract(name)
    for model in (2, 4):
        hd = _head_dim(cfg)
        got = _flat_port(ShardingRules(_port_mesh(model), head_dim=hd)
                         .params_tree(tree_t))
        want = _flat_jax(JRules(AbstractMesh((1, model), ("data", "model")),
                                head_dim=hd).params_tree(tree_j))
        assert got == want, name
        assert any("model" in s for s in got.values()), name


def test_batch_and_cache_specs_equal_the_reference():
    jm = AbstractMesh((1, 2), ("data", "model"))
    for shape in [(8, 16), (3, 5, 7)]:
        assert ShardingRules(_port_mesh(2)).batch_spec(shape) == tuple(
            JRules(jm).batch_spec(shape))
    cases = [(("k",), (2, 4, 64, 8, 16)), (("seq_lens",), (4,)),
             (("S",), (2, 4, 6, 8, 8)), (("tm_shift",), (2, 4, 64)),
             (("conv",), (2, 3, 4, 4, 64)), (("h",), (2, 3, 4, 6, 8, 8)),
             (("other",), (3, 3))]
    for path, shape in cases:
        assert ShardingRules(_port_mesh(2)).cache_spec(path, shape) == tuple(
            JRules(jm).cache_spec(path, shape)), path


def test_shard_leaf_cuts_each_ranks_block():
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    parts = [shard_leaf(x, (None, "model"), _port_mesh(2, r))
             for r in range(2)]
    assert torch.equal(torch.cat(parts, dim=1), x)
    assert parts[0].is_contiguous() and parts[0].data_ptr() != x.data_ptr()
    assert shard_leaf(x, (None, None), _port_mesh(2, 1)) is x
    rows = [shard_leaf(x, ("model", None), _port_mesh(4, r))
            for r in range(4)]
    assert torch.equal(torch.cat(rows), x)


def _tables(alloc, prompt, bs):
    """The same allocator traffic on either package: a donor that
    publishes its prefix, five borrowers of the whole prefix, and a
    fresh request."""
    n = len(prompt)
    alloc.allocate(0, n)
    alloc.register_prefix(0, prompt, n)
    for r in range(1, 6):
        alloc.allocate_prefix(r, prompt)
    alloc.allocate(6, 9)
    alloc.allocate(7, 2 * bs + 1)


@pytest.mark.parametrize("S", [2, 4])
def test_allocator_shards_equal_the_reference(S):
    nb, bs = 16, 4
    prompt = np.arange(12, dtype=np.int32)
    ja = JAllocator(num_blocks=nb, block_size=bs, num_shards=S)
    ta = BlockAllocator(num_blocks=nb, block_size=bs, num_shards=S)
    assert ta._free == ja._free
    assert ta.blocks_per_shard == ja.blocks_per_shard == nb // S
    assert [ta.shard_of(b) for b in range(nb)] == [ja.shard_of(b)
                                                   for b in range(nb)]
    _tables(ja, prompt, bs)
    _tables(ta, prompt, bs)
    slots = [(r, r) for r in range(8)]
    for kw in ({}, {"min_per_shard": 1}):
        got = ta.build_sharded_block_lists(slots, pad_req=8, **kw)
        want = ja.build_sharded_block_lists(slots, pad_req=8, **kw)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, np.asarray(w))
    # the shared prefix is held six times over: M doubled past per shard
    assert got[0].shape[1] > ta.blocks_per_shard


def test_serving_mesh_and_its_refusals():
    m = mesh_lib.make_serving_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.devices == 1
    assert m.axis_names == ("data", "model")
    assert mesh_lib.data_axes(m) == ("data",)
    assert m.group("model") is None
    with pytest.raises(ValueError, match="process group has 1"):
        mesh_lib.make_serving_mesh(model=2)
    assert mesh_lib.make_smoke_mesh(1, 4).shape["model"] == 1


def test_collective_rows_equal_the_reference_and_are_exact():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcoll.run(quick=True)
    want = [line.split(",") for line in buf.getvalue().splitlines()
            if line.startswith("coll_")]
    assert len(want) == 6 * 3 * 3
    rows = mesh_lib.run_ranks(tcoll.time_job, 2, ("cpu", True, 1))[0]
    assert [(r["name"], r["derived"]) for r in rows] == [
        (w[0], w[2]) for w in want]
    for r in rows:
        timed = r["ranks"] <= 2
        assert (r["us"] > 0) == timed and r["refused"] is None, r
        assert r["backend"] == ("gloo" if timed else None)
    checks = mesh_lib.run_ranks(tcoll.check_job, 2,
                                ("cpu", 64, ("float32", "bfloat16")))
    assert checks == [{f"{p}/{dt}": True for dt in ("float32", "bfloat16")
                       for p in tcoll.PRIMS}] * 2
