"""The port's sharded train step on a ``(data, model)`` mesh of gloo ranks
against the JAX package's one-device step, on the CPU.

The reference test's model (``tests/test_distributed.py``
``test_train_step_numerics_match_sharded_vs_single``): smollm-360m reduced
to float32, 2 layers, d_model 64, vocabulary 256, remat off, tokens (8,
32) from ``default_rng``; AdamW with ``cosine_warmup(1e-3, 2, 10)``;
params from the reference's ``init(PRNGKey(0))``, bridged.  On (2, 2) and
(4, 2) meshes (FSDP over ``data``, the vocabulary and the SwiGLU over
``model``; one spawn each) two steps of ``jit_train_step`` against
``jax.jit(make_train_step)``: each step's loss at rtol 1e-5 and
``grad_norm`` at rtol 1e-4 (float32 sums in another order: reduce-scatters,
the loss's SUM over ``data``, the vocabulary-parallel log-sum-exp), and
after step 2 each rank's shards against the same slices of JAX's params at
atol 1e-5.

Also: ``abstract_state`` and ``state_specs`` against the reference's on an
abstract mesh; a one-rank mesh gives the one-device step's bits; the
global norm of a sharded tree counts a replicated leaf once; the
activation-sharding scope; the two-axis mesh's groups.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.distributed import act_sharding as jact
from repro.distributed.sharding import ShardingRules as JRules
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import cosine_warmup as jcosine
from repro.training import train_step as jts
from repro_torch import tree as tree_lib
from repro_torch.bench import sharded_train as st
from repro_torch.distributed import act_sharding
from repro_torch.distributed.sharding import ShardingRules, spec_leaves
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.training import train_step as ts

ARCH = "smollm-360m"
OVERRIDES = (("num_layers", 2), ("d_model", 64), ("vocab_size", 256))
B, S, STEPS = 8, 32, 2


def _batches(vocab):
    rng = np.random.default_rng(1)
    return tuple({"tokens": rng.integers(0, vocab, (B, S), dtype=np.int32)}
                 for _ in range(STEPS))


def _jax_run(arch, overrides, batches, **model_kw):
    """The reference's jitted one-device steps: (params numpy at init,
    per-step metrics, params numpy after the last step)."""
    cfg = jget_config(arch).reduced(dtype="float32", **dict(overrides))
    model = jbuild_model(cfg, remat=False, **model_kw)
    opt = jadamw()
    state = jts.init_state(model, jax.random.PRNGKey(0), opt)
    init = jax.tree.map(np.asarray, state.params)
    step = jax.jit(jts.make_train_step(model, opt, jcosine(1e-3, 2, 10)))
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, jax.tree.map(np.asarray, state.params)


def check_ranks(ranks, want_metrics, want_params, shape, spec):
    """Every rank's metrics and shards against JAX's."""
    _, model = st.build(spec, "cpu")
    for r in ranks:
        for got, want in zip(r["metrics"], want_metrics):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-4)
            np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
        exp = st.expected_shard(model, want_params, r["coords"], shape)
        for a, b in zip(tree_lib.leaves(r["shards"]), tree_lib.leaves(exp)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.fixture(scope="module")
def reference():
    batches = _batches(256)
    return batches, _jax_run(ARCH, OVERRIDES, batches)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_sharded_train_steps_match_jax(reference, shape):
    batches, (init, metrics, final) = reference
    spec = st.TrainSpec(ARCH, batches, overrides=OVERRIDES, params=init)
    ranks = mesh_lib.run_ranks(st.train_job, shape[0] * shape[1],
                               (spec, shape), timeout=300)
    assert sorted((r["coords"]["data"], r["coords"]["model"])
                  for r in ranks) == [(d, m) for d in range(shape[0])
                                      for m in range(shape[1])]
    check_ranks(ranks, metrics, final, shape, spec)


def test_one_rank_mesh_is_the_one_device_step(reference):
    batches, (init, _, _) = reference
    spec = st.TrainSpec(ARCH, batches, overrides=OVERRIDES, params=init)
    one = st.train_job(spec, (1, 1))
    single = st.train_job(spec, None)
    for a, b in zip(one["metrics"], single["metrics"]):
        assert {k: v for k, v in a.items() if k != "step_s"} == {
            k: v for k, v in b.items() if k != "step_s"}
    for a, b in zip(tree_lib.leaves(one["shards"]),
                    tree_lib.leaves(single["shards"])):
        np.testing.assert_array_equal(a, b)


def test_abstract_state_and_specs_equal_the_reference():
    cfg = jget_config(ARCH).reduced(dtype="float32", **dict(OVERRIDES))
    jmodel = jbuild_model(cfg, remat=False)
    jshape = jts.abstract_state(jmodel, jadamw())
    jmesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    jspecs = jts.state_specs(JRules(jmesh, head_dim=cfg.attention.head_dim),
                             jshape)
    _, model = st.build(st.TrainSpec(ARCH, (), overrides=OVERRIDES), "cpu")
    shape = ts.abstract_state(model, adamw())
    assert all(t.device.type == "meta" for t in tree_lib.leaves(shape))
    assert [tuple(t.shape) for t in tree_lib.leaves(shape)] == [
        tuple(t.shape) for t in jax.tree.leaves(jshape)]

    class _Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}

        def size(self, a):
            return self.shape[a]

    specs = ts.state_specs(ShardingRules(_Mesh(), head_dim=16), shape)
    got = (spec_leaves(specs.params) + [specs.opt.step]
           + spec_leaves(specs.opt.m) + spec_leaves(specs.opt.v)
           + [specs.step])
    want = [tuple(p) for p in jax.tree.leaves(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert got == want
    assert any("data" in s for s in got) and any("model" in s for s in got)


def test_jit_train_step_refuses_other_rules(reference):
    batches, (init, _, _) = reference
    _, model = st.build(st.TrainSpec(ARCH, batches, overrides=OVERRIDES),
                        "cpu")

    class _Two:                     # a mesh of two ranks, never stepped
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 2}
        devices = 2

        def size(self, a):
            return self.shape[a]

    shape = ts.abstract_state(model, adamw())
    with pytest.raises(ValueError, match="sharding_rules"):
        ts.jit_train_step(model, adamw(), cosine_warmup(1e-3, 2, 10), _Two(),
                          ShardingRules(_Two()), shape, {})


def test_global_norm_counts_a_replicated_leaf_once():
    ranks = mesh_lib.run_ranks(st.norm_job, 4, ((2, 2),), timeout=120)
    want = st.norm_tree_full()
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in want.values()))
    for r in ranks:
        np.testing.assert_allclose(r, norm, rtol=1e-6)


def test_activation_sharding_scope_and_identity():
    x = torch.arange(12.0).reshape(4, 3)
    assert act_sharding.current_data_axes() is None
    assert jact.current_data_axes() is None
    with act_sharding.activation_sharding(("data",)):
        assert act_sharding.current_data_axes() == ("data",)
        assert act_sharding.constrain_batch(x) is x
        with act_sharding.activation_sharding(("pod", "data")):
            assert act_sharding.current_data_axes() == ("pod", "data")
        assert act_sharding.current_data_axes() == ("data",)
    assert act_sharding.current_data_axes() is None
    assert act_sharding.constrain_batch(x) is x


def test_two_axis_mesh_lays_ranks_row_major():
    ranks = mesh_lib.run_ranks(st.mesh_job, 4, ((2, 2),), timeout=120)
    for r, got in enumerate(ranks):
        assert got["coords"] == {"data": r // 2, "model": r % 2}
        # a SUM over model adds the row's ranks, over data the column's
        assert got["model_sum"] == sum(range(2 * (r // 2), 2 * (r // 2) + 2))
        assert got["data_sum"] == (r % 2) + (r % 2 + 2)
    with pytest.raises(ValueError, match="process group has 1"):
        mesh_lib.make_mesh((2, 1), ("data", "model"))
