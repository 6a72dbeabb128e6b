"""The port's sharded serving steps (``serving.steps.jit_prefill_step`` /
``jit_serve_step``) of the decoders on gloo meshes against the JAX
package's one-device steps, float32 on the CPU, and the cache's specs
against the reference's.

Two decoders reduced to float32 (2 layers, vocabulary 256, params from
JAX's ``init(PRNGKey(0))``, bridged): llama31-8b (4 query heads split on
2 model ranks, its one kv head whole: ``project_qkv`` gathers the
queries) and granite-moe-1b-a400m (``moe_groups=2`` on both sides: its
prefill's capacity-dropped dispatch groups are the data shards, as the
reference's dry run sets them; its decode at full capacity
expert-parallel).  On ``(1, 2)`` and ``(2, 2)`` meshes (one spawn each,
both models), 6-token prompts of a batch of 4 through ``jit_serve_step``,
then 4 greedy steps: each step's logits of the rank's batch shard and the
prefill step's logits against JAX's ``make_prefill_step`` /
``decode_step`` at atol 1e-5, the greedy streams identical, and each
rank's cache shard equal to JAX's cache sliced by ``cache_spec`` (the
sequence split over ``model``, the batch over ``data``).

Also: a one-rank mesh gives the one-device step's bits; ``abstract_cache``
and ``cache_tree`` equal the reference's (``jax.sharding.AbstractMesh``)
for every family's cache, and ``init_decode_cache(mesh=)`` allocates each
leaf at its shard's shape; the steps refuse other rules than the model's;
inside ``launch.mesh.rank_pools`` ``run_ranks`` keeps its ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.config import get_config as jget_config
from repro.distributed.sharding import ShardingRules as JRules
from repro.models.api import build_model as jbuild_model
from repro.serving import steps as jsteps
from repro_torch.bench import sharded_steps as ss
from repro_torch.config import get_config
from repro_torch.distributed.sharding import ShardingRules, shard_shape
from repro_torch.launch.mesh import abstract_mesh, run_ranks
from repro_torch.models.api import build_model
from repro_torch.serving import steps

CASES = {
    "llama": ("llama31-8b", (), ()),
    "moe": ("granite-moe-1b-a400m", (), (("moe_groups", 2),)),
}
OVER = (("num_layers", 2), ("vocab_size", 256))
# the P + NEW - 1 written positions cross the model axis's shard boundary
# (MAX_SEQ / 2) at the prompt's last step, so every greedy step reads
# keys that rank 1 owns and wrote
B, P, NEW, MAX_SEQ = 4, 6, 4, 10
SHAPES = [(1, 2), (2, 2)]
FAMILIES = ["smollm-360m", "granite-moe-1b-a400m", "rwkv6-1.6b",
            "zamba2-2.7b", "whisper-tiny", "internvl2-26b"]


class Ref:
    """One decoder's JAX model, params and one-device serving outputs."""

    def __init__(self, name):
        arch, over, kw = CASES[name]
        self.arch, self.kw = arch, kw
        self.over = OVER + over
        cfg = jget_config(arch).reduced(dtype="float32", **dict(self.over))
        model = jbuild_model(cfg, remat=False, **dict(kw))
        params = jax.jit(model.init)(jax.random.PRNGKey(0))
        self.params = jax.tree.map(np.asarray, params)
        rng = np.random.default_rng(5)
        self.prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(
            np.int32)
        batch = {"tokens": jnp.asarray(self.prompts)}
        self.prefill = np.asarray(jax.jit(jsteps.make_prefill_step(model))(
            params, batch))
        cache = model.init_decode_cache(B, MAX_SEQ)
        step = jax.jit(model.decode_step)
        logits, streams, nxt = [], [], None
        for t in range(P + NEW - 1):
            tok = jnp.asarray(self.prompts[:, t]) if t < P else nxt
            lg, cache = step(params, cache, tok)
            nxt = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            logits.append(np.asarray(lg))
            if t >= P - 1:
                streams.append(np.asarray(nxt))
        self.logits = np.stack(logits)
        self.streams = np.stack(streams, axis=1)
        self.cache = jax.tree.map(np.asarray, cache)

    def spec(self):
        return ss.ServeSpec(self.arch, self.prompts, NEW, MAX_SEQ,
                            overrides=self.over, params=self.params,
                            model_kw=self.kw)


@pytest.fixture(scope="module")
def refs():
    return {name: Ref(name) for name in CASES}


@pytest.fixture(scope="module")
def runs(refs):
    """``{shape: [each rank's {case: serve_job result}]}``, one spawn a
    mesh shape."""
    out = {}
    for shape in SHAPES:
        calls = [(ss.serve_job, (refs[n].spec(), shape)) for n in CASES]
        ranks = run_ranks(ss.many, shape[0] * shape[1], (calls,),
                          timeout=600)
        out[shape] = [dict(zip(CASES, r)) for r in ranks]
    return out


PARAMS = [(n, s) for n in CASES for s in SHAPES]


@pytest.mark.parametrize("name,shape", PARAMS)
def test_prefill_step_matches_jax(refs, runs, name, shape):
    for r in runs[shape]:
        np.testing.assert_allclose(r[name]["prefill"], refs[name].prefill,
                                   atol=1e-5)


@pytest.mark.parametrize("name,shape", PARAMS)
def test_serve_step_logits_match_jax(refs, runs, name, shape):
    n = B // shape[0]
    for r in runs[shape]:
        d = r[name]["coords"]["data"]
        np.testing.assert_allclose(r[name]["logits"],
                                   refs[name].logits[:, d * n:(d + 1) * n],
                                   atol=1e-5)


@pytest.mark.parametrize("name,shape", PARAMS)
def test_greedy_streams_equal_jax(refs, runs, name, shape):
    for r in runs[shape]:
        np.testing.assert_array_equal(r[name]["streams"], refs[name].streams)


@pytest.mark.parametrize("name,shape", PARAMS)
def test_cache_shards_equal_jax_sliced(refs, runs, name, shape):
    _, model = ss.build(refs[name].spec(), "cpu")
    for r in runs[shape]:
        got = r[name]["cache"]
        want = ss.expected_cache_shard(model, refs[name].cache,
                                       r[name]["coords"], shape)
        assert sorted(got) == sorted(want)
        assert got["k"].shape[1:3] == (B // shape[0], MAX_SEQ // shape[1])
        assert np.abs(got["k"]).max() > 0     # every rank owns written keys
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_one_rank_mesh_is_the_one_device_step(refs, name):
    spec = refs[name].spec()
    one, single = ss.serve_job(spec, (1, 1)), ss.serve_job(spec, None)
    for k in ("prefill", "logits", "streams"):
        np.testing.assert_array_equal(one[k], single[k])
    for k in single["cache"]:
        np.testing.assert_array_equal(one["cache"][k], single["cache"][k])


def _models(arch):
    cfg = get_config(arch).reduced(dtype="float32")
    jcfg = jget_config(arch).reduced(dtype="float32")
    return build_model(cfg, device="meta"), jbuild_model(jcfg, remat=False)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 2)])
def test_abstract_cache_and_cache_tree_equal_the_reference(arch, shape):
    model, jmodel = _models(arch)
    cache = steps.abstract_cache(model, 8, 32)
    jcache = jsteps.abstract_cache(jmodel, 8, 32)
    assert all(t.device.type == "meta" for t in cache.values())
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        assert tuple(cache[k].shape) == tuple(jcache[k].shape), k
        assert str(cache[k].dtype).split(".")[-1] == str(jcache[k].dtype), k
    mesh = abstract_mesh(shape, ("data", "model"))
    specs = ShardingRules(mesh).cache_tree(cache)
    jspecs = JRules(AbstractMesh(shape, ("data", "model"))).cache_tree(
        jcache)
    assert specs == {k: tuple(v) for k, v in jspecs.items()
                     if isinstance(v, PartitionSpec)}
    # a rank allocates its shard only
    shard = model.init_decode_cache(8, 32, mesh=mesh)
    for k, t in shard.items():
        assert tuple(t.shape) == shard_shape(tuple(cache[k].shape),
                                             specs[k], mesh), k


@pytest.mark.parametrize("which", ["prefill", "serve"])
def test_steps_refuse_other_rules(which):
    model, _ = _models("llama31-8b")
    mesh = abstract_mesh((2, 2), ("data", "model"))
    whole = model.init_abstract()
    tokens = torch.empty((8,), dtype=torch.int32, device="meta")
    for rules in (ShardingRules(mesh, head_dim=None),
                  ShardingRules(mesh, model_axis="data",
                                fsdp_axis="model")):
        with pytest.raises(ValueError, match="sharding_rules"):
            if which == "prefill":
                steps.jit_prefill_step(model, mesh, rules, whole,
                                       {"tokens": tokens[:, None]})
            else:
                steps.jit_serve_step(model, mesh, rules, whole,
                                     steps.abstract_cache(model, 8, 32),
                                     tokens)
    assert model.sharding_rules(mesh).params_tree(whole) != ShardingRules(
        mesh, head_dim=None).params_tree(whole)


def test_rank_pools_keep_the_ranks():
    # inside rank_pools, run_ranks reuses one pool's processes a rank
    # count; a failed job closes its pool; outside, ranks are fresh
    import os

    from repro_torch.bench import sharded_train as st
    from repro_torch.launch import mesh as mesh_lib

    def calls(*jobs):
        return (list(jobs),)

    with mesh_lib.rank_pools():
        a = run_ranks(ss.many, 2, calls((os.getpid, ()),
                                        (st.mesh_job, ((1, 2),))))
        b = run_ranks(ss.many, 2, calls((os.getpid, ()),
                                        (st.mesh_job, ((2, 1),))))
        assert [r[0] for r in a] == [r[0] for r in b]
        assert [r[1]["model_sum"] for r in a] == [1.0, 1.0]
        assert [r[1]["data_sum"] for r in b] == [1.0, 1.0]
        with pytest.raises(RuntimeError, match="rank"):
            run_ranks(ss.many, 2, calls((int, ("x",))))
        c = run_ranks(ss.many, 2, calls((os.getpid, ())))
        assert c[0][0] != a[0][0]
        with pytest.raises(RuntimeError, match="already"):
            with mesh_lib.rank_pools():
                pass
    d = run_ranks(ss.many, 2, calls((os.getpid, ())))
    assert d[0][0] not in (a[0][0], c[0][0])
