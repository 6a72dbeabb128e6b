"""Expert parallelism in the port on gloo ranks against the JAX package's
one-device functions, on the CPU.

Reduced granite-moe-1b-a400m in float32 (4 experts, top 2, d_model 64),
params from the reference's ``init(PRNGKey(0))``:

* ``moe_apply(shard=True, groups=G, tp=)`` of layer 0 on a (2, 2) mesh
  against JAX's ``moe_apply(groups=G)`` on the whole batch: G = 2 (one
  group a data row: each rank its two experts over the row's tokens, one
  float32 SUM over ``model``) and G = 4 (two groups a row: each rank routes
  one, the experts' tokens move by all-to-all); outputs atol 1e-5, aux
  rtol 1e-6.  ``groups`` changes C, so each is held to JAX at the same G.
  Each call is checked to take the layout its G gives it.
* the gradient of ``sum(out * w) + aux`` over each rank's shards, at both
  G, against the port's one-device ``moe_apply`` at the same G (each leaf
  within 1e-5 of its largest value): the backward of the all-to-all, of
  the SUM and of the aux loss's sums.
* the train step with ``shard_moe=True, moe_groups=2`` on (2, 2) against
  ``jax.jit(make_train_step)`` of the reference model at ``moe_groups=2``,
  as ``test_torch_sharded_train.py`` holds the dense one.
* the serving engine on 2 ranks (full capacity: each rank its experts over
  every lane): the greedy streams of two sweep cases (fcfs, the roomy pool,
  proposers off and ngram) identical to the port's one-device engine and
  to the reference engine's.  Outputs are compared, never token indices:
  ``torch`` and ``jax.lax.top_k`` break ties among the zero gates
  differently, and those tokens add exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import ServeConfig as JServeConfig
from repro.config import get_config as jget_config
from repro.layers import moe as jmoe
from repro.models.api import build_model as jbuild_model
from repro.serving import engine as jengine
from repro_torch.bench import sharded
from repro_torch.bench import sharded_train as st
from repro_torch.launch import mesh as mesh_lib

from test_torch_sharded_train import _jax_run, check_ranks

ARCH = st.MOE_ARCH
MESH = (2, 2)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config(ARCH).reduced(dtype="float32")
    model = jbuild_model(cfg, remat=False)
    return cfg, model, jax.tree.map(np.asarray,
                                    model.init(jax.random.PRNGKey(0)))


LAYOUT = {2: {"all_to_all": 0, "sum": 1}, 4: {"all_to_all": 1, "sum": 0}}


@pytest.mark.parametrize("groups", [2, 4])
def test_ep_moe_apply_matches_jax(jax_params, groups):
    cfg, _, params = jax_params
    layer = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    x = np.random.default_rng(2).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.moe_apply(
        jax.tree.map(jnp.asarray, layer), jnp.asarray(x), cfg.moe,
        groups=groups)
    ranks = mesh_lib.run_ranks(st.moe_job, 4, (
        ARCH, (), layer, x, MESH, groups), timeout=120)
    np.testing.assert_allclose(st.gather_rows(ranks), np.asarray(want),
                               atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["aux"], float(want_aux), rtol=1e-6)
        assert r["dispatch"] == LAYOUT[groups]
    # the model axis's ranks of a row hold the same output
    by = {(r["coords"]["data"], r["coords"]["model"]): r["out"]
          for r in ranks}
    for d in range(MESH[0]):
        np.testing.assert_allclose(by[(d, 0)], by[(d, 1)], atol=1e-6)


@pytest.mark.parametrize("groups", [2, 4])
def test_ep_moe_grads_match_one_device(groups):
    ranks = mesh_lib.run_ranks(st.moe_grads_job, 4, (
        ARCH, True, (4, 8), MESH, groups), timeout=120)
    for r in ranks:
        assert r["dispatch"] == LAYOUT[groups]
        assert r["out_err"] <= 1e-5 and r["aux_rel"] <= 1e-6, r
        assert max(r["grad_errs"].values()) <= 1e-5, r["grad_errs"]


def test_ep_train_steps_match_jax():
    rng = np.random.default_rng(1)
    vocab = jget_config(ARCH).reduced(dtype="float32").vocab_size
    batches = tuple({"tokens": rng.integers(0, vocab, (8, 32),
                                            dtype=np.int32)}
                    for _ in range(2))
    init, metrics, final = _jax_run(ARCH, (), batches, moe_groups=2,
                                    shard_moe=True)
    spec = st.TrainSpec(ARCH, batches, params=init,
                        model_kw=(("shard_moe", True), ("moe_groups", 2)))
    ranks = mesh_lib.run_ranks(st.train_job, 4, (spec, MESH), timeout=300)
    check_ranks(ranks, metrics, final, MESH, spec)


def _jax_streams(model, params, cfg, spec):
    eng = jengine.ServingEngine(
        model, params, cfg,
        JServeConfig(model=cfg.name, kv_block_size=4, max_batch=3,
                     spec=spec, spec_k=3),
        num_blocks=sharded.NUM_BLOCKS[0])
    for r in sharded.sweep_requests(cfg.vocab_size):
        eng.submit(jengine.Request(deadline=None, **r))
    eng.run_until_done()
    return {r.req_id: list(map(int, r.output)) for r in eng.finished}


def test_engine_serves_moe_on_two_ranks(jax_params):
    cfg, model, params = jax_params
    single = st.moe_serve_job(params, False)
    ranks = mesh_lib.run_ranks(st.moe_serve_job, 2, (params, True),
                               timeout=300)
    jparams = jax.tree.map(jnp.asarray, params)
    for spec in sharded.SPECS:
        want = _jax_streams(model, jparams, cfg, spec)
        assert single[spec] == want, spec
        for r in ranks:
            assert r[spec] == want, spec
