"""The port's data pipeline, checkpoints, trainer resume and elastic
decision layer against the JAX package's, on the CPU.

* ``SyntheticLMDataset`` and ``DataPipeline`` give byte-identical batches
  (same Philox counter), a restart at ``start_step`` included.
* ``CheckpointManager``: the reference's tests of roundtrip, retention,
  async save with a placer and atomic publish, run on the port; an async
  write that fails raises at ``wait()``; a checkpoint that either package
  writes restores in the other (a train state after one AdamW step, and a
  bfloat16 leaf, which the port stores as float32): values exact.
* A trainer that restores step 4 and runs on reproduces the
  uninterrupted run's losses and parameters (the CPU is deterministic:
  exact).
* ``StragglerWatchdog``, ``HeartbeatMonitor`` and ``plan_remesh`` give the
  reference's answers on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.config import get_config as jax_get_config
from repro.data.pipeline import DataPipeline as JaxDataPipeline
from repro.data.pipeline import SyntheticLMDataset as JaxLMDataset
from repro.distributed import elastic as j_elastic
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as j_adamw
from repro.optim import cosine_warmup as j_cosine
from repro.training.train_step import init_state as j_init_state
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import get_config
from repro_torch.data.pipeline import DataPipeline, SyntheticLMDataset
from repro_torch.distributed import elastic
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.training.train_step import (
    TrainState, init_state, make_train_step)
from repro_torch.training.trainer import Trainer


@pytest.mark.parametrize("step,host,num_hosts", [(0, 0, 1), (3, 0, 2),
                                                 (3, 1, 2), (41, 0, 1)])
def test_lm_dataset_is_byte_equal(step, host, num_hosts):
    a = JaxLMDataset(1000, 16, 8, seed=7).batch_at(step, host, num_hosts)
    b = SyntheticLMDataset(1000, 16, 8, seed=7).batch_at(step, host,
                                                         num_hosts)
    assert sorted(a) == sorted(b) == ["tokens"]
    assert a["tokens"].dtype == b["tokens"].dtype == np.int32
    assert a["tokens"].tobytes() == b["tokens"].tobytes()


@pytest.mark.parametrize("start", [0, 5])
def test_pipeline_batches_equal_the_reference(start):
    ds_j, ds_t = JaxLMDataset(100, 8, 4), SyntheticLMDataset(100, 8, 4)
    pj, pt = JaxDataPipeline(ds_j, start_step=start), DataPipeline(
        ds_t, start_step=start)
    try:
        for i in range(4):
            (sj, bj), (st, bt) = next(pj), next(pt)
            assert sj == st == start + i
            assert bj["tokens"].tobytes() == bt["tokens"].tobytes()
    finally:
        pj.close()
        pt.close()
    # restart at start + 2 reproduces that batch
    p2 = DataPipeline(ds_t, start_step=start + 2)
    s2, b2 = next(p2)
    p2.close()
    assert s2 == start + 2
    assert b2["tokens"].tobytes() == ds_j.batch_at(start + 2)[
        "tokens"].tobytes()


def test_checkpoint_roundtrip_and_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)}}
    for step in (10, 20, 30):
        cm.save(step, tree_lib.map(lambda x: x * step, tree), blocking=True)
    assert cm.all_steps() == [20, 30]     # keep=2 retention
    assert cm.latest_step() == 30
    restored = cm.restore(30, tree)
    np.testing.assert_allclose(restored["w"],
                               np.arange(6, dtype=np.float32).reshape(2, 3)
                               * 30)
    assert restored["nested"]["b"].dtype == np.float32
    np.testing.assert_array_equal(restored["nested"]["b"], np.full(4, 30.0))


def test_checkpoint_async_and_placer(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones((8, 8)), "h": torch.ones(3, dtype=torch.bfloat16)}
    cm.save(1, tree, blocking=False)
    cm.wait()
    assert cm.latest_step() == 1
    placed = cm.restore(1, tree, placer=lambda x, like: torch.from_numpy(
        x).to(like.dtype))
    assert isinstance(placed["w"], torch.Tensor)
    assert placed["h"].dtype == torch.bfloat16
    assert torch.equal(placed["h"], tree["h"])


def test_checkpoint_atomic_no_partial(tmp_path):
    """No .tmp dirs survive a completed save; LATEST matches a real dir."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, {"x": torch.zeros((2,))}, blocking=True)
    assert not list(tmp_path.glob(".tmp*"))
    assert (tmp_path / "step_000000005").exists()
    assert (tmp_path / "LATEST").read_text() == "5"


def test_async_checkpoint_errors_raise_at_wait(tmp_path):
    root = tmp_path / "ckpt"
    cm = CheckpointManager(str(root))
    root.rmdir()
    root.write_text("not a directory")     # the write thread cannot mkdir
    cm.save(3, {"x": torch.zeros((2,))})
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        cm.wait()
    cm.wait()                               # the error is raised once


def test_snapshot_is_a_copy(tmp_path):
    """save copies every leaf before it returns: an in-place update right
    after (as the optimizer makes) does not reach the file."""
    cm = CheckpointManager(str(tmp_path))
    w = torch.zeros((256, 256))
    cm.save(1, {"w": w})
    w.add_(1.0)
    cm.wait()
    assert not cm.restore(1, {"w": w})["w"].any()


def test_restore_refuses_a_shape_mismatch(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": torch.zeros((2, 3))}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        cm.restore(1, {"w": torch.zeros((3, 2))})


def _states():
    """The same reduced smollm-360m train state after one AdamW step in
    each package (parameters bridged from the JAX init)."""
    jcfg = jax_get_config("smollm-360m").reduced(dtype="float32",
                                                 num_layers=1, vocab_size=64)
    jmodel = jax_build_model(jcfg, remat=False)
    jstate = j_init_state(jmodel, jax.random.PRNGKey(0), j_adamw())
    cfg = get_config("smollm-360m").reduced(dtype="float32", num_layers=1,
                                            vocab_size=64)
    model = build_model(cfg, device="cpu", remat=False)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                               device="cpu")
    opt = adamw()
    tstate = TrainState(params, opt.init(params),
                        torch.zeros((), dtype=torch.int32))
    batch = SyntheticLMDataset(cfg.vocab_size, 16, 2).batch_at(0)
    jstate, _ = jax.jit(j_make_train_step(jmodel, j_adamw(),
                                          j_cosine(1e-3, 1, 4)))(
        jstate, {"tokens": jnp.asarray(batch["tokens"])})
    tstate, _ = make_train_step(model, opt, cosine_warmup(1e-3, 1, 4))(
        tstate, {"tokens": torch.from_numpy(batch["tokens"])})
    return jstate, tstate


def test_port_checkpoint_restores_in_jax(tmp_path):
    jstate, tstate = _states()
    CheckpointManager(str(tmp_path)).save(1, tstate, blocking=True)
    got = JaxCheckpointManager(str(tmp_path)).restore(1, jstate)
    assert type(got).__name__ == "TrainState"
    for a, b in zip(jax.tree.leaves(got), tree_lib.leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(got.step) == 1 and int(got.opt.step) == 1


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _states()
    JaxCheckpointManager(str(tmp_path)).save(1, jstate, blocking=True)
    got = CheckpointManager(str(tmp_path)).restore(
        1, tstate, placer=lambda x, like: torch.from_numpy(np.array(x)).to(
            like.dtype))
    assert isinstance(got, TrainState)
    assert type(got.opt).__name__ == "AdamWState"
    for a, b in zip(tree_lib.leaves(got), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bf16_leaves_cross_both_ways(tmp_path):
    vals = np.array([1.0, -2.5, 3.140625, 1e-3], np.float32)
    JaxCheckpointManager(str(tmp_path / "j")).save(
        1, {"w": jnp.asarray(vals, jnp.bfloat16)}, blocking=True)
    like = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    got = CheckpointManager(str(tmp_path / "j")).restore(
        1, like, placer=lambda x, l: torch.from_numpy(x).to(l.dtype))
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert torch.equal(got["w"], want)
    CheckpointManager(str(tmp_path / "t")).save(1, {"w": want},
                                                blocking=True)
    back = JaxCheckpointManager(str(tmp_path / "t")).restore(
        1, {"w": jnp.zeros(4, jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  want.float().numpy())


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path):
    cfg = get_config("smollm-360m").reduced(dtype="float32", num_layers=1,
                                            vocab_size=64)
    model = build_model(cfg, device="cpu", remat=False)
    opt = adamw()
    step = make_train_step(model, opt, cosine_warmup(1e-3, 2, 20))
    ds = SyntheticLMDataset(cfg.vocab_size, 16, 2)

    def trainer(seed, start=0, ckpt=None, every=0):
        return Trainer(step_fn=step, state=init_state(model, seed, opt),
                       pipeline=DataPipeline(ds, start_step=start),
                       ckpt=ckpt, checkpoint_every=every)

    whole = trainer(0)
    whole.run(8)
    whole.pipeline.close()
    cm = CheckpointManager(str(tmp_path))
    first = trainer(0, ckpt=cm, every=4)
    first.run(4)
    first.pipeline.close()
    assert cm.latest_step() == 4
    second = trainer(42, start=cm.latest_step(), ckpt=cm)
    assert second.maybe_restore() == 4
    assert int(second.state.step) == 4
    second.run(4)
    second.pipeline.close()
    assert [h["step"] for h in second.history] == [4, 5, 6, 7]
    np.testing.assert_allclose([h["loss"] for h in second.history],
                               [h["loss"] for h in whole.history[4:]],
                               rtol=0, atol=0)
    for a, b in zip(tree_lib.leaves(second.state), tree_lib.leaves(
            whole.state)):
        assert torch.equal(a, b)


def test_elastic_matches_the_reference():
    times = [1.0, 1.1, 0.9, 5.0, 1.0, 3.5, 1.2, 0.8, 9.0, 1.0]
    wj, wt = j_elastic.StragglerWatchdog(), elastic.StragglerWatchdog()
    for i, dt in enumerate(times):
        assert wt.record(i, dt) == wj.record(i, dt)
    assert wt.slow_steps == wj.slow_steps and wt.baseline == wj.baseline
    hj = j_elastic.HeartbeatMonitor(range(5), timeout_s=2.0)
    ht = elastic.HeartbeatMonitor(range(5), timeout_s=2.0)
    for h, now in [(0, 10.0), (1, 9.5), (2, 7.0), (3, 10.5)]:
        hj.beat(h, now=now)
        ht.beat(h, now=now)
    for now in (10.0, 11.0, 12.0, 13.0):
        assert ht.dead(now) == hj.dead(now)
        assert ht.alive(now) == hj.alive(now)
    for args in [(512, 256, 16, 1), (256, 256, 16, 1), (200, 256, 16, 1),
                 (100, 256, 16, 4), (8, 256, 16, 1), (1024, 256, 8, 2)]:
        total, per_pod, mp, min_data = args
        assert elastic.plan_remesh(total, per_pod, model_parallel=mp,
                                   min_data=min_data) == \
            j_elastic.plan_remesh(total, per_pod, model_parallel=mp,
                                  min_data=min_data)
