"""The port's training path against the JAX package's, float32 on the CPU.

* ``softmax_cross_entropy`` and ``next_token_loss`` (with and without a
  loss mask) on the same logits: atol 1e-6.
* ``TransformerLM.loss`` and every gradient leaf against
  ``jax.value_and_grad(model.loss)`` for reduced smollm-360m and reduced
  granite-moe-1b-a400m (the MoE aux term included), parameters bridged
  from the JAX init: loss rtol 1e-5, gradients atol 2e-5 / rtol 1e-4
  (float32 sums in another order).
* remat ``none`` / ``full`` / ``dots`` give the same loss and gradients
  (recomputation repeats the same float32 ops: atol 1e-6).
* 5 steps of ``make_train_step`` (AdamW + ``cosine_warmup``) against the
  reference's jitted ``make_train_step``: per step loss and grad_norm at
  rtol 1e-4, lr at rtol 1e-6, and the parameters after the last step at
  atol 2e-5 (Adam normalises each element's step, so a gradient element
  near 0 magnifies a rounding difference; 5 steps of lr <= 1e-3 move a
  parameter by at most ~5e-3)."""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as j_adamw
from repro.optim import cosine_warmup as j_cosine
from repro.training import losses as jlosses
from repro.training.train_step import init_state as j_init_state
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch import tree as tree_lib
from repro_torch.config import get_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.training import losses
from repro_torch.training.train_step import (
    TrainState, loss_and_grads, make_train_step)

ARCHS = ["smollm-360m", "granite-moe-1b-a400m"]
B, S = 2, 24


def _models(arch, remat="none"):
    jcfg = jax_get_config(arch).reduced(dtype="float32")
    jmodel = jax_build_model(jcfg, remat=False)
    params_j = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced(dtype="float32")
    model = build_model(cfg, device="cpu", remat=remat)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    return jmodel, params_j, model, params_t, cfg


def _batch(cfg, step=0):
    return SyntheticLMDataset(cfg.vocab_size, S, B).batch_at(step)


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 9, 17)).astype(np.float32) * 4
    tokens = rng.integers(0, 17, (3, 9)).astype(np.int32)
    np.testing.assert_allclose(
        losses.softmax_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(tokens)).numpy(),
        np.asarray(jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                                 jnp.asarray(tokens))),
        atol=1e-6)
    mask = (rng.random((3, 9)) < 0.6).astype(np.int32) if masked else None
    got = losses.next_token_loss(
        torch.from_numpy(logits), torch.from_numpy(tokens),
        None if mask is None else torch.from_numpy(mask))
    want = jlosses.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens),
                                   None if mask is None
                                   else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_cross_entropy_target_outside_vocab_reads_zero():
    logits = np.random.default_rng(1).standard_normal((2, 5)).astype(
        np.float32)
    tokens = np.array([7, -1], np.int32)
    np.testing.assert_allclose(
        losses.softmax_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(tokens)).numpy(),
        np.asarray(jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                                 jnp.asarray(tokens))),
        atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_loss_and_grads_match_jax(arch, masked):
    jmodel, params_j, model, params_t, cfg = _models(arch)
    batch = _batch(cfg)
    if masked:
        batch["loss_mask"] = (np.random.default_rng(2).random((B, S))
                              < 0.7).astype(np.int32)
    want, grads_j = jax.value_and_grad(jmodel.loss)(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    got, grads_t = loss_and_grads(
        model.loss, params_t, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    gj, gt = jax.tree.leaves(grads_j), tree_lib.leaves(grads_t)
    assert len(gj) == len(gt)
    for a, b in zip(gt, gj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-4)


def test_moe_loss_includes_the_aux_term():
    _, _, model, params_t, cfg = _models("granite-moe-1b-a400m")
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    with torch.no_grad():
        logits, aux = model.forward(params_t, tokens)
        from repro_torch.training.losses import next_token_loss
        ce = next_token_loss(logits, tokens)
        total = model.loss(params_t, {"tokens": tokens})
    assert float(aux) > 0
    np.testing.assert_allclose(float(total), float(ce + 0.01 * aux),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["full", "dots", True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_loss_and_grads(arch, mode):
    _, _, base, params_t, cfg = _models(arch, remat="none")
    model = build_model(cfg, device="cpu", remat=mode)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    want, gw = loss_and_grads(base.loss, params_t, batch)
    got, gg = loss_and_grads(model.loss, params_t, batch)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    for a, b in zip(tree_lib.leaves(gg), tree_lib.leaves(gw)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_remat_refuses_an_unknown_mode():
    cfg = get_config("smollm-360m").reduced(dtype="float32")
    with pytest.raises(ValueError, match="remat"):
        build_model(cfg, device="cpu", remat="selective")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    jmodel, params_j, model, params_t, cfg = _models(arch, remat="full")
    lr_j, lr_t = j_cosine(1e-3, 2, 5), cosine_warmup(1e-3, 2, 5)
    jstep = jax.jit(j_make_train_step(jmodel, j_adamw(), lr_j))
    jstate = j_init_state(jmodel, jax.random.PRNGKey(0), j_adamw())
    opt = adamw()
    tstate = TrainState(params_t, opt.init(params_t),
                        torch.zeros((), dtype=torch.int32))
    tstep = make_train_step(model, opt, lr_t)
    ds = SyntheticLMDataset(cfg.vocab_size, S, B)
    for i in range(5):
        batch = ds.batch_at(i)
        jstate, mj = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, mt = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 5
    for a, b in zip(tree_lib.leaves(tstate.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


def test_train_steps_leave_no_garbage_cycles_holding_tensors():
    """A step's temporaries (gradients, clipped gradients, updates) are
    freed by reference counting: a reference cycle would hold them until
    the collector ran, one table's worth a step (on the card, phase 38's
    5 GB tables ran out of memory that way)."""
    _, _, model, params_t, cfg = _models("smollm-360m")
    opt = adamw()
    state = TrainState(params_t, opt.init(params_t),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, opt, cosine_warmup(1e-3, 2, 5))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}

    def live():
        return sum(o.numel() * o.element_size() for o in gc.get_objects()
                   if issubclass(type(o), torch.Tensor))

    state, _ = step(state, batch)
    gc.collect()
    gc.disable()
    try:
        before = live()
        for _ in range(3):
            state, _ = step(state, batch)
        after = live()
    finally:
        gc.enable()
    assert after == before
