"""The backward of the BatchedTable embedding bag, and DLRM's gradients,
against the JAX package on the CPU.

* The plain backward (``batched_table_backward``, what the CPU path runs
  and what the card's kernel is held to) against ``jax.vjp`` of
  ``repro.core.embedding_api.batched_table_lookup`` on the same cotangent:
  uniform ids, repeated ids in a bag, an id that wraps (``[-R, 0)``: its
  row + R gets the gradient) and ids outside ``[-R, R)`` (nothing gets
  it), atol 1e-5 (float32 sums in another order).
* ``embedding_bag`` on a table that requires grad runs the autograd
  Function: its table gradient equals the plain backward and PyTorch's
  own autograd of the plain forward; no gradient reaches the offsets or
  the ids; a bfloat16 table that requires grad is refused.
* DLRM (rm1 and rm2 cut to 64 rows a table, float32, parameters bridged
  from the JAX init): the loss and the gradient of every float leaf
  against ``jax.value_and_grad`` over the float leaves with
  ``table_offsets`` closed over (``examples/train_dlrm.py``'s whole-tree
  gradient raises on the int32 leaf at jax 0.9: ROADMAP queue C), for
  BatchedTable and SingleTable, loss atol 1e-5 and gradients atol 1e-5 /
  rtol 1e-4; then 3 AdamW steps (no weight decay, lr 1e-3) on the same
  batches, loss rtol 1e-5 and parameters atol 1e-4, a tenth of one
  lr-sized step (Adam normalises each element's step, so an element whose
  gradient is near 0 turns a rounding difference into a visible one:
  1.5e-5 seen on rm1).

The kernel against this plain version runs on the card, in
``tests/test_torch_kernel_cuda.py`` (``-k backward``): that file imports
no JAX, so the card's machine can run it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.core.embedding_api import batched_table_lookup as j_lookup
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as j_adamw
from repro.optim.optimizer import apply_updates as j_apply
from repro_torch import tree as tree_lib
from repro_torch.config import get_config
from repro_torch.core import embedding_api as emb
from repro_torch.data.pipeline import SyntheticRecSysDataset
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim.optimizer import apply_updates
from repro_torch.training.train_step import loss_and_grads

ROWS, BATCH = 64, 8
# (rows per table, D, B, T, L)
CASES = [(50, 16, 6, 3, 4), (20, 64, 8, 4, 20), (7, 8, 5, 2, 9)]


def _inputs(R, D, B, T, L, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R * T, D)).astype(np.float32)
    offs = (np.arange(T) * R).astype(np.int32)
    idx = rng.integers(0, R, (B, T, L)).astype(np.int32)
    Rt = R * T
    idx[0, 0, 1] = Rt                 # past the end: no gradient
    idx[1, T - 1, 0] = -(T - 1) * R - 1   # global -1: the last row
    idx[2, 0, L - 1] = -Rt            # global -Rt: row 0
    idx[3, 1, 0] = -Rt - R - 1        # below -Rt: no gradient
    if L > 2:
        idx[:, :, 2] = idx[:, :, 0]   # a repeated id in every bag
    ct = rng.standard_normal((B, T, D)).astype(np.float32)
    return table, offs, idx, ct


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad(case):
    table, offs, idx, ct = _inputs(*case, seed=0)
    _, vjp = jax.vjp(lambda t: j_lookup(t, jnp.asarray(offs),
                                        jnp.asarray(idx)),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    gids = torch.from_numpy((idx + offs[None, :, None]).reshape(-1))
    got = emb.batched_table_backward(torch.from_numpy(ct), gids,
                                     table.shape[0])
    assert got.dtype == torch.float32 and got.shape == table.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_embedding_bag_function_backward(case):
    table, offs, idx, ct = _inputs(*case, seed=1)
    offs_t, idx_t = torch.from_numpy(offs), torch.from_numpy(idx)
    t = torch.from_numpy(table).requires_grad_(True)
    out = emb.embedding_bag(t, offs_t, idx_t)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(ct))
    gids = (idx_t + offs_t[None, :, None]).reshape(-1)
    np.testing.assert_array_equal(
        t.grad.numpy(), emb.batched_table_backward(
            torch.from_numpy(ct), gids, table.shape[0]).numpy())
    ref = torch.from_numpy(table).requires_grad_(True)
    emb.batched_table_lookup(ref, offs_t, idx_t).backward(
        torch.from_numpy(ct))
    np.testing.assert_allclose(t.grad.numpy(), ref.grad.numpy(), atol=1e-5)
    # the forward is the plain version's, NaN bags included
    with torch.no_grad():
        want = emb.batched_table_lookup(torch.from_numpy(table), offs_t,
                                        idx_t)
    np.testing.assert_array_equal(out.detach().numpy(), want.numpy())


def test_no_gradient_reaches_the_offsets_or_ids():
    table, offs, idx, ct = _inputs(*CASES[0], seed=2)
    t = torch.from_numpy(table).requires_grad_(True)
    offs_f = torch.from_numpy(offs)
    out = emb.embedding_bag(t, offs_f, torch.from_numpy(idx))
    grads = torch.autograd.grad(out, [t], torch.from_numpy(ct))
    assert grads[0].shape == t.shape
    fn = out.grad_fn
    assert fn.next_functions[1:] == ((None, 0), (None, 0))


def test_a_bf16_table_that_requires_grad_is_refused():
    table, offs, idx, _ = _inputs(*CASES[0], seed=3)
    t = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(TypeError, match="float32"):
        emb.embedding_bag(t, torch.from_numpy(offs), torch.from_numpy(idx))
    with torch.no_grad():       # no graph: the bf16 forward is served
        out = emb.embedding_bag(t, torch.from_numpy(offs),
                                torch.from_numpy(idx))
    assert out.dtype == torch.bfloat16


def _cfgs(arch):
    return (dataclasses.replace(jax_get_config(arch), num_embeddings=ROWS),
            dataclasses.replace(get_config(arch), num_embeddings=ROWS))


def _dlrm(arch, use_batched):
    cfg_j, cfg_t = _cfgs(arch)
    model_j = jax_build_model(cfg_j, use_batched=use_batched)
    params_j = model_j.init(jax.random.PRNGKey(0))
    model_t = build_model(cfg_t, device="cpu", use_batched=use_batched)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    return cfg_t, model_j, params_j, model_t, params_t


def _float_loss(model_j, offsets):
    """The reference loss over the float leaves, table_offsets closed over
    (the form that jax.grad takes at jax 0.9)."""
    def loss(floats, batch):
        return model_j.loss(dict(floats, table_offsets=offsets), batch)
    return loss


def _floats(params_j):
    return {k: v for k, v in params_j.items() if k != "table_offsets"}


@pytest.mark.parametrize("use_batched", [True, False])
@pytest.mark.parametrize("arch", ["rm1", "rm2"])
def test_dlrm_grads_match_jax(arch, use_batched):
    cfg, model_j, params_j, model_t, params_t = _dlrm(arch, use_batched)
    batch = SyntheticRecSysDataset(cfg, BATCH).batch_at(0)
    want, grads_j = jax.value_and_grad(
        _float_loss(model_j, params_j["table_offsets"]))(
        _floats(params_j), {k: jnp.asarray(v) for k, v in batch.items()})
    got, grads_t = loss_and_grads(
        model_t.loss, params_t,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)
    assert torch.count_nonzero(grads_t["table_offsets"]) == 0
    del grads_t["table_offsets"]
    gj, gt = jax.tree.leaves(grads_j), tree_lib.leaves(grads_t)
    assert len(gj) == len(gt)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-4)
    # the BatchedTable gradient went through the embedding bag's Function
    assert torch.count_nonzero(grads_t["embedding"]) > 0


@pytest.mark.parametrize("arch", ["rm1", "rm2"])
def test_dlrm_train_steps_match_jax(arch):
    cfg, model_j, params_j, model_t, params_t = _dlrm(arch, True)
    loss_j = _float_loss(model_j, params_j["table_offsets"])
    opt_j, opt_t = j_adamw(weight_decay=0.0), adamw(weight_decay=0.0)
    floats = _floats(params_j)
    state_j, state_t = opt_j.init(floats), opt_t.init(params_t)

    @jax.jit
    def step_j(floats, state, batch):
        loss, grads = jax.value_and_grad(loss_j)(floats, batch)
        upd, state, _ = opt_j.update(grads, state, floats, 1e-3)
        return j_apply(floats, upd), state, loss

    ds = SyntheticRecSysDataset(cfg, BATCH)
    for i in range(3):
        batch = ds.batch_at(i)
        floats, state_j, lj = step_j(
            floats, state_j, {k: jnp.asarray(v) for k, v in batch.items()})
        lt, grads = loss_and_grads(
            model_t.loss, params_t,
            {k: torch.from_numpy(v) for k, v in batch.items()})
        upd, state_t, _ = opt_t.update(grads, state_t, params_t, 1e-3)
        params_t = apply_updates(params_t, upd)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_array_equal(params_t["table_offsets"].numpy(),
                                  np.asarray(params_j["table_offsets"]))
    rest = {k: v for k, v in params_t.items() if k != "table_offsets"}
    for a, b in zip(tree_lib.leaves(rest), jax.tree.leaves(floats)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
