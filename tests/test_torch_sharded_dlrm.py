"""Row-sharded DLRM training in the port on gloo ranks against the JAX
package's one-device gradients, on the CPU, and the backward's row window.

* rm1 cut to 64 rows a table, float32, params bridged from the reference's
  ``init(PRNGKey(0))``, one batch of 8 of the port's synthetic dataset: on
  (1, 2) (rows and the layers split over ``model``) and (2, 2) (the batch
  and the FSDP dims over ``data`` too) each rank's loss and its shard of
  every float leaf's gradient, the table's rows among them, against the
  same slices of ``jax.value_and_grad`` over the float leaves (the
  reference's int32 leaf closed over: ROADMAP queue C): atol 1e-5 / rtol
  1e-4, as the one-device DLRM test.
* the backward's row window (``batched_table_backward_window``) equals the
  rows ``[lo, hi)`` of the full backward, and ids outside the window add
  nothing; the window's autograd Function gives that gradient, and so does
  PyTorch's autograd of the plain window lookup.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro_torch import tree as tree_lib
from repro_torch.bench import sharded_train as st
from repro_torch.config import get_config
from repro_torch.core import embedding_api as emb
from repro_torch.data.pipeline import SyntheticRecSysDataset
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.api import build_model

ARCH, ROWS, BATCH = "rm1", 64, 8


@pytest.fixture(scope="module")
def reference():
    cfg_j = dataclasses.replace(jget_config(ARCH), num_embeddings=ROWS)
    model_j = jbuild_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(ARCH), num_embeddings=ROWS)
    batch = SyntheticRecSysDataset(cfg, BATCH).batch_at(0)
    offsets = params_j["table_offsets"]

    def loss(floats, b):
        return model_j.loss(dict(floats, table_offsets=offsets), b)

    floats = {k: v for k, v in params_j.items() if k != "table_offsets"}
    want, grads = jax.value_and_grad(loss)(
        floats, {k: jnp.asarray(v) for k, v in batch.items()})
    grads = dict(jax.tree.map(np.asarray, grads),
                 table_offsets=np.zeros(offsets.shape, np.float32))
    return (cfg, jax.tree.map(np.asarray, params_j), batch, float(want),
            grads)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_row_sharded_grads_match_jax(reference, shape):
    cfg, params, batch, want, grads = reference
    ranks = mesh_lib.run_ranks(st.dlrm_grads_job, shape[0] * shape[1], (
        ARCH, ROWS, params, batch, shape), timeout=120)
    model = build_model(cfg, device="cpu")
    rows = cfg.num_tables * ROWS // shape[1]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want, atol=1e-5)
        exp = st.expected_shard(model, grads, r["coords"], shape)
        assert r["grads"]["embedding"].shape[0] == rows
        for a, b in zip(tree_lib.leaves(r["grads"]), tree_lib.leaves(exp)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
        assert np.count_nonzero(r["grads"]["embedding"]) > 0
        # the CPU takes the plain versions: no kernel launched
        assert set(r["launches"].values()) == {0}


def _window_inputs(seed=0, R=48, D=8, B=5, T=3, L=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, R // T, (B, T, L)).astype(np.int32)
    offsets = (np.arange(T) * (R // T)).astype(np.int32)
    table = rng.standard_normal((R, D)).astype(np.float32)
    grad_out = rng.standard_normal((B, T, D)).astype(np.float32)
    return table, offsets, ids, grad_out


@pytest.mark.parametrize("lo,hi", [(0, 16), (16, 40), (40, 48)])
def test_window_backward_is_the_rows_of_the_full_backward(lo, hi):
    table, offsets, ids, grad_out = _window_inputs()
    gid = torch.from_numpy((ids + offsets[None, :, None]).reshape(-1))
    full = emb.batched_table_backward(torch.from_numpy(grad_out), gid,
                                      table.shape[0])
    win = emb.embedding_bag_backward_window(torch.from_numpy(grad_out), gid,
                                            lo, hi)
    assert win.shape == (hi - lo, table.shape[1])
    np.testing.assert_array_equal(win.numpy(), full[lo:hi].numpy())
    # ids outside the window (a negative one too) add nothing
    bad = torch.full_like(gid, -1)
    bad[::2] = hi
    assert torch.count_nonzero(emb.batched_table_backward_window(
        torch.from_numpy(grad_out), bad, lo, hi)) == 0


def test_window_function_gradient():
    table, offsets, ids, grad_out = _window_inputs(seed=1)
    lo, hi = 16, 40
    t = torch.from_numpy(table[lo:hi].copy()).requires_grad_(True)
    out = emb.embedding_bag_window(t, torch.from_numpy(offsets),
                                   torch.from_numpy(ids), lo, hi)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(grad_out))
    gid = torch.from_numpy((ids + offsets[None, :, None]).reshape(-1))
    np.testing.assert_array_equal(
        t.grad.numpy(), emb.batched_table_backward_window(
            torch.from_numpy(grad_out), gid, lo, hi).numpy())
    ref = torch.from_numpy(table[lo:hi].copy()).requires_grad_(True)
    emb.batched_table_window_lookup(ref, torch.from_numpy(offsets),
                                    torch.from_numpy(ids), lo, hi).backward(
        torch.from_numpy(grad_out))
    np.testing.assert_allclose(t.grad.numpy(), ref.grad.numpy(), atol=1e-6)
    with pytest.raises(TypeError, match="float32"):
        emb.embedding_bag_window(
            t.detach().to(torch.bfloat16).requires_grad_(True),
            torch.from_numpy(offsets), torch.from_numpy(ids), lo, hi)
