"""The port's DLRM-DCNv2 on the CPU against the JAX model: rm1 and rm2 cut
to 64 rows per table, float32, parameters carried over through the numpy
bridge and batches from both packages' ``SyntheticRecSysDataset``s.

Tolerances: logits rtol 1e-4 / atol 1e-5 and the loss atol 1e-5 (float32
matrix products and sums in another order); the datasets byte-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.data.pipeline import SyntheticRecSysDataset as JaxDataset
from repro.models.api import build_model as jax_build_model
from repro_torch.config import get_config
from repro_torch.data.pipeline import SyntheticRecSysDataset
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy

ROWS, BATCH = 64, 8


def _cfgs(arch):
    return (dataclasses.replace(jax_get_config(arch), num_embeddings=ROWS),
            dataclasses.replace(get_config(arch), num_embeddings=ROWS))


@pytest.mark.parametrize("arch", ["rm1", "rm2"])
def test_config_copy_matches_reference(arch):
    cfg_j = jax_get_config(arch)
    cfg_t = get_config(arch)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.num_params() == cfg_j.num_params()


@pytest.mark.parametrize("step,host,num_hosts", [(0, 0, 1), (3, 1, 2)])
@pytest.mark.parametrize("arch", ["rm1", "rm2"])
def test_datasets_are_byte_equal(arch, step, host, num_hosts):
    cfg_j, cfg_t = _cfgs(arch)
    a = JaxDataset(cfg_j, BATCH, seed=5).batch_at(step, host, num_hosts)
    b = SyntheticRecSysDataset(cfg_t, BATCH, seed=5).batch_at(
        step, host, num_hosts)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


@pytest.fixture(scope="module")
def jax_params():
    """JAX parameters of each arch, made once for the module."""
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = jax_build_model(_cfgs(arch)[0]).init(
                jax.random.PRNGKey(0))
        return made[arch]
    return get


@pytest.mark.parametrize("use_batched", [True, False])
@pytest.mark.parametrize("arch", ["rm1", "rm2"])
def test_forward_and_loss_match_jax(jax_params, arch, use_batched):
    cfg_j, cfg_t = _cfgs(arch)
    model_j = jax_build_model(cfg_j, use_batched=use_batched)
    params_j = jax_params(arch)
    model_t = build_model(cfg_t, device="cpu", use_batched=use_batched)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    assert params_t["table_offsets"].dtype == torch.int32
    assert len(params_t["cross"]) == cfg_t.cross_layers
    batch = SyntheticRecSysDataset(cfg_t, BATCH, seed=0).batch_at(0)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}

    logits_j = np.asarray(model_j.forward(params_j, batch_j))
    logits_t = model_t.forward(params_t, batch_t)
    assert logits_t.shape == (BATCH,) and logits_t.dtype == torch.float32
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=1e-4,
                               atol=1e-5)
    loss_j = float(model_j.loss(params_j, batch_j))
    loss_t = float(model_t.loss(params_t, batch_t))
    assert abs(loss_t - loss_j) <= 1e-5


def test_init_shapes_match_jax(jax_params):
    cfg_t = _cfgs("rm2")[1]
    shapes_j = jax.tree.map(lambda x: f"{tuple(x.shape)} {x.dtype}",
                            jax_params("rm2"))
    params_t = build_model(cfg_t, device="cpu").init(0)
    shapes_t = jax.tree.map(
        lambda x: f"{tuple(x.shape)} {str(x.dtype)[6:]}", params_t)
    assert jax.tree.structure(shapes_t) == jax.tree.structure(shapes_j)
    assert jax.tree.leaves(shapes_t) == jax.tree.leaves(shapes_j)
    np.testing.assert_array_equal(params_t["table_offsets"].numpy(),
                                  np.arange(cfg_t.num_tables) * ROWS)
    emb = params_t["embedding"]
    assert abs(float(emb.std()) - cfg_t.embedding_dim ** -0.5) < 0.01


def test_bridge_carries_nested_lists_and_keeps_dtypes():
    tree = {
        "a": [np.arange(6, dtype=np.int32).reshape(2, 3),
              {"w": np.ones((2, 2), np.float32),
               "b": (np.asarray(jnp.asarray([1.5, -2.0], jnp.bfloat16)),
                     [np.zeros(3, np.float32)])}],
        "n": np.asarray(7, np.int32),
    }
    out = params_from_numpy(tree, device="cpu")
    assert isinstance(out["a"], list) and isinstance(out["a"][1]["b"], tuple)
    assert out["a"][0].dtype == torch.int32
    assert torch.equal(out["a"][0], torch.arange(6, dtype=torch.int32
                                                 ).reshape(2, 3))
    assert out["a"][1]["w"].dtype == torch.float32
    bf = out["a"][1]["b"][0]
    assert bf.dtype == torch.bfloat16 and bf.tolist() == [1.5, -2.0]
    assert out["a"][1]["b"][1][0].shape == (3,)
    assert out["n"].dtype == torch.int32 and int(out["n"]) == 7
