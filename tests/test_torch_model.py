"""One fused ``decode_tokens_paged`` step of the port against the JAX model
with bridged parameters: reduced smollm-360m, float32, the same lists and
pool; logits and the updated pool agree to atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro_torch.config import get_config
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy


def _lists(NB):
    # slot 1 decodes position 6; slot 0 prefills positions 2..6; 2 padding
    # lanes.  Block size 4: slot 1 holds blocks [3, 5], slot 0 [1, 6].
    bl = [3, 5, 1, 6] + [0] * (NB - 4)
    br = [1, 1, 0, 0] + [2] * (NB - 4)
    bp = [0, 1, 0, 1] + [0] * (NB - 4)
    slots = [(5, 2), (1, 2), (1, 3), (6, 0), (6, 1), (6, 2), (NB, 0), (NB, 0)]
    return {
        "block_list": bl, "block_req": br, "block_pos": bp,
        "kv_lens": [7, 7],
        "token_req": [1, 0, 0, 0, 0, 0, 2, 2],
        "token_pos": [6, 2, 3, 4, 5, 6, 0, 0],
        "cu_q_lens": [0, 1, 6], "cu_kv_lens": [0, 7, 14],
        "seq_slot": [1, 0], "slots": slots, "last_lane": [5, 0],
    }


def test_decode_tokens_paged_matches_jax():
    cfg_j = jax_get_config("smollm-360m").reduced(dtype="float32")
    cfg_t = get_config("smollm-360m").reduced(dtype="float32")
    model_j = jax_build_model(cfg_j, remat=False)
    params_j = model_j.init(jax.random.PRNGKey(0))
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    a = cfg_t.attention
    NB, BS = 8, 4
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((cfg_t.num_layers, NB, BS, 2 * a.num_kv_heads,
                                a.head_dim)).astype(np.float32)
    tokens = rng.integers(0, cfg_t.vocab_size, (8,)).astype(np.int32)
    lists = {k: np.asarray(v, np.int32) for k, v in _lists(NB).items()}

    logits_j, pools_j = model_j.decode_tokens_paged(
        params_j, {"kv": jnp.asarray(pool)},
        {k: jnp.asarray(v) for k, v in lists.items()}, jnp.asarray(tokens))
    logits_t, pools_t = model_t.decode_tokens_paged(
        params_t, {"kv": torch.from_numpy(pool.copy())},
        {k: torch.from_numpy(v) for k, v in lists.items()},
        torch.from_numpy(tokens))
    assert logits_t.shape == (2, cfg_t.vocab_size)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(pools_t["kv"].numpy(),
                               np.asarray(pools_j["kv"]), atol=1e-4, rtol=0)
    # the padding lanes' (NB, 0) slots wrote nothing
    assert not np.array_equal(pools_t["kv"].numpy(), pool)
    changed = np.any(pools_t["kv"].numpy() != pool, axis=(0, 3, 4))
    assert set(zip(*np.nonzero(changed))) == {
        (5, 2), (1, 2), (1, 3), (6, 0), (6, 1), (6, 2)}
